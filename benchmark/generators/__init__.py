"""Traffic generators: each reads the parameters of a mix
(traffic/<mix>.json) and drives the program through its window."""
