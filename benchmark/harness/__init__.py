"""The benchmark's harness: discovery of cells from files, the yardstick
(statistics, peaks and compulsory bytes), the profiler's reading, and
the comparison that decides `correct`."""
