"""The benchmark's plain reference. It imports neither JAX nor anything
of the program.

- `plain/`: a frozen copy of the program's plain PyTorch path (the scene
  model and compile, camera, analytic intersection and hit attributes,
  scatter and the material models, path state, resolve), with the BVH
  builds, the trace tables and the traversals taken out of the compile
  and of `ops/intersect.py`.
- `trace.py`: the mesh trace, every ray against every face.
- `follow.py`: reset, one round and resolve at a sample of lanes, from
  the state the program hands over, in float32 or, for the control, in
  bfloat16.
"""
