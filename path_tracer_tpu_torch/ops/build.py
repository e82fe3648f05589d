"""Build and load the port's hand-written CUDA kernels.

Every source under path_tracer_tpu_torch/csrc/ builds at first use in
one `torch.utils.cpp_extension.load` call into <repo>/build/kernels/
(listed in .gitignore): the CUDA C++ kernels (*.cu, each with a plain C
launch function; traverse.cuh holds what they share) compile with nvcc
for sm_90a, and bindings.cpp, the one file that includes
torch/extension.h, binds them. ninja compiles
the sources in parallel and rebuilds only what changed.

Flags: no `--use_fast_math` (its approximate division and flush-to-zero
change the triangle test, including the NaN that makes padded leaf
slots miss), and `-fmad=false`, so that every `a * b + c` rounds twice
exactly as the plain PyTorch version's separate multiply and add do;
the kernel and its plain version then agree to the bit on the same
traversal order. An explicit `-gencode` also keeps cpp_extension from
adding its own architecture flags.
"""

from __future__ import annotations

import os
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), 'build',
                         'kernels')
NVCC_FLAGS = ['-gencode=arch=compute_90a,code=sm_90a', '-O3', '-fmad=false']

NAME = 'path_tracer_tpu_torch_kernels'

_LOCK = threading.Lock()
_EXT = None


def load():
    """The extension module holding every kernel's binding: the sources
    of `CSRC` built as `NAME` into `BUILD_DIR` on first use."""
    global _EXT
    with _LOCK:
        if _EXT is None:
            from torch.utils import cpp_extension
            os.makedirs(BUILD_DIR, exist_ok=True)
            sources = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                             if f.endswith(('.cu', '.cpp')))
            _EXT = cpp_extension.load(
                NAME, sources, extra_cflags=['-O3'],
                extra_cuda_cflags=NVCC_FLAGS, build_directory=BUILD_DIR)
    return _EXT
