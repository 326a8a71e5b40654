"""Build the CUDA kernels with one `nvcc` call and load them with `ctypes`.

Every source in `pcd_reg_hregnet_torch/csrc/*.cu` has a plain ``extern "C"``
interface and includes no PyTorch header, so one `nvcc` invocation builds
them all into one shared library in seconds.  The build runs at the first
kernel launch of a process, never at import.  Each process writes its own
library file (named after its pid), loads it and deletes it: there is no
lock to wait on and no stale build to reuse.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_DIR = PACKAGE_DIR / '_build'
ARCH_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a')
NVCC_TIMEOUT_S = 600


def find_nvcc() -> str:
    """`nvcc` from ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, or ``PATH``."""
    candidates = []
    if os.environ.get('CUDA_HOME'):
        candidates.append(Path(os.environ['CUDA_HOME']) / 'bin' / 'nvcc')
    candidates.append(Path('/usr/local/cuda/bin/nvcc'))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    found = shutil.which('nvcc')
    if found:
        return found
    raise RuntimeError('nvcc not found (looked in $CUDA_HOME/bin, '
                       '/usr/local/cuda/bin and PATH); the CUDA kernels '
                       'cannot be built')


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob('*.cu'))


@functools.cache
def library() -> 'KernelLibrary':
    """Build (once per process) and load the kernel library."""
    return KernelLibrary.build()


class KernelLibrary:
    """The loaded `libpcdreg_kernels` with typed entry points.

    `build_s` is the wall time of the `nvcc` call and `build_log` its
    output, which holds the ``-Xptxas -v`` register/shared-memory/spill
    report of every kernel.
    """

    def __init__(self, lib: ctypes.CDLL, build_s: float, build_log: str):
        self.lib = lib
        self.build_s = build_s
        self.build_log = build_log
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pcdreg_fps.argtypes = [vp, vp, vp, ci, ci, ci, vp]
        lib.pcdreg_fps.restype = ci
        lib.pcdreg_patch_attention.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci,
                                               ctypes.c_float, ci, vp]
        lib.pcdreg_patch_attention.restype = ci
        lib.pcdreg_argmax_steps.argtypes = [vp, ci, ci, vp]
        lib.pcdreg_argmax_steps.restype = ci
        lib.pcdreg_error_string.argtypes = [ci]
        lib.pcdreg_error_string.restype = ctypes.c_char_p

    @classmethod
    def build(cls) -> 'KernelLibrary':
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = BUILD_DIR / f'libpcdreg_kernels.{os.getpid()}.so'
        cmd = [find_nvcc(), *ARCH_FLAGS, '-std=c++17', '-O3', '-shared',
               '-Xcompiler', '-fPIC', '-Xptxas', '-v', '-o', str(out),
               *map(str, sources())]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=NVCC_TIMEOUT_S)
        build_s = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed ({proc.returncode}):\n{log}')
        try:
            lib = ctypes.CDLL(str(out))
        finally:
            out.unlink(missing_ok=True)  # the mapping outlives the file
        return cls(lib, build_s, log)

    def check(self, err: int, what: str) -> None:
        """Raise if a C entry point returned a CUDA error."""
        if err != 0:
            msg = self.lib.pcdreg_error_string(err).decode()
            raise RuntimeError(f'{what}: CUDA error {err} ({msg})')
