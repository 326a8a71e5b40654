"""Build the CUDA kernels with one `nvcc` call and load them with `ctypes`.

Every source in `pcd_reg_hregnet_torch/csrc/*.cu` has a plain ``extern "C"``
interface and includes no PyTorch header.  One `nvcc` per source compiles
them all at once, in parallel, and one more links the objects into one
shared library.  The build runs at the first kernel launch of a process,
never at import.  Each process writes its own files (named after its
pid), loads the library and deletes them: there is no lock to wait on and
no stale build to reuse.
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

    `build_s` is the wall time of the build and `build_log` the `nvcc`
    output, which holds the ``-Xptxas -v`` register/shared-memory/spill
    report of every kernel.
    """

    def __init__(self, lib: ctypes.CDLL, build_s: float, build_log: str):
        self.lib = lib
        self.build_s = build_s
        self.build_log = build_log
        vp, ci = ctypes.c_void_p, ctypes.c_int
        pi = ctypes.POINTER(ctypes.c_int)
        lib.pcdreg_fps.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
        lib.pcdreg_fps.restype = ci
        lib.pcdreg_fps_probe.argtypes = [vp, vp, ci, ci, ci, ci, vp]
        lib.pcdreg_fps_probe.restype = ci
        lib.pcdreg_fps_config.argtypes = [ci, pi, pi, pi]
        lib.pcdreg_fps_config.restype = ci
        lib.pcdreg_patch_attention.argtypes = [
            vp, vp, vp, vp, vp, ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, vp]
        lib.pcdreg_patch_attention.restype = ci
        lib.pcdreg_patch_attention_bwd.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_float, vp]
        lib.pcdreg_patch_attention_bwd.restype = ci
        lib.pcdreg_attention_plan.argtypes = [ci, ci, ci, ci, pi, pi, pi]
        lib.pcdreg_attention_plan.restype = ci
        lib.pcdreg_attention_bwd_plan.argtypes = [ci, ci, ci, ci, ci, pi, pi, pi, pi]
        lib.pcdreg_attention_bwd_plan.restype = ci
        lib.pcdreg_attention_bwd_tiling.argtypes = [ci, pi, pi]
        lib.pcdreg_attention_bwd_tiling.restype = ci
        lib.pcdreg_patch_attention_bwd_bf16.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_float, vp]
        lib.pcdreg_patch_attention_bwd_bf16.restype = ci
        lib.pcdreg_attention_bwd_bf16_plan.argtypes = [ci, ci, pi, pi, pi, pi]
        lib.pcdreg_attention_bwd_bf16_plan.restype = ci
        lib.pcdreg_error_string.argtypes = [ci]
        lib.pcdreg_error_string.restype = ctypes.c_char_p

    @classmethod
    def build(cls) -> 'KernelLibrary':
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc, pid = find_nvcc(), os.getpid()
        out = BUILD_DIR / f'libpcdreg_kernels.{pid}.so'
        objs = [BUILD_DIR / f'{src.stem}.{pid}.o' for src in sources()]
        t0 = time.perf_counter()
        try:
            procs = [subprocess.Popen(
                [nvcc, *ARCH_FLAGS, '-std=c++17', '-O3', '-c', '-Xcompiler',
                 '-fPIC', '-Xptxas', '-v', '-o', str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(sources(), objs)]
            logs, failed = [], False
            for proc in procs:
                try:
                    logs.append(proc.communicate(timeout=NVCC_TIMEOUT_S)[0])
                except subprocess.TimeoutExpired:
                    for p in procs:
                        p.kill()
                        p.wait()
                    raise
                failed |= proc.returncode != 0
            log = ''.join(logs)
            if failed:
                raise RuntimeError(f'nvcc failed:\n{log}')
            link = subprocess.run([nvcc, *ARCH_FLAGS, '-shared', '-o', str(out),
                                   *map(str, objs)], capture_output=True,
                                  text=True, timeout=NVCC_TIMEOUT_S)
            if link.returncode != 0:
                raise RuntimeError(f'nvcc link failed ({link.returncode}):\n'
                                   f'{link.stdout}{link.stderr}')
            build_s = time.perf_counter() - t0
            lib = ctypes.CDLL(str(out))
        finally:   # the mapping outlives the files
            for f in (out, *objs):
                f.unlink(missing_ok=True)
        return cls(lib, build_s, log)

    def check(self, err: int, what: str) -> None:
        """Raise if a C entry point returned a CUDA error."""
        if err != 0:
            msg = self.lib.pcdreg_error_string(err).decode()
            raise RuntimeError(f'{what}: CUDA error {err} ({msg})')
