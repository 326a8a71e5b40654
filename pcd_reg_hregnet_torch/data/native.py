"""ctypes binding of the native host point-cloud library (port of
`pcd_reg_hregnet_tpu/data/native.py`: `available`, `filter_resample`,
`load_bin`, `transform_inplace`).

The port loads the committed `cc/libpcd_native.so`, as the JAX package
does.  Where that library does not load, it compiles `cc/pointcloud.cc`
with the Makefile's flags (no fast-math) into `pcd_reg_hregnet_torch/_build/`
and loads that; if the compile fails too, it raises: the pipeline has no
numpy fallback, so both packages take the same resampling branch.  The
library's SplitMix64 generator is platform-independent, so either build
gives the same points.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

REPO_DIR = Path(__file__).resolve().parents[2]
CC_DIR = REPO_DIR / 'cc'
BUILD_DIR = Path(__file__).resolve().parents[1] / '_build'
CXXFLAGS = ('-O3', '-std=c++17', '-fPIC', '-shared')


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.pc_filter_resample.restype = ctypes.c_int64
    lib.pc_filter_resample.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_float,
        ctypes.c_int64, ctypes.c_uint64, f32p, f32p]
    lib.pc_load_bin.restype = ctypes.c_int64
    lib.pc_load_bin.argtypes = [
        ctypes.c_char_p, ctypes.c_float, ctypes.c_int64, ctypes.c_uint64, f32p, f32p]
    lib.pc_transform.restype = None
    lib.pc_transform.argtypes = [f32p, ctypes.c_int64, f32p]
    return lib


def _compile() -> ctypes.CDLL:
    """Build `cc/pointcloud.cc` into a per-process file, load it, delete it."""
    cxx = os.environ.get('CXX') or shutil.which('g++') or shutil.which('c++')
    if not cxx:
        raise RuntimeError('cc/libpcd_native.so does not load and no C++ compiler '
                           'was found to build cc/pointcloud.cc')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f'libpcd_native.{os.getpid()}.so'
    try:
        proc = subprocess.run([cxx, *CXXFLAGS, '-o', str(out), str(CC_DIR / 'pointcloud.cc')],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f'building cc/pointcloud.cc failed:\n{proc.stdout}{proc.stderr}')
        return ctypes.CDLL(str(out))
    finally:   # the mapping outlives the file
        out.unlink(missing_ok=True)


@functools.cache
def library() -> ctypes.CDLL:
    """The committed library, else one compiled from its source."""
    try:
        return _bind(ctypes.CDLL(str(CC_DIR / 'libpcd_native.so')))
    except OSError:
        return _bind(_compile())


def available() -> bool:
    """Whether the library loads (committed, or compiled from its source)."""
    try:
        library()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def filter_resample(points: np.ndarray, max_range: float, n_out: int,
                    seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Fused range filter + resample.  points: [N, >=3] float32 (xyz first,
    intensity in column 3 if present).  Returns (xyz [n_out, 3], inten [n_out])."""
    lib = library()
    points = np.ascontiguousarray(points, np.float32)
    out_xyz = np.empty((n_out, 3), np.float32)
    out_int = np.empty((n_out,), np.float32)
    lib.pc_filter_resample(_f32p(points), points.shape[0], points.shape[1],
                           max_range, n_out, seed, _f32p(out_xyz), _f32p(out_int))
    return out_xyz, out_int


def load_bin(path: str, max_range: float, n_out: int,
             seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """One-pass .pcd.bin decode + filter + resample (float32 records of 4
    or 5 values, xyz first).  Returns (xyz [n_out, 3], inten [n_out]);
    raises OSError for a file it cannot read, ValueError for another
    record width."""
    lib = library()
    out_xyz = np.empty((n_out, 3), np.float32)
    out_int = np.empty((n_out,), np.float32)
    ret = lib.pc_load_bin(os.fsencode(path), max_range, n_out, seed,
                          _f32p(out_xyz), _f32p(out_int))
    if ret == -1:
        raise OSError(f'cannot read {path}')
    if ret == -2:
        raise ValueError(f'unrecognised point record width in {path}')
    return out_xyz, out_int


def transform_inplace(points: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Apply a rigid [4, 4] transform in place to [N, 3] float32 points
    (C-contiguous); returns `points`."""
    if points.dtype != np.float32 or not points.flags['C_CONTIGUOUS'] or \
            points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f'points must be C-contiguous float32 [N, 3], not {points.dtype} '
                         f'{points.shape}')
    T = np.ascontiguousarray(T, np.float32)
    if T.shape != (4, 4):
        raise ValueError(f'T must be [4, 4], not {T.shape}')
    library().pc_transform(_f32p(points), points.shape[0], _f32p(T))
    return points
