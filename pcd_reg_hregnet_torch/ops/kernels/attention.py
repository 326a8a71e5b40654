"""Patch attention: CUDA kernels K3 (forward) and K3b (backward), their
plain versions, and the autograd Function that joins them.

K3 replaces `pcd_reg_hregnet_tpu/ops/pallas/attention.py::_attn_kernel`;
the kernel is `csrc/attention.cu`, a tiled flash kernel on the tensor cores
(3xTF32 in f32, bf16 mma in bf16).  K3b replaces that file's `_bwd` (the
`custom_vjp` backward); the kernel is `csrc/attention_bwd.cu` (f32 only).
Layout is the JAX function's: q, k, v [R, H, K, d] -> out [R, H, K, d] in
q's dtype, softmax in f32.  Both kernels take any K and d and any strides
with a contiguous last dim; `plan` is K3's tiling.  The model goes through
`PatchAttentionFunction`, so autograd sees every write of the kernels.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from . import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
WIDE = 128                   # the widest head slice one block holds
BLOCK_ROWS = (16, 32, 64, 128)   # query rows per block, 16 per warp
SPLIT = 4                    # warps that may share 16 rows (f32, d <= 128)
MAX_WARPS = 8                # per block: bm / 16 * split
MAX_SMEM = 232448            # bytes of shared memory a block may opt in to
SMS = 132                    # H100 SXM: `plan`'s default (a launch passes its card's)
MIN_UNSPLIT = 64             # fewer blocks than this take the key split (the sweep)
_NO_CONTEXT = contextlib.nullcontext()


def patch_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch attention with the JAX `_dense_reference` numerics."""
    s = torch.einsum('rhkd,rhmd->rhkm', q.float() * scale, k.float())
    p = torch.softmax(s, dim=-1)
    return torch.einsum('rhkm,rhmd->rhkd', p, v.float()).to(q.dtype)


@dataclass(frozen=True)
class Plan:
    """The kernel's tiling of one call (`csrc/attention.cu` computes the
    same `dp`, `bn`, `slices` and `smem`)."""
    dp: int       # padded head width a block holds (8..128; bf16 from 16)
    bn: int       # keys per K/V tile in shared memory
    bm: int       # query rows per block
    split: int    # warps per 16 rows, each taking 1/split of every key tile
    slices: int   # blocks along d: ceil(d / 128) when d > 128, else 1
    smem: int     # dynamic shared memory bytes of a block
    grid: tuple   # (R * H * ceil(K / bm), slices)
    threads: int  # 2 * bm * split


def padded_width(d: int, dtype: torch.dtype) -> int:
    """The width in {8, 16, 32, 64, 128} (bf16 from 16) that a block pads
    a head slice to."""
    w = 8 if dtype == torch.float32 else 16
    while w < WIDE and d > w:
        w *= 2
    return w


def splits(d: int, dtype: torch.dtype) -> tuple:
    """The key splits the kernel is built with for head dim d."""
    return (1, SPLIT) if dtype == torch.float32 and d <= WIDE else (1,)


def plan(R: int, H: int, K: int, d: int, dtype: torch.dtype,
         bm: Optional[int] = None, split: Optional[int] = None, sms: int = SMS) -> Plan:
    """The tiling of `patch_attention` over [R, H, K, d] in `dtype` on a
    card with `sms` multiprocessors.

    Without `bm` and `split` (the choice follows the sweep of
    `chip_smoke.py` on an H100, PERF.md): blocks of 128 rows where K >= 128
    and that gives a block to at least 3 of every 4 SMs; else blocks of up
    to 64 rows (the fewest 16-row warps that cover K) where that gives at
    least `MIN_UNSPLIT` blocks, or where the kernel has no key split; else,
    with fewer blocks (a batch of one pair), 16 rows (32 at d <= 16)
    whose every 16 are shared by `SPLIT` warps, each taking a quarter of
    every key tile.
    """
    slices = -(-d // WIDE) if d > WIDE else 1
    dp = WIDE if d > WIDE else padded_width(d, dtype)
    bn = 64
    esize = 4 if dtype == torch.float32 else 2

    def smem_of(bm, split):
        stages = 4 if dp <= 32 else 3 if dp == 64 else 2   # tiles in flight
        tiles = (1 if d > WIDE else 2) * stages * bn * (dp + 16 // esize) * esize
        if dtype == torch.float32 and dp == WIDE and d <= WIDE:
            tiles += bm * 1024   # Q's hi and lo at d = 128
        # the output's rows (with a split, the partial results) reuse the tiles' space
        parts = split * bm * (dp + 3) * 4 if split > 1 else bm * (-(-dp // 32) * 32 + 8) * 4
        return max(tiles, parts)

    if bm is None and split is None:
        def blocks(b):
            return R * H * -(-K // b) * slices
        fit = 16
        while fit < 64 and fit < K:
            fit *= 2
        shapes = [(128, 1)] if K >= 128 and 4 * blocks(128) >= 3 * sms else []
        if blocks(fit) >= MIN_UNSPLIT or SPLIT not in splits(d, dtype):
            shapes.append((fit, 1))
        else:
            shapes.append((32 if dp <= 16 else 16, SPLIT))
        bm, split = next((s for s in shapes if smem_of(*s) <= MAX_SMEM), (16, 1))
    bm = 64 if bm is None else bm
    split = 1 if split is None else split
    if bm not in BLOCK_ROWS or split not in splits(d, dtype) or bm // 16 * split > MAX_WARPS:
        raise ValueError(f'patch_attention: no kernel for bm={bm}, split={split} at '
                         f'd={d} {dtype} (bm in {BLOCK_ROWS}, split in '
                         f'{splits(d, dtype)}, at most {MAX_WARPS} warps)')
    smem = smem_of(bm, split)
    if smem > MAX_SMEM:
        raise ValueError(f'patch_attention: bm={bm}, split={split} at d={d} {dtype} '
                         f'needs {smem} bytes of shared memory (max {MAX_SMEM})')
    return Plan(dp, bn, bm, split, slices, smem,
                (R * H * -(-K // bm), slices), 2 * bm * split)


def _check(q, k, v, out) -> None:
    """Per call: k, v and out match q in shape, dtype and device (raises
    ValueError)."""
    for name, t in (('k', k), ('v', v), ('out', out)):
        if t is not None and (t.shape != q.shape or t.dtype != q.dtype
                              or t.get_device() != q.get_device()):
            raise ValueError(f'patch_attention: {name} {t.dtype} {tuple(t.shape)} '
                             f'on {t.device} does not match q {q.dtype} '
                             f'{tuple(q.shape)} on {q.device}')


@functools.cache
def _sm_count(dev: int) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=1024)
def _launch_args(shape: tuple, dtype: torch.dtype, strides: tuple, bm: Optional[int],
                 split: Optional[int], dev: int):
    """Validate what the kernel takes of one layout (raises ValueError) and
    return its `plan` on device `dev` and the kernel's parameter array;
    cached, so a layout seen before costs one lookup."""
    if len(shape) != 4:
        raise ValueError(f'patch_attention takes [R, H, K, d], got {shape}')
    if dtype not in _DTYPE_CODES:
        raise ValueError(f'patch_attention kernel takes f32 or bf16, got {dtype}')
    R, H, K, d = shape
    for name, st in zip(('q', 'k', 'v', 'out'), strides):
        if d > 1 and st[3] != 1:
            raise ValueError(f'patch_attention kernel takes a contiguous last dim, '
                             f'got {name} strides {st}')
    if R * H * -(-K // BLOCK_ROWS[0]) >= 2 ** 31:
        raise ValueError(f'patch_attention kernel: R*H*ceil(K/16) must be < 2**31, '
                         f'got shape {shape}')
    p = plan(R, H, K, d, dtype, bm, split, _sm_count(dev))
    params = (ctypes.c_longlong * 19)(*(x for st in strides for x in st[:3]), *shape,
                                      p.bm, p.split, _DTYPE_CODES[dtype])
    return p, params


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
            out: Optional[torch.Tensor] = None, bm: Optional[int] = None,
            split: Optional[int] = None) -> torch.Tensor:
    """Launch K3 into `out` (a new contiguous tensor by default) with `bm`
    query rows per block and `split` warps per 16 rows (`plan`'s by
    default); counts nothing."""
    _check(q, k, v, out)
    dev = q.get_device()
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _, params = _launch_args(tuple(q.shape), q.dtype,
                             (q.stride(), k.stride(), v.stride(), out.stride()), bm, split,
                             dev)
    lib = build.library()
    with torch.cuda.device(dev) if dev != torch.cuda.current_device() else _NO_CONTEXT:
        err = lib.lib.pcdreg_patch_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), params, float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    lib.check(err, 'pcdreg_patch_attention')
    return out


def patch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused multi-head attention over independent patches.

    q, k, v: [R, H, K, d], any strides with a contiguous last dim.  The
    result goes into `out` when given (any such [R, H, K, d] view, for
    example of an [R, K, H, d] buffer), else into a new contiguous tensor.
    Kernel K3 on CUDA tensors, the plain version on CPU tensors.  No
    gradient flows through this call: with grad enabled, `out` is refused
    for inputs that require grad (the kernel's write into it is invisible to
    autograd); `PatchAttentionFunction` is the differentiable form.
    """
    if out is not None and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise RuntimeError('patch_attention: out= with inputs that require grad would '
                           'write where autograd cannot see; use PatchAttentionFunction')
    if q.device.type == 'cpu':
        ref = patch_attention_reference(q, k, v, scale)
        return ref if out is None else out.copy_(ref)
    if q.device.type != 'cuda':
        raise ValueError(f'patch_attention: unsupported device {q.device}')
    out = _launch(q, k, v, scale, out)
    patch_attention.launches += 1
    return out


patch_attention.launches = 0


def patch_attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                       g: torch.Tensor, scale: float):
    """Plain PyTorch backward with the JAX `_bwd` numerics (f32): (dq, dk, dv)
    of `patch_attention` for the output gradient g [R, H, K, d]."""
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    s = torch.einsum('rhkd,rhmd->rhkm', qf * scale, kf)
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum('rhkm,rhkd->rhmd', p, gf)
    dp = torch.einsum('rhkd,rhmd->rhkm', gf, vf)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dq = torch.einsum('rhkm,rhmd->rhkd', ds, kf) * scale
    dk = torch.einsum('rhkm,rhkd->rhmd', ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.lru_cache(maxsize=1024)
def _backward_args(shape: tuple, dtype: torch.dtype, strides: tuple):
    """Validate what K3b takes of one layout (raises ValueError) and return
    its parameter array; cached per layout."""
    if len(shape) != 4:
        raise ValueError(f'patch_attention_backward takes [R, H, K, d], got {shape}')
    if dtype != torch.float32:
        raise ValueError(f'patch_attention_backward kernel takes f32, got {dtype}')
    R, H, K, d = shape
    names = ('q', 'k', 'v', 'o', 'g', 'dq', 'dk', 'dv')
    for name, st in zip(names, strides):
        if d > 1 and st[3] != 1:
            raise ValueError(f'patch_attention_backward kernel takes a contiguous last '
                             f'dim, got {name} strides {st}')
    if R * H * -(-K // 32) >= 2 ** 31:
        raise ValueError(f'patch_attention_backward kernel: R*H*ceil(K/32) must be '
                         f'< 2**31, got shape {shape}')
    return (ctypes.c_longlong * 28)(*(x for st in strides for x in st[:3]), *shape)


def _launch_backward(q, k, v, o, g, scale: float, out=None):
    """Launch K3b: (dq, dk, dv) into `out` (new contiguous tensors by
    default); counts nothing."""
    for name, t in (('k', k), ('v', v), ('o', o), ('g', g), *zip(
            ('dq', 'dk', 'dv'), out or ())):
        if (t.shape != q.shape or t.dtype != q.dtype or t.get_device() != q.get_device()):
            raise ValueError(f'patch_attention_backward: {name} {t.dtype} '
                             f'{tuple(t.shape)} on {t.device} does not match q '
                             f'{q.dtype} {tuple(q.shape)} on {q.device}')
    if out is None:
        out = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    ts = (q, k, v, o, g, *out)
    params = _backward_args(tuple(q.shape), q.dtype, tuple(t.stride() for t in ts))
    dev = q.get_device()
    scratch = torch.empty((2, q.shape[0] * q.shape[1] * q.shape[2]), dtype=torch.float32,
                          device=q.device)
    lib = build.library()
    with torch.cuda.device(dev) if dev != torch.cuda.current_device() else _NO_CONTEXT:
        err = lib.lib.pcdreg_patch_attention_bwd(
            *(t.data_ptr() for t in ts), scratch[0].data_ptr(), scratch[1].data_ptr(),
            params, float(scale), torch.cuda.current_stream(dev).cuda_stream)
    lib.check(err, 'pcdreg_patch_attention_bwd')
    return out


def patch_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, g: torch.Tensor, scale: float,
                             out: Optional[tuple] = None) -> tuple:
    """(dq, dk, dv) of `patch_attention(q, k, v, scale)` = o for the output
    gradient g, all [R, H, K, d] with a contiguous last dim (any other
    strides).  Written into `out` = (dq, dk, dv) views when given, else new
    contiguous tensors.  Kernel K3b (two launches: dq, then dk and dv) on
    CUDA f32 tensors, the plain version on CPU tensors (which does not
    read o)."""
    if q.device.type == 'cpu':
        ref = patch_attention_backward_reference(q, k, v, g, scale)
        if out is None:
            return ref
        for dst, src in zip(out, ref):
            dst.copy_(src)
        return out
    if q.device.type != 'cuda':
        raise ValueError(f'patch_attention_backward: unsupported device {q.device}')
    out = _launch_backward(q, k, v, o, g, scale, out)
    patch_attention_backward.launches += 1
    return out


patch_attention_backward.launches = 0


def unpack_qkv(qkv: torch.Tensor) -> tuple:
    """q, k, v [R, H, K, d] views of a packed projection [R, K, 3, H, d]."""
    return qkv.permute(2, 0, 3, 1, 4).unbind(0)


class PatchAttentionFunction(torch.autograd.Function):
    """Differentiable patch attention over a packed projection.

    ``apply(qkv, scale)``: qkv [R, K, 3, H, d] (the PTv3 projection, any
    strides with a contiguous last dim) -> out [R, K, H, d] contiguous, the
    attention of its q, k, v views.  The forward goes through
    `patch_attention` (K3 on CUDA, the plain version on CPU) straight into
    `out`; the backward through `patch_attention_backward` (K3b on CUDA, the
    plain backward on CPU), which writes dq, dk and dv as views of one
    [R, K, 3, H, d] gradient, so the projection's backward takes it with no
    copy.  Saves qkv and out.
    """

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, scale: float) -> torch.Tensor:
        R, K, _, H, d = qkv.shape
        out = torch.empty((R, K, H, d), dtype=qkv.dtype, device=qkv.device)
        patch_attention(*unpack_qkv(qkv), scale, out=out.transpose(1, 2))
        ctx.save_for_backward(qkv, out)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        qkv, out = ctx.saved_tensors
        if grad.stride(-1) != 1:
            grad = grad.contiguous()
        dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
        patch_attention_backward(*unpack_qkv(qkv), out.transpose(1, 2), grad.transpose(1, 2),
                                 ctx.scale, out=unpack_qkv(dqkv))
        return dqkv, None
