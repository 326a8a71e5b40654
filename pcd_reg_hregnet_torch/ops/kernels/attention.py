"""Patch attention: CUDA kernels K3 (forward) and K3b (backward), their
plain versions, and the autograd Function that joins them.

K3 replaces `pcd_reg_hregnet_tpu/ops/pallas/attention.py::_attn_kernel`;
the kernel is `csrc/attention.cu`, a tiled flash kernel on the tensor cores
(3xTF32 in f32, bf16 mma in bf16).  K3b replaces that file's `_bwd` (the
`custom_vjp` backward) and takes each query row's log-sum-exp from the
forward: in f32 `csrc/attention_bwd.cu`, a one-launch FlashAttention-2
backward on 3xTF32 `mma.sync`; in bf16 `csrc/attention_bwd_bf16.cu`, a
FlashAttention-3-shaped backward on `wgmma` fed by TMA (the "wgmma"
route), and attention_bwd.cu's bf16 `mma.sync` instantiations for the
shapes it does not take (the "mma" route: d not a multiple of 8, d > 128,
K > 512, or a block past 227 KB of shared memory).  Layout is the JAX
function's: q, k, v [R, H, K, d] -> out [R, H, K, d] in q's dtype, softmax
in f32.  Both kernels take f32 or bf16, any K and d and any strides with
a contiguous last dim; `plan` is K3's tiling and `plan_backward` K3b's.
The model goes through `PatchAttentionFunction`, so autograd sees every
write of the kernels.  Each wrapper counts its launches in `launches` and,
per dtype, in `launches_by_dtype`.
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
# K3b's block tilings (csrc/attention_bwd.cu kTilings): bn keys a block
# holds, qs warps that share each 16 of them (bn / 16 * qs warps)
BWD_TILES = ((64, 1), (64, 2), (32, 2), (32, 4), (16, 4))
MAX_CLUSTER = 8              # K3b: key tiles of a (patch, head) that share dQ in a cluster
MIN_BWD_BLOCKS = 96          # K3b: fewer blocks than this take smaller key tiles (the sweep)
# K3b in bf16 on wgmma (csrc/attention_bwd_bf16.cu): keys a block holds (one
# consumer warpgroup), query rows per streamed tile, ring stages, threads
# (the warpgroup and a producer warp)
WGMMA_KEYS = 64
WGMMA_ROWS = 64
WGMMA_STAGES = 3             # (2 at d > 64)
WGMMA_THREADS = 160
SM_SMEM = 233472             # shared memory of an H100 SM; a block holds 1 KB more than it asks
_NO_CONTEXT = contextlib.nullcontext()


def patch_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch attention with the JAX `_dense_reference` numerics."""
    s = torch.einsum('rhkd,rhmd->rhkm', q.float() * scale, k.float())
    p = torch.softmax(s, dim=-1)
    return torch.einsum('rhkm,rhmd->rhkd', p, v.float()).to(q.dtype)


def attention_lse_reference(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain log-sum-exp of each query row's scaled scores, [R, H, K] f32:
    what K3 writes for the backward when given an `lse` buffer."""
    s = torch.einsum('rhkd,rhmd->rhkm', q.float() * scale, k.float())
    return torch.logsumexp(s, dim=-1)


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


def _check_lse(q, lse, what: str) -> None:
    """lse is a contiguous f32 [R, H, K] on q's device (raises ValueError)."""
    if (lse.shape != q.shape[:3] or lse.dtype != torch.float32 or not lse.is_contiguous()
            or lse.get_device() != q.get_device()):
        raise ValueError(f'{what}: lse must be contiguous f32 {tuple(q.shape[:3])} on '
                         f'{q.device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}')


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
            split: Optional[int] = None, lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K3 into `out` (a new contiguous tensor by default) with `bm`
    query rows per block and `split` warps per 16 rows (`plan`'s by
    default), and each query row's log-sum-exp into `lse` when given;
    counts nothing."""
    _check(q, k, v, out)
    if lse is not None:
        _check_lse(q, lse, 'patch_attention')
    dev = q.get_device()
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _, params = _launch_args(tuple(q.shape), q.dtype,
                             (q.stride(), k.stride(), v.stride(), out.stride()), bm, split,
                             dev)
    lib = build.library()
    with torch.cuda.device(dev) if dev != torch.cuda.current_device() else _NO_CONTEXT:
        err = lib.lib.pcdreg_patch_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), params, float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    lib.check(err, 'pcdreg_patch_attention')
    return out


def patch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, out: Optional[torch.Tensor] = None,
                    lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused multi-head attention over independent patches.

    q, k, v: [R, H, K, d], any strides with a contiguous last dim.  The
    result goes into `out` when given (any such [R, H, K, d] view, for
    example of an [R, K, H, d] buffer), else into a new contiguous tensor.
    `lse` (a contiguous f32 [R, H, K]), when given, receives each query
    row's log-sum-exp of the scaled scores, which the backward takes.
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
        if lse is not None:
            _check_lse(q, lse, 'patch_attention')
            lse.copy_(attention_lse_reference(q, k, scale))
        ref = patch_attention_reference(q, k, v, scale)
        return ref if out is None else out.copy_(ref)
    if q.device.type != 'cuda':
        raise ValueError(f'patch_attention: unsupported device {q.device}')
    out = _launch(q, k, v, scale, out, lse=lse)
    _count(patch_attention, q.dtype)
    return out


def _count(wrapper, dtype: torch.dtype) -> None:
    """One launch of `wrapper`'s kernel in `dtype`."""
    wrapper.launches += 1
    wrapper.launches_by_dtype[dtype] += 1


def reset_counts() -> None:
    """Set both wrappers' launch counts, total and per dtype, to 0."""
    for wrapper in (patch_attention, patch_attention_backward):
        wrapper.launches = 0
        wrapper.launches_by_dtype = dict.fromkeys(_DTYPE_CODES, 0)


patch_attention.launches = 0
patch_attention.launches_by_dtype = dict.fromkeys(_DTYPE_CODES, 0)


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


@dataclass(frozen=True)
class BackwardPlan:
    """K3b's tiling of one call (`csrc/attention_bwd.cu` computes the same
    `dp`, `bm`, `stages`, `cluster` and `smem`: `pcdreg_attention_bwd_plan`)."""
    dp: int       # padded head width a block holds (8..128; bf16 from 16)
    bn: int       # keys a block holds
    qs: int       # warps that share each 16 keys, each taking 1/qs of every query tile
    bm: int       # query rows per streamed tile
    stages: int   # query tiles in the cp.async ring
    cluster: int  # blocks per cluster, the key tiles of a (patch, head); 0 when
                  # their dQ partials meet in device memory (scratch) instead
    slices: int   # blocks along d: ceil(d / 128) when d > 128, else 1
    smem: int     # dynamic shared memory bytes of a block
    grid: tuple   # (R * H * ceil(K / bn), slices)
    threads: int  # 32 * bn / 16 * qs; WGMMA_THREADS on the wgmma route
    route: str = 'mma'   # 'mma': csrc/attention_bwd.cu; 'wgmma': csrc/attention_bwd_bf16.cu


def _wgmma_plan(K: int, d: int):
    """(dp, stages, smem) of K3b's bf16 wgmma kernel at (K, d), or None
    where it does not take the shape (`pcdreg_attention_bwd_bf16_plan`
    computes the same): d a multiple of 8 up to 128 (TMA's 16-byte rows),
    at most `MAX_CLUSTER` key tiles, the block's shared memory (K and V,
    the ring of Q, G and O tiles with each row's lse and D, two dS^T, the f32
    dQ partial of every query row, the barriers, 1 KB of alignment) within
    `MAX_SMEM`."""
    if d % 8 or d > WIDE or -(-K // WGMMA_KEYS) > MAX_CLUSTER:
        return None
    dp = padded_width(d, torch.bfloat16)
    ntq = -(-K // WGMMA_ROWS)
    stages = min(WGMMA_STAGES if dp <= 64 else 2, ntq)
    tile = WGMMA_KEYS * dp * 2
    smem = (2 * tile + 3 * stages * tile + 2 * WGMMA_KEYS * WGMMA_ROWS * 2
            + 2 * stages * WGMMA_ROWS * 4 + ntq * WGMMA_ROWS * (dp + 4) * 4
            + (1 + 3 * stages) * 8 + 1024)
    return (dp, stages, smem) if smem <= MAX_SMEM else None


def backward_route(K: int, d: int, dtype: torch.dtype) -> str:
    """The kernel that takes K3b at (K, d) in `dtype`, by shape alone:
    'wgmma' (bf16 shapes `_wgmma_plan` takes) or 'mma'."""
    return 'wgmma' if dtype == torch.bfloat16 and _wgmma_plan(K, d) else 'mma'


def backward_tilings(K: int, d: int, dtype: torch.dtype) -> tuple:
    """The block tilings `plan_backward(..., tile=)` takes at (K, d): the
    mma route's `BWD_TILES`; none on the wgmma route, which has one."""
    return BWD_TILES if backward_route(K, d, dtype) == 'mma' else ()


def plan_backward(R: int, H: int, K: int, d: int, tile: Optional[tuple] = None,
                  sms: int = SMS, dtype: torch.dtype = torch.float32) -> BackwardPlan:
    """The tiling of `patch_attention_backward` over [R, H, K, d] in `dtype`
    on a card with `sms` multiprocessors.

    bf16 shapes the wgmma kernel takes (`backward_route`) have one tiling:
    blocks of `WGMMA_KEYS` keys, one cluster per (patch, head), query tiles
    of `WGMMA_ROWS` rows through a ring of up to `WGMMA_STAGES`; `tile`
    must be None there.

    Every other shape takes the mma route, where `tile` is one of
    `BWD_TILES`, (bn, qs).  Without it (the choice
    follows the sweep of `chip_smoke.py` on an H100, PERF.md): of the key
    tiles whose blocks of a (patch, head) fit one cluster, the largest that
    gives at least `MIN_BWD_BLOCKS` (scaled to `sms`) blocks, else the
    smallest (a batch of one pair); with 4 warps a block, or 8 where two
    blocks of 4 warps do not fit an SM's shared memory (latency, not
    throughput, bounds a warp: an SM needs 8 in flight).  Shapes no tiling
    fits in a cluster (K > 512, d > 128) take (64, 2) and the device-memory
    dQ path.
    """
    if backward_route(K, d, dtype) == 'wgmma':
        if tile is not None:
            raise ValueError(f'patch_attention_backward: bf16 at K={K} d={d} runs on the '
                             f'wgmma kernel, which has no tiling {tile}')
        dp, stages, smem = _wgmma_plan(K, d)
        ntk = -(-K // WGMMA_KEYS)
        return BackwardPlan(dp, WGMMA_KEYS, 1, WGMMA_ROWS, stages, ntk, 1, smem,
                            (R * H * ntk, 1), WGMMA_THREADS, 'wgmma')
    wide = d > WIDE
    dp = WIDE if wide else padded_width(d, dtype)
    es = 4 if dtype == torch.float32 else 2
    stages = 2
    slices = -(-d // WIDE) if wide else 1

    def query_rows(qs):   # a warp's query share a multiple of 16 in bf16
        return max(32 if dp == WIDE else 64, 16 * qs if es == 2 else 0)

    def smem_of(bn, qs, cluster):   # rows of every tile padded by 16 bytes
        bm = query_rows(qs)
        kp = -(-K // bm) * bm
        rows = kp if cluster else bm
        ring = max(stages * 2 * bm * (dp + 16 // es) * es, 2 * qs * bn * (dp + 4) * 4)
        return (2 * bn * (dp + 16 // es) * es + ring + bn * (bm + 16 // es) * es
                + 4 * 2 * rows + (4 * kp * (dp + 4) if cluster else 0))

    def clustered(bn, qs):
        return not wide and -(-K // bn) <= MAX_CLUSTER and smem_of(bn, qs, True) <= MAX_SMEM

    if tile is None:
        fits = [t for t in BWD_TILES if clustered(*t)]
        if fits:
            keys = sorted({bn for bn, _ in fits}, reverse=True)
            want = MIN_BWD_BLOCKS * sms // SMS
            bn = next((b for b in keys if R * H * -(-K // b) >= want), keys[-1])
            four = next(t for t in fits if t[0] == bn and t[0] // 16 * t[1] == 4)
            eight = [t for t in fits if t[0] == bn and t[0] // 16 * t[1] == 8]
            crowded = 2 * (smem_of(*four, True) + 1024) > SM_SMEM
            tile = eight[0] if eight and crowded else four
        else:
            tile = (64, 2)
    if tile not in BWD_TILES:
        raise ValueError(f'patch_attention_backward: no kernel for tiling {tile} (one of '
                         f'{BWD_TILES})')
    bn, qs = tile
    ntk = -(-K // bn)
    cl = clustered(bn, qs)
    return BackwardPlan(dp, bn, qs, query_rows(qs), stages, ntk if cl else 0, slices,
                        smem_of(bn, qs, cl), (R * H * ntk, slices), 2 * bn * qs)


@functools.lru_cache(maxsize=1024)
def _backward_args(shape: tuple, dtype: torch.dtype, strides: tuple, tile: Optional[tuple],
                   dev: int):
    """Validate what K3b takes of one layout (raises ValueError) and return
    its `plan_backward` on device `dev` and its parameter array; cached per
    layout."""
    if len(shape) != 4:
        raise ValueError(f'patch_attention_backward takes [R, H, K, d], got {shape}')
    if dtype not in _DTYPE_CODES:
        raise ValueError(f'patch_attention_backward kernel takes f32 or bf16, got {dtype}')
    R, H, K, d = shape
    names = ('q', 'k', 'v', 'o', 'g', 'dq', 'dk', 'dv')
    for name, st in zip(names, strides):
        if d > 1 and st[3] != 1:
            raise ValueError(f'patch_attention_backward kernel takes a contiguous last '
                             f'dim, got {name} strides {st}')
    if R * H * -(-K // 16) >= 2 ** 31:
        raise ValueError(f'patch_attention_backward kernel: R*H*ceil(K/16) must be '
                         f'< 2**31, got shape {shape}')
    if tile is not None and tile not in backward_tilings(K, d, dtype):
        raise ValueError(f'patch_attention_backward: no kernel for tiling {tile} at K={K} '
                         f'd={d} {dtype} (one of {backward_tilings(K, d, dtype)})')
    p = plan_backward(R, H, K, d, tile, _sm_count(dev), dtype)
    if p.route == 'wgmma':   # inputs whose strides break TMA's 16-byte rule are copied
        params = (ctypes.c_longlong * 28)(*(x for st in strides for x in st[:3]), *shape)
        return p, params, tuple(_tma_strides(st, shape) for st in strides[:5])
    params = (ctypes.c_longlong * 31)(*(x for st in strides for x in st[:3]), *shape, p.bn,
                                      p.qs, _DTYPE_CODES[dtype])
    return p, params, None


def _tma_strides(stride: tuple, shape: tuple) -> bool:
    """Every stride of dims R, H, K (of size > 1) is a positive whole 16
    bytes (bf16): what a TMA tensor map of the view needs, beside a 16-byte
    aligned start (the last dim is contiguous)."""
    return all(s > 0 and s * 2 % 16 == 0 for s, n in zip(stride[:3], shape[:3]) if n > 1)


def _launch_backward(q, k, v, o, g, scale: float, out, lse, tile=None):
    """Launch K3b: (dq, dk, dv) into `out` (new contiguous tensors when
    None), on the kernel `backward_route` names for the shape, with the
    block tiling `tile` (`plan_backward`'s by default); `lse` is the
    forward's log-sum-exp of each query row.  Counts nothing."""
    for name, t in (('k', k), ('v', v), ('o', o), ('g', g), *zip(
            ('dq', 'dk', 'dv'), out or ())):
        if (t.shape != q.shape or t.dtype != q.dtype or t.get_device() != q.get_device()):
            raise ValueError(f'patch_attention_backward: {name} {t.dtype} '
                             f'{tuple(t.shape)} on {t.device} does not match q '
                             f'{q.dtype} {tuple(q.shape)} on {q.device}')
    if lse is None:
        raise ValueError('patch_attention_backward kernel takes the forward\'s lse '
                         '(patch_attention(..., lse=))')
    _check_lse(q, lse, 'patch_attention_backward')
    if out is None:
        out = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    ts = (q, k, v, o, g, *out)
    dev = q.get_device()
    p, params, tma = _backward_args(tuple(q.shape), q.dtype, tuple(t.stride() for t in ts),
                                    tile, dev)
    if p.route == 'wgmma':
        ptrs = [t.data_ptr() for t in ts]
        if not all(ok and x % 16 == 0 for ok, x in zip(tma, ptrs)):
            ts = tuple(t if i >= 5 or (tma[i] and ptrs[i] % 16 == 0)
                       else t.clone(memory_format=torch.contiguous_format)
                       for i, t in enumerate(ts))
            p, params, tma = _backward_args(tuple(q.shape), q.dtype,
                                            tuple(t.stride() for t in ts), tile, dev)
            ptrs = [t.data_ptr() for t in ts]
        lib = build.library()
        with torch.cuda.device(dev) if dev != torch.cuda.current_device() else _NO_CONTEXT:
            err = lib.lib.pcdreg_patch_attention_bwd_bf16(
                *ptrs[:5], lse.data_ptr(), *ptrs[5:], params, float(scale),
                torch.cuda.current_stream(dev).cuda_stream)
        lib.check(err, 'pcdreg_patch_attention_bwd_bf16')
        return out
    R, H, K, d = q.shape
    part = ticket = None
    if not p.cluster:   # the dQ partials meet in device memory
        part = torch.empty(p.grid[0] * K * d, dtype=torch.float32, device=q.device)
        ticket = torch.zeros(R * H * p.slices, dtype=torch.int32, device=q.device)
    lib = build.library()
    with torch.cuda.device(dev) if dev != torch.cuda.current_device() else _NO_CONTEXT:
        err = lib.lib.pcdreg_patch_attention_bwd(
            *(t.data_ptr() for t in ts[:5]), lse.data_ptr(), *(t.data_ptr() for t in out),
            None if part is None else part.data_ptr(),
            None if ticket is None else ticket.data_ptr(), params, float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    lib.check(err, 'pcdreg_patch_attention_bwd')
    return out


def patch_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, g: torch.Tensor, scale: float,
                             out: Optional[tuple] = None,
                             lse: Optional[torch.Tensor] = None) -> tuple:
    """(dq, dk, dv) of `patch_attention(q, k, v, scale)` = o for the output
    gradient g, all [R, H, K, d] with a contiguous last dim (any other
    strides).  Written into `out` = (dq, dk, dv) views when given, else new
    contiguous tensors.  `lse`: the forward's log-sum-exp of each query row
    (`patch_attention(..., lse=)`), contiguous f32 [R, H, K], which the
    kernel requires.  Kernel K3b (one launch) on CUDA f32 or bf16 tensors
    (dq, dk, dv in that dtype; f32 inside), the plain version on CPU
    tensors (which reads neither o nor lse)."""
    if q.device.type == 'cpu':
        ref = patch_attention_backward_reference(q, k, v, g, scale)
        if out is None:
            return ref
        for dst, src in zip(out, ref):
            dst.copy_(src)
        return out
    if q.device.type != 'cuda':
        raise ValueError(f'patch_attention_backward: unsupported device {q.device}')
    out = _launch_backward(q, k, v, o, g, scale, out, lse)
    _count(patch_attention_backward, q.dtype)
    return out


patch_attention_backward.launches = 0
patch_attention_backward.launches_by_dtype = dict.fromkeys(_DTYPE_CODES, 0)


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
    copy.  Saves qkv, out and, when qkv needs a gradient, each query row's
    log-sum-exp [R, H, K] f32, which the forward writes for K3b.
    """

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, scale: float) -> torch.Tensor:
        R, K, _, H, d = qkv.shape
        out = torch.empty((R, K, H, d), dtype=qkv.dtype, device=qkv.device)
        lse = (torch.empty((R, H, K), dtype=torch.float32, device=qkv.device)
               if ctx.needs_input_grad[0] else None)
        patch_attention(*unpack_qkv(qkv), scale, out=out.transpose(1, 2), lse=lse)
        ctx.save_for_backward(qkv, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        qkv, out, lse = ctx.saved_tensors
        if grad.stride(-1) != 1:
            grad = grad.contiguous()
        dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
        patch_attention_backward(*unpack_qkv(qkv), out.transpose(1, 2), grad.transpose(1, 2),
                                 ctx.scale, out=unpack_qkv(dqkv), lse=lse)
        return dqkv, None
