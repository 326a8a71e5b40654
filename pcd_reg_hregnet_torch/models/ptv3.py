"""PTv3 with serialized patch attention (port of
`pcd_reg_hregnet_tpu/models/ptv3.py`: `SerializedDepthwiseConv`, `KnnCPE`,
`cpe_neighbors`, `PatchAttention`, `PTv3Mlp`, `PTv3Block`,
`PointTransformerEncoder`, and the full encoder-decoder
`PointTransformerV3` with `SerializedPooling` / `SerializedUnpooling`).

The attention core always goes through
`ops.kernels.attention.PatchAttentionFunction` (kernels K3 and K3b on CUDA),
at every patch size.  GELU is the tanh approximation
(flax's default); LayerNorm eps is 1e-2; the stem BatchNorm has eps 1e-2
and torch momentum 0.01 (flax 0.99).

With a bf16 `dtype` the Dense layers, the depthwise conv and the attention
(K3/K3b in bf16) compute in bf16 and each sublayer's output goes back to
its input's dtype, as in the JAX module; LayerNorm and BatchNorm run in
f32 in train mode and in bf16 in eval mode, so a block carries f32
activations in training and bf16 ones in eval.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import fp32_numerics
from ..ops import serialization
from ..ops.kernels.attention import PatchAttentionFunction
from ..ops.neighbors import knn, knn_gather
from ..parallel import sequence
from .layers import BatchNorm, Dense, low_precision, result_dtype


# jax.nn.gelu's constants, weak-typed, enter a bf16 product as bf16: each
# is rounded to bf16 once here, so the product with it rounds once, as JAX's
_GELU_C = {dt: tuple(float(torch.tensor(c, dtype=dt))
                     for c in (math.sqrt(2 / math.pi), 0.044715))
           for dt in (torch.bfloat16, torch.float16)}


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's GELU, the tanh approximation; in bf16 op by op as XLA rounds
    `jax.nn.gelu` (every product and sum rounded, the constants in bf16)."""
    if not low_precision(x.dtype):
        return F.gelu(x, approximate='tanh')
    a, b = _GELU_C[x.dtype]
    return x * (0.5 * (1.0 + torch.tanh(a * (x + b * (x * x * x)))))


def _upcast(x: torch.Tensor) -> bool:
    """A sublayer's `.astype(x.dtype)` to an f32 input (train mode) takes
    its last Dense's bias in f32 (`layers.Dense`'s `upcast`)."""
    return not low_precision(x.dtype)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...] reordered along N by idx [B, N]."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx]


class LayerNorm(nn.LayerNorm):
    """`nn.LayerNorm` in f32 whose output is f32 in train mode and `dtype`
    (None: the promotion of the input and f32) in eval mode, as the JAX
    block's `ln_dtype` sets flax's."""

    def __init__(self, channels: int, eps: float, dtype: Optional[torch.dtype] = None):
        super().__init__(channels, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wide = torch.promote_types(x.dtype, self.weight.dtype)   # at least f32
        out = wide if self.training else result_dtype(self.compute_dtype, x, self.weight)
        return super().forward(x.to(wide)).to(out)


class SerializedDepthwiseConv(nn.Module):
    """Depthwise conv along the serialized order, 'SAME' padding, in
    `dtype` (flax `nn.Conv(dtype=)`), its output in the input's dtype.
    With a `group`, x is this rank's share of a sequence-sharded order and
    the padding comes from the neighbouring shares
    (`parallel.sequence.sharded_depthwise_conv`)."""

    def __init__(self, channels: int, kernel: int = 3, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.Conv_0 = nn.Conv1d(channels, channels, kernel, groups=channels,
                                padding=kernel // 2)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:    # [B, N, C]
        conv = self.Conv_0
        dt = result_dtype(self.compute_dtype, x, conv.weight)
        if group is not None:
            return sequence.sharded_depthwise_conv(x.to(dt), conv.weight.to(dt),
                                                   conv.bias.to(dt), group).to(x.dtype)
        y = F.conv1d(x.transpose(1, 2).to(dt), conv.weight.to(dt), conv.bias.to(dt),
                     padding=conv.padding, groups=conv.groups)
        return y.transpose(1, 2).to(x.dtype)


class KnnCPE(nn.Module):
    """3D-neighbourhood positional encoding: y_i = mean_j w(p_j - p_i) * x_j,
    the weights in `dtype`, the mean in the input's dtype."""

    def __init__(self, channels: int, hidden: int = 16, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.Dense_0 = Dense(4, hidden, dtype=dtype)
        self.Dense_1 = Dense(hidden, channels, dtype=dtype)

    def forward(self, x, nbr_idx, rel):
        h = knn_gather(x, nbr_idx)                              # [B,N,k,C]
        w = self.Dense_1(_gelu(self.Dense_0(rel)))
        if not low_precision(h.dtype):
            return torch.mean(h * w.to(h.dtype), dim=2)
        # XLA fuses the product into the mean: f32 products, one rounding
        return torch.mean(h.float() * w.to(h.dtype).float(), dim=2).to(h.dtype)


def cpe_neighbors(xyz: torch.Tensor, k: int = 8):
    """kNN indices + mean-distance-normalised relative offsets for `KnnCPE`."""
    _, idx = knn(xyz, xyz, k)
    rel = knn_gather(xyz, idx) - xyz[:, :, None, :]
    dist = torch.sqrt(torch.sum(rel * rel, dim=-1, keepdim=True) + 1e-12)
    scale = torch.mean(dist, dim=(1, 2), keepdim=True) + 1e-6
    return idx, torch.cat([rel, dist], dim=-1) / scale


class PatchAttention(nn.Module):
    """Multi-head attention within fixed-size serialized patches; the
    projections and the attention (K3, K3b) in `dtype`, the output in the
    input's dtype."""

    def __init__(self, channels: int, num_heads: int, patch_size: int,
                 qkv_bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.channels, self.num_heads, self.patch_size = channels, num_heads, patch_size
        self.Dense_0 = Dense(channels, 3 * channels, bias=qkv_bias, dtype=dtype)
        self.Dense_1 = Dense(channels, channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:    # [B, N, C] serialized
        B, N, C = x.shape
        K = min(self.patch_size, N)
        H = self.num_heads
        d = C // H
        R = B * (N // K)
        qkv = self.Dense_0(x).reshape(R, K, 3, H, d)
        out = PatchAttentionFunction.apply(qkv, d ** -0.5)   # [R, K, H, d]
        return self.Dense_1(out.reshape(B, N, C), _upcast(x)).to(x.dtype)


class PTv3Mlp(nn.Module):
    def __init__(self, channels: int, mlp_ratio: float = 4.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.Dense_0 = Dense(channels, int(channels * mlp_ratio), dtype=dtype)
        self.Dense_1 = Dense(int(channels * mlp_ratio), channels, dtype=dtype)

    def forward(self, x):
        return self.Dense_1(_gelu(self.Dense_0(x)), _upcast(x)).to(x.dtype)


class PTv3Block(nn.Module):
    """CPE + pre-norm patch attention + pre-norm MLP.  With a `group`, x
    (and `nbr_idx`, `rel`) are this rank's rows of a sequence-sharded order
    (`parallel.sequence`): the kNN CPE gathers every rank's rows once, the
    curve CPE exchanges a halo, the rest acts on the rank's rows alone."""

    def __init__(self, channels: int, num_heads: int, patch_size: int,
                 mlp_ratio: float = 4.0, cpe: str = 'curve',
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cpe = cpe
        if cpe == 'knn':
            self.KnnCPE_0 = KnnCPE(channels, dtype=dtype)
        elif cpe == 'curve':
            self.SerializedDepthwiseConv_0 = SerializedDepthwiseConv(channels, dtype=dtype)
        elif cpe != 'none':
            raise ValueError(f'unknown cpe {cpe!r}')
        norms = 3 if cpe != 'none' else 2
        if cpe != 'none':
            self.Dense_0 = Dense(channels, channels, dtype=dtype)
        for j in range(norms):
            self.add_module(f'LayerNorm_{j}', LayerNorm(channels, 1e-2, dtype))
        self._attn_norm = f'LayerNorm_{norms - 2}'
        self._mlp_norm = f'LayerNorm_{norms - 1}'
        self.PatchAttention_0 = PatchAttention(channels, num_heads, patch_size, dtype=dtype)
        self.PTv3Mlp_0 = PTv3Mlp(channels, mlp_ratio, dtype)

    def forward(self, x, nbr_idx=None, rel=None, group=None):
        if self.cpe == 'knn':
            whole = x if group is None else sequence.gather_rows(x, group)
            cpe = self.KnnCPE_0(whole, nbr_idx, rel)
        elif self.cpe == 'curve':
            cpe = self.SerializedDepthwiseConv_0(x, group)
        else:
            cpe = None
        if cpe is not None:
            x = x + self.LayerNorm_0(self.Dense_0(cpe, _upcast(x)).to(x.dtype))
        x = x + self.PatchAttention_0(getattr(self, self._attn_norm)(x))
        x = x + self.PTv3Mlp_0(getattr(self, self._mlp_norm)(x))
        return x


class PointTransformerEncoder(nn.Module):
    """Encoder-only PTv3 with channel-preserving stage transitions.

    Input xyz [B, N, 3] and feat [B, N, in_channels]; output
    [B, N, channels] in the input's point order (f32 in train mode, `dtype`
    in eval mode: the stem's BatchNorm is f32 in training).

    With `seq_axis` set, inside `parallel.sequence.sequence_mesh(group)`
    the serialized order is sharded over the group's ranks after the stem's
    depthwise conv (the module docstring of `parallel/sequence.py` gives
    the steps); each rank's share must hold whole patches, and the output
    is gathered, the same on every rank.  Eval mode only.  Without an
    active group `seq_axis` changes nothing, as in the JAX module.
    """

    def __init__(self, in_channels: int, channels: int,
                 depths: Sequence[int] = (2, 2, 2),
                 num_heads: Sequence[int] = (2, 4, 8), patch_size: int = 256,
                 mlp_ratio: float = 4.0, grid_size: float = 0.01,
                 cpe: str = 'curve', dtype: Optional[torch.dtype] = None,
                 seq_axis: Optional[str] = None):
        super().__init__()
        self.depths, self.patch_size = tuple(depths), patch_size
        self.grid_size, self.cpe, self.seq_axis = grid_size, cpe, seq_axis
        self.SerializedDepthwiseConv_0 = SerializedDepthwiseConv(in_channels, 5, dtype)
        self.Dense_0 = Dense(in_channels, channels, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(channels, eps=1e-2, momentum=0.01, dtype=dtype)
        for s in range(1, len(depths)):
            self.add_module(f'Dense_{s}', Dense(channels, channels, dtype=dtype))
            self.add_module(f'BatchNorm_{s}', BatchNorm(channels, dtype=dtype))
        n = 0
        for s, depth in enumerate(depths):
            for _ in range(depth):
                self.add_module(f'PTv3Block_{n}', PTv3Block(
                    channels, num_heads[s], patch_size, mlp_ratio, cpe=cpe, dtype=dtype))
                n += 1

    def forward(self, xyz: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        N = xyz.shape[1]
        if N % min(self.patch_size, N) != 0:
            raise ValueError(
                f'PointTransformerEncoder patch_size={self.patch_size} must '
                f'divide the point count {N}')
        group = sequence.active_sequence_mesh() if self.seq_axis is not None else None
        if group is not None and self.training:
            raise ValueError('sequence parallelism (seq_axis under sequence_mesh) is eval only')
        order, inverse = serialization.serialize(xyz, self.grid_size)
        x = _take_rows(feat, order)
        nbr_idx = rel = None
        if self.cpe == 'knn':
            nbr_idx, rel = cpe_neighbors(_take_rows(xyz, order))

        # the stem's conv reads the whole replicated order: no halo
        x = self.SerializedDepthwiseConv_0(x)
        if group is not None:
            share = sequence.sequence_sharding(N, group, min(self.patch_size, N))
            x = x[:, share]
            if nbr_idx is not None:
                nbr_idx, rel = nbr_idx[:, share], rel[:, share]
        x = _gelu(self.BatchNorm_0(self.Dense_0(x, upcast=True)))
        n = 0
        for s, depth in enumerate(self.depths):
            if s > 0:
                x = getattr(self, f'Dense_{s}')(x, upcast=True)
                x = _gelu(getattr(self, f'BatchNorm_{s}')(x))
            for _ in range(depth):
                x = getattr(self, f'PTv3Block_{n}')(x, nbr_idx, rel, group)
                n += 1
        if group is not None:
            x = sequence.gather_rows(x, group)
        return _take_rows(x, inverse)


class SerializedPooling(nn.Module):
    """Stride-s downsampling along the serialized order: a Dense projection,
    the max of each run of s features, the mean of its xyz, BatchNorm
    (flax momentum 0.9, eps 1e-5) and GELU.  f32 only, as the JAX module."""

    def __init__(self, in_channels: int, channels: int, stride: int = 2):
        super().__init__()
        self.stride = stride
        self.Dense_0 = Dense(in_channels, channels)
        self.BatchNorm_0 = BatchNorm(channels)

    def forward(self, xyz: torch.Tensor, x: torch.Tensor):
        B, N, _ = x.shape
        s = self.stride
        if N % s:
            raise ValueError(f'SerializedPooling stride {s} must divide N={N}')
        x = self.Dense_0(x)
        x = torch.amax(x.reshape(B, N // s, s, x.shape[-1]), dim=2)
        xyz = torch.mean(xyz.reshape(B, N // s, s, 3), dim=2)
        return xyz, _gelu(self.BatchNorm_0(x))


class SerializedUnpooling(nn.Module):
    """Undo a stride-s pooling: each pooled feature projected and repeated
    over its run, added to the projected skip features, BatchNorm (flax
    momentum 0.9, eps 1e-5) and GELU."""

    def __init__(self, in_channels: int, skip_channels: int, channels: int, stride: int = 2):
        super().__init__()
        self.stride = stride
        self.Dense_0 = Dense(in_channels, channels)
        self.Dense_1 = Dense(skip_channels, channels)
        self.BatchNorm_0 = BatchNorm(channels)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = torch.repeat_interleave(self.Dense_0(x), self.stride, dim=1)
        return _gelu(self.BatchNorm_0(up + self.Dense_1(skip)))


class PointTransformerV3(nn.Module):
    """Full PTv3: embedding stem -> pooled encoder stages -> unpooled decoder
    stages with skip connections; the blocks of a stage cycle through
    `orders` (the reference's order shuffle).

    Input xyz [B, N, 3] and feat [B, N, in_channels], N a multiple of
    patch_size * stride ** (stages - 1) (or of the point count a stage
    has, where that is below patch_size); output per-point features
    [B, N, dec_channels[0]] in the input's point order.  Every attention
    goes through `PatchAttentionFunction` (K3, K3b).  The forward runs
    without TF32 (`core.device.fp32_numerics`); a caller that trains wraps
    its backward in the same block.  f32 only.  The submodules carry
    flax's names, so `utils.convert.from_flax` loads the JAX module's
    variables strictly.  Each name in `orders` is serialized as named
    (`serialization.ORDERS`); the JAX module's `_orders` reads every name
    but 'hilbert' as 'z', so the two agree for the default ('z', 'hilbert').
    """

    def __init__(self, in_channels: int,
                 enc_channels: Sequence[int] = (32, 64, 128, 256),
                 enc_depths: Sequence[int] = (2, 2, 2, 2),
                 enc_heads: Sequence[int] = (2, 4, 8, 16),
                 dec_channels: Sequence[int] = (64, 64, 128),
                 dec_depths: Sequence[int] = (2, 2, 2),
                 dec_heads: Sequence[int] = (4, 4, 8),
                 patch_size: int = 128, stride: int = 2, mlp_ratio: float = 4.0,
                 grid_size: float = 0.01, orders: Sequence[str] = ('z', 'hilbert'),
                 cpe: str = 'curve'):
        super().__init__()
        self.enc_depths, self.enc_heads = tuple(enc_depths), tuple(enc_heads)
        self.dec_depths, self.dec_heads = tuple(dec_depths), tuple(dec_heads)
        self.patch_size, self.stride = patch_size, stride
        self.grid_size, self.orders, self.cpe = grid_size, tuple(orders), cpe
        for o in self.orders:
            if o not in serialization.ORDERS:
                raise ValueError(f'unsupported serialization order: {o}')
        self.SerializedDepthwiseConv_0 = SerializedDepthwiseConv(in_channels, 5)
        self.Dense_0 = Dense(in_channels, enc_channels[0])
        self.BatchNorm_0 = BatchNorm(enc_channels[0], eps=1e-2, momentum=0.01)
        # flax names submodules in creation order: blocks numbered through
        # the encoder and the decoder, a pooling before stages 1.., an
        # unpooling before each decoder stage (deepest first)
        blocks = pools = 0
        for s, depth in enumerate(enc_depths):
            if s > 0:
                self.add_module(f'SerializedPooling_{pools}', SerializedPooling(
                    enc_channels[s - 1], enc_channels[s], stride))
                pools += 1
            for _ in range(depth):
                self.add_module(f'PTv3Block_{blocks}', self._block(enc_channels[s],
                                                                   enc_heads[s], mlp_ratio))
                blocks += 1
        cur = enc_channels[-1]
        for n, d in enumerate(range(len(dec_depths) - 1, -1, -1)):
            self.add_module(f'SerializedUnpooling_{n}', SerializedUnpooling(
                cur, enc_channels[d], dec_channels[d], stride))
            cur = dec_channels[d]
            for _ in range(dec_depths[d]):
                self.add_module(f'PTv3Block_{blocks}', self._block(cur, dec_heads[d],
                                                                   mlp_ratio))
                blocks += 1

    def _block(self, channels: int, heads: int, mlp_ratio: float) -> PTv3Block:
        return PTv3Block(channels, heads, self.patch_size, mlp_ratio, cpe=self.cpe)

    def _run_blocks(self, xyz, x, depth: int, first: int):
        """Blocks `first`.. of a stage, block b in order b % len(orders).
        With `cpe='knn'` the stage's kNN runs once in the input frame, and
        each block maps it into its serialized frame: rows permute by
        `order`, stored indices through `inverse`."""
        table = [serialization.serialize(xyz, self.grid_size, o) for o in self.orders]
        nbr_idx = rel = None
        if self.cpe == 'knn':
            nbr_idx, rel = cpe_neighbors(xyz)
        for b in range(depth):
            order, inverse = table[b % len(table)]
            bi = br = None
            if self.cpe == 'knn':
                bi = _take_rows(torch.gather(inverse, 1, nbr_idx.reshape(
                    nbr_idx.shape[0], -1)).reshape(nbr_idx.shape), order)
                br = _take_rows(rel, order)
            xs = getattr(self, f'PTv3Block_{first + b}')(_take_rows(x, order), bi, br)
            x = _take_rows(xs, inverse)
        return x

    @fp32_numerics()
    def forward(self, xyz: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        order, inverse = serialization.serialize(xyz, self.grid_size, 'z')
        x = self.SerializedDepthwiseConv_0(_take_rows(feat, order))
        x = _gelu(self.BatchNorm_0(self.Dense_0(x)))
        x = _take_rows(x, inverse)

        skips = []
        block = 0
        for s, depth in enumerate(self.enc_depths):
            if s > 0:
                # pool along the stage's z-order; the decoder undoes the
                # permutation with the skip
                o, inv = serialization.serialize(xyz, self.grid_size, 'z')
                skips.append((xyz, x, o, inv))
                xyz, x = getattr(self, f'SerializedPooling_{s - 1}')(
                    _take_rows(xyz, o), _take_rows(x, o))
            x = self._run_blocks(xyz, x, depth, block)
            block += depth

        for n, d in enumerate(range(len(self.dec_depths) - 1, -1, -1)):
            xyz, skip, o, inv = skips.pop()
            xs = getattr(self, f'SerializedUnpooling_{n}')(x, _take_rows(skip, o))
            x = self._run_blocks(xyz, _take_rows(xs, inv), self.dec_depths[d], block)
            block += self.dec_depths[d]
        return x
