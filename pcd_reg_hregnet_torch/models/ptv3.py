"""Encoder-only PTv3 with serialized patch attention (port of
`pcd_reg_hregnet_tpu/models/ptv3.py`: `SerializedDepthwiseConv`, `KnnCPE`,
`cpe_neighbors`, `PatchAttention`, `PTv3Mlp`, `PTv3Block`,
`PointTransformerEncoder`).

The attention core always goes through
`ops.kernels.attention.PatchAttentionFunction` (kernels K3 and K3b on CUDA),
at every patch size.  GELU is the tanh approximation
(flax's default); LayerNorm eps is 1e-2; the stem BatchNorm has eps 1e-2
and torch momentum 0.01 (flax 0.99).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import serialization
from ..ops.kernels.attention import PatchAttentionFunction
from ..ops.neighbors import knn, knn_gather
from .layers import BatchNorm


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate='tanh')


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...] reordered along N by idx [B, N]."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx]


class SerializedDepthwiseConv(nn.Module):
    """Depthwise conv along the serialized order, 'SAME' padding."""

    def __init__(self, channels: int, kernel: int = 3):
        super().__init__()
        self.Conv_0 = nn.Conv1d(channels, channels, kernel, groups=channels,
                                padding=kernel // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:    # [B, N, C]
        return self.Conv_0(x.transpose(1, 2)).transpose(1, 2)


class KnnCPE(nn.Module):
    """3D-neighbourhood positional encoding: y_i = mean_j w(p_j - p_i) * x_j."""

    def __init__(self, channels: int, hidden: int = 16):
        super().__init__()
        self.Dense_0 = nn.Linear(4, hidden)
        self.Dense_1 = nn.Linear(hidden, channels)

    def forward(self, x, nbr_idx, rel):
        h = knn_gather(x, nbr_idx)                              # [B,N,k,C]
        w = self.Dense_1(_gelu(self.Dense_0(rel)))
        return torch.mean(h * w, dim=2)


def cpe_neighbors(xyz: torch.Tensor, k: int = 8):
    """kNN indices + mean-distance-normalised relative offsets for `KnnCPE`."""
    _, idx = knn(xyz, xyz, k)
    rel = knn_gather(xyz, idx) - xyz[:, :, None, :]
    dist = torch.sqrt(torch.sum(rel * rel, dim=-1, keepdim=True) + 1e-12)
    scale = torch.mean(dist, dim=(1, 2), keepdim=True) + 1e-6
    return idx, torch.cat([rel, dist], dim=-1) / scale


class PatchAttention(nn.Module):
    """Multi-head attention within fixed-size serialized patches."""

    def __init__(self, channels: int, num_heads: int, patch_size: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.channels, self.num_heads, self.patch_size = channels, num_heads, patch_size
        self.Dense_0 = nn.Linear(channels, 3 * channels, bias=qkv_bias)
        self.Dense_1 = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:    # [B, N, C] serialized
        B, N, C = x.shape
        K = min(self.patch_size, N)
        H = self.num_heads
        d = C // H
        R = B * (N // K)
        qkv = self.Dense_0(x).reshape(R, K, 3, H, d)
        out = PatchAttentionFunction.apply(qkv, d ** -0.5)   # [R, K, H, d]
        return self.Dense_1(out.reshape(B, N, C))


class PTv3Mlp(nn.Module):
    def __init__(self, channels: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.Dense_0 = nn.Linear(channels, int(channels * mlp_ratio))
        self.Dense_1 = nn.Linear(int(channels * mlp_ratio), channels)

    def forward(self, x):
        return self.Dense_1(_gelu(self.Dense_0(x)))


class PTv3Block(nn.Module):
    """CPE + pre-norm patch attention + pre-norm MLP."""

    def __init__(self, channels: int, num_heads: int, patch_size: int,
                 mlp_ratio: float = 4.0, cpe: str = 'curve'):
        super().__init__()
        self.cpe = cpe
        if cpe == 'knn':
            self.KnnCPE_0 = KnnCPE(channels)
        elif cpe == 'curve':
            self.SerializedDepthwiseConv_0 = SerializedDepthwiseConv(channels)
        elif cpe != 'none':
            raise ValueError(f'unknown cpe {cpe!r}')
        norms = 3 if cpe != 'none' else 2
        if cpe != 'none':
            self.Dense_0 = nn.Linear(channels, channels)
        for j in range(norms):
            self.add_module(f'LayerNorm_{j}', nn.LayerNorm(channels, eps=1e-2))
        self._attn_norm = f'LayerNorm_{norms - 2}'
        self._mlp_norm = f'LayerNorm_{norms - 1}'
        self.PatchAttention_0 = PatchAttention(channels, num_heads, patch_size)
        self.PTv3Mlp_0 = PTv3Mlp(channels, mlp_ratio)

    def forward(self, x, nbr_idx=None, rel=None):
        if self.cpe == 'knn':
            cpe = self.KnnCPE_0(x, nbr_idx, rel)
        elif self.cpe == 'curve':
            cpe = self.SerializedDepthwiseConv_0(x)
        else:
            cpe = None
        if cpe is not None:
            x = x + self.LayerNorm_0(self.Dense_0(cpe))
        x = x + self.PatchAttention_0(getattr(self, self._attn_norm)(x))
        x = x + self.PTv3Mlp_0(getattr(self, self._mlp_norm)(x))
        return x


class PointTransformerEncoder(nn.Module):
    """Encoder-only PTv3 with channel-preserving stage transitions.

    Input xyz [B, N, 3] and feat [B, N, in_channels]; output
    [B, N, channels] in the input's point order.
    """

    def __init__(self, in_channels: int, channels: int,
                 depths: Sequence[int] = (2, 2, 2),
                 num_heads: Sequence[int] = (2, 4, 8), patch_size: int = 256,
                 mlp_ratio: float = 4.0, grid_size: float = 0.01,
                 cpe: str = 'curve'):
        super().__init__()
        self.depths, self.patch_size = tuple(depths), patch_size
        self.grid_size, self.cpe = grid_size, cpe
        self.SerializedDepthwiseConv_0 = SerializedDepthwiseConv(in_channels, kernel=5)
        self.Dense_0 = nn.Linear(in_channels, channels)
        self.BatchNorm_0 = BatchNorm(channels, eps=1e-2, momentum=0.01)
        for s in range(1, len(depths)):
            self.add_module(f'Dense_{s}', nn.Linear(channels, channels))
            self.add_module(f'BatchNorm_{s}', BatchNorm(channels))
        n = 0
        for s, depth in enumerate(depths):
            for _ in range(depth):
                self.add_module(f'PTv3Block_{n}', PTv3Block(
                    channels, num_heads[s], patch_size, mlp_ratio, cpe=cpe))
                n += 1

    def forward(self, xyz: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        N = xyz.shape[1]
        if N % min(self.patch_size, N) != 0:
            raise ValueError(
                f'PointTransformerEncoder patch_size={self.patch_size} must '
                f'divide the point count {N}')
        order, inverse = serialization.serialize(xyz, self.grid_size)
        x = _take_rows(feat, order)
        nbr_idx = rel = None
        if self.cpe == 'knn':
            nbr_idx, rel = cpe_neighbors(_take_rows(xyz, order))

        x = self.SerializedDepthwiseConv_0(x)
        x = _gelu(self.BatchNorm_0(self.Dense_0(x)))
        n = 0
        for s, depth in enumerate(self.depths):
            if s > 0:
                x = getattr(self, f'Dense_{s}')(x)
                x = _gelu(getattr(self, f'BatchNorm_{s}')(x))
            for _ in range(depth):
                x = getattr(self, f'PTv3Block_{n}')(x, nbr_idx, rel)
                n += 1
        return _take_rows(x, inverse)
