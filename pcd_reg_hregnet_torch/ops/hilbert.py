"""Hilbert-curve serialization (port of `pcd_reg_hregnet_tpu/ops/hilbert.py`).

The JAX package runs Skilling's transform on boolean bit planes and packs
the 3 x 16-bit index into two uint32 keys (hi: top 24 bits, lo: bottom 24)
for a lexsort.  Here the same transform runs on the integer coordinates
(one masked swap per bit and axis, as in Skilling's `AxestoTranspose`), the
index is one int64, and a stable sort orders it: the same permutation as
the lexsort on (hi, lo).
"""
from __future__ import annotations

import torch

from .serialization import grid_coords, sort_keys

NUM_DIMS = 3


def _gray_to_binary(g: torch.Tensor, nbits: int) -> torch.Tensor:
    """Prefix xor from the most significant of `nbits` bits."""
    shift = 1
    while shift < nbits:
        g = g ^ (g >> shift)
        shift *= 2
    return g


def hilbert_index(grid_coord: torch.Tensor, num_bits: int = 16) -> torch.Tensor:
    """Hilbert index [...] int64 of integer grid coords [..., 3] in
    [0, 2**num_bits)."""
    if num_bits > 16:
        raise ValueError('the index of 3 x num_bits bits is split at 24 bits; num_bits <= 16')
    X = [grid_coord[..., i].long() for i in range(NUM_DIMS)]
    for bit in range(num_bits - 1, 0, -1):      # the lower bits below each bit, MSB first
        Q = 1 << bit
        P = Q - 1
        for i in range(NUM_DIMS):
            set_ = (X[i] & Q) != 0
            t = torch.where(set_, torch.zeros_like(X[0]), (X[0] ^ X[i]) & P)
            if i:
                X[i] = X[i] ^ t
            X[0] = torch.where(set_, X[0] ^ P, X[0] ^ t)
    gray = torch.zeros_like(X[0])
    for bit in range(num_bits - 1, -1, -1):     # interleave, axis 0 most significant
        for i in range(NUM_DIMS):
            gray = (gray << 1) | ((X[i] >> bit) & 1)
    return _gray_to_binary(gray, NUM_DIMS * num_bits)


def hilbert_keys(grid_coord: torch.Tensor, num_bits: int = 16):
    """(hi, lo) int64 keys as the JAX package splits the index: hi the top
    3 * num_bits - 24 bits, lo the bottom 24."""
    h = hilbert_index(grid_coord, num_bits)
    nlo = min(NUM_DIMS * num_bits, 24)
    return h >> nlo, h & ((1 << nlo) - 1)


def hilbert_decode(hi: torch.Tensor, lo: torch.Tensor, num_bits: int = 16) -> torch.Tensor:
    """Invert `hilbert_keys`: (hi, lo) -> grid coords [..., 3] int32."""
    nlo = min(NUM_DIMS * num_bits, 24)
    h = (hi.long() << nlo) | lo.long()
    gray = h ^ (h >> 1)
    X = [torch.zeros_like(h) for _ in range(NUM_DIMS)]
    for bit in range(num_bits):                 # de-interleave
        for i in range(NUM_DIMS):
            X[i] = X[i] | (((gray >> (NUM_DIMS * bit + NUM_DIMS - 1 - i)) & 1) << bit)
    for bit in range(1, num_bits):              # Skilling's passes in reverse
        Q = 1 << bit
        P = Q - 1
        for i in range(NUM_DIMS - 1, -1, -1):
            set_ = (X[i] & Q) != 0
            t = torch.where(set_, torch.zeros_like(X[0]), (X[0] ^ X[i]) & P)
            if i:
                X[i] = X[i] ^ t
            X[0] = torch.where(set_, X[0] ^ P, X[0] ^ t)
    return torch.stack(X, dim=-1).to(torch.int32)


def serialize_hilbert(xyz: torch.Tensor, grid_size: float = 0.01, order: str = 'hilbert',
                      num_bits: int = 16):
    """Hilbert serialization permutation per cloud (cf.
    `serialization.serialize`): grid coords clipped to num_bits bits."""
    g = torch.clamp(grid_coords(xyz, grid_size), 0, (1 << num_bits) - 1)
    if order == 'hilbert-trans':
        g = g.flip(-1)
    elif order != 'hilbert':
        raise ValueError(f'unsupported hilbert order: {order}')
    return sort_keys(hilbert_index(g, num_bits))
