"""Space-filling-curve serialization of point clouds (port of
`pcd_reg_hregnet_tpu/ops/serialization.py`): z-order here, Hilbert in
`ops/hilbert.py`.

The JAX package orders by two uint32 keys (hi, lo) with a lexsort; here the
same code (60 bits for z-order, 48 for Hilbert) is one int64 key, ordered
by a stable sort, so ties keep their input order exactly as the lexsort
does.
"""
from __future__ import annotations

import torch


def _part1by2_10(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x so there are 2 zero bits between each."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def z_order_keys(grid_coord: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Morton keys (hi, lo) for integer grid coords [..., 3], 20 bits an
    axis, x in the least-significant interleave slot."""
    g = grid_coord.long()
    x, y, z = g[..., 0], g[..., 1], g[..., 2]
    lo = _part1by2_10(x) | (_part1by2_10(y) << 1) | (_part1by2_10(z) << 2)
    hi = (_part1by2_10(x >> 10) | (_part1by2_10(y >> 10) << 1)
          | (_part1by2_10(z >> 10) << 2))
    return hi, lo


def _unpart1by2_10(x: torch.Tensor) -> torch.Tensor:
    """Inverse of `_part1by2_10`: compact every 3rd bit into the low 10."""
    x = x & 0x9249249
    x = (x | (x >> 2)) & 0x30C30C3
    x = (x | (x >> 4)) & 0x300F00F
    x = (x | (x >> 8)) & 0x30000FF
    x = (x | (x >> 16)) & 0x3FF
    return x


def z_order_decode(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Invert `z_order_keys`: (hi, lo) -> grid coords [..., 3] int32."""
    hi, lo = hi.long(), lo.long()
    axes = [_unpart1by2_10(lo >> s) | (_unpart1by2_10(hi >> s) << 10) for s in range(3)]
    return torch.stack(axes, dim=-1).to(torch.int32)


def grid_coords(xyz: torch.Tensor, grid_size: float) -> torch.Tensor:
    """Voxelize to non-negative integer grid coords per cloud [B, N, 3]."""
    mins = torch.amin(xyz, dim=1, keepdim=True)
    return torch.floor((xyz - mins) / grid_size).to(torch.int32)


def sort_keys(key: torch.Tensor):
    """(order_idx, inverse_idx) [B, N] int64 of a stable sort of each row of
    `key` [B, N]."""
    perm = torch.sort(key, dim=-1, stable=True).indices
    inv = torch.empty_like(perm)
    inv.scatter_(1, perm, torch.arange(perm.shape[1], device=perm.device)
                 .expand_as(perm).contiguous())
    return perm, inv


ORDERS = ('z', 'z-trans', 'hilbert', 'hilbert-trans')


def serialize(xyz: torch.Tensor, grid_size: float = 0.01, order: str = 'z'):
    """Serialization permutation per cloud, in one of `ORDERS` ('-trans':
    the axes reversed before encoding).

    Returns (order_idx [B, N], inverse_idx [B, N]) int64 with
    ``sorted = x[order_idx]`` and ``x = sorted[inverse_idx]``.
    """
    if order not in ORDERS:
        raise ValueError(f'unsupported serialization order: {order}')
    if order.startswith('hilbert'):
        from .hilbert import serialize_hilbert
        return serialize_hilbert(xyz, grid_size, order)
    g = grid_coords(xyz, grid_size)
    if order == 'z-trans':
        g = g.flip(-1)
    hi, lo = z_order_keys(g)
    return sort_keys((hi << 30) | lo)
