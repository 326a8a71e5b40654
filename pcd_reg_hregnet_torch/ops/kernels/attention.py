"""Patch attention forward: CUDA kernel K3 and its plain version.

Replaces `pcd_reg_hregnet_tpu/ops/pallas/attention.py::_attn_kernel`; the
kernel is `csrc/attention.cu`.  Layout is the JAX function's:
q, k, v [R, H, K, d] -> out [R, H, K, d] in q's dtype, softmax in f32.
Forward only: the backward kernel comes with the training path.
"""
from __future__ import annotations

import torch

HEAD_DIMS = (8, 16, 32, 64, 128)
MAX_SMEM_BYTES = 232448   # K and V staged in shared memory as f32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def patch_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch attention with the JAX `_dense_reference` numerics."""
    s = torch.einsum('rhkd,rhmd->rhkm', q.float() * scale, k.float())
    p = torch.softmax(s, dim=-1)
    return torch.einsum('rhkm,rhmd->rhkd', p, v.float()).to(q.dtype)


def _launch(q, k, v, scale):
    from .build import library
    if q.dim() != 4:
        raise ValueError(f'patch_attention takes [R, H, K, d], got {tuple(q.shape)}')
    for name, t in (('k', k), ('v', v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f'patch_attention: {name} {t.dtype} {tuple(t.shape)} '
                             f'on {t.device} does not match q {q.dtype} '
                             f'{tuple(q.shape)} on {q.device}')
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f'patch_attention kernel takes f32 or bf16, got {q.dtype}')
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError('patch_attention kernel takes contiguous q, k, v')
    R, H, K, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f'patch_attention kernel takes head dims {HEAD_DIMS}, got {d}')
    if 2 * K * d * 4 > MAX_SMEM_BYTES:
        raise ValueError(f'patch_attention kernel: K={K}, d={d} needs '
                         f'{2 * K * d * 4} bytes of shared memory '
                         f'(max {MAX_SMEM_BYTES})')
    out = torch.empty_like(q)
    lib = library()
    with torch.cuda.device(q.device):
        err = lib.lib.pcdreg_patch_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            R, H, K, d, float(scale), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    lib.check(err, 'pcdreg_patch_attention')
    return out


def patch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Fused multi-head attention over independent patches.

    q, k, v: [R, H, K, d].  Kernel K3 on CUDA tensors, the plain version on
    CPU tensors.
    """
    if q.device.type == 'cpu':
        return patch_attention_reference(q, k, v, scale)
    if q.device.type != 'cuda':
        raise ValueError(f'patch_attention: unsupported device {q.device}')
    out = _launch(q, k, v, scale)
    patch_attention.launches += 1
    return out


patch_attention.launches = 0
