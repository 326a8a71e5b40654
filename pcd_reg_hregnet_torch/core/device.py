"""Device resolution for the port's entry points."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device = 'cuda') -> torch.device:
    """Return `device` as a `torch.device`, refusing CUDA without a card.

    Entry points default to ``'cuda'``; without a card they raise unless the
    caller passes ``device='cpu'`` explicitly.
    """
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {str(dev)!r} requested but torch.cuda.is_available() is '
            "False; pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def fp32_numerics():
    """Full-f32 matmuls and convolutions inside the block: no TF32.

    cuDNN defaults to TF32 for f32 convolutions (the PTv3 depthwise conv);
    geometry (kNN distances, Kabsch, SE(3)) must stay full f32, as the JAX
    package's ``precision='highest'`` keeps it.  The model's forward runs
    under this, and so does the whole train step
    (`train/loop.py::make_train_step`): forward, `loss.backward()` (whose
    convolution and matmul gradients read these flags when they run, after
    the forward's block has exited) and the optimizer step.  The caller's
    settings come back on exit, so nothing else in the process is changed.
    bf16 matmuls (the bf16 compute path) also lose cuBLAS's reduced-precision
    reductions: XLA sums bf16 products in f32.
    """
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = (matmul.allow_tf32, cudnn.allow_tf32, matmul.allow_bf16_reduced_precision_reduction)
    matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (matmul.allow_tf32, cudnn.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction) = prev
