"""How far the port's bf16 train step lies from the JAX package's, on the CPU,
at full width: the yardstick for `chip_smoke.py`'s bf16_train limits.

One `reg_v11` train step (`model_v6`, 8096-point clouds, levels
1024/512/256, PTv3 depths (2, 2, 2)) in `compute_dtype='bfloat16'` from the
trained flagship (`port_assets/r5_v11_knn_best_rre.npz`) on the first
batch of the port's synthetic train split, in both packages: JAX's
`jax.grad` of its objective in train mode and the port's
`train.loop.make_train_step`.  Prints, as one JSON line: the loss of each
and their relative difference; the largest |gradient difference| of any
leaf against the port's global gradient norm (the measure the card's
kernels-vs-plain step check uses); whether both picked the same keypoints
at every level; and the same two numbers between the port's step with its
kernels' plain versions and with the JAX dense path's attention rounding
(p and q*scale in bf16), the stated difference between the packages.

With `--kernel-rounding N` it measures instead what the card's bf16_train
check compares, the step with K3/K3b against the step with their plain
versions, on the CPU: over the first N train batches at `--batch`, the
port's bf16 step with the plain attention and backward, and with the
kernels' rounding emulated (K3's bf16 path rounds the unnormalised
probabilities to bf16 as the operand of P.V, and K3b rounds p and dS to
bf16 as operands, as FlashAttention-2 does); per batch the loss
difference and the largest |gradient difference| against the global
norm, and beside them the same two numbers between the plain
step on the batch and on the batch with every coordinate one f32 ulp up
(`nudged_vs_plain`: how far the bf16 step moves for a last-bit change).

    JAX_PLATFORMS=cpu python tools/bf16_step_spread.py [--batch 2] [--threads 8]
    python tools/bf16_step_spread.py --kernel-rounding 4 --batch 8
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def keypoints(ret) -> dict:
    return {f'{side}_{lvl}': ret[f'{side}_feats'][f'xyz_{lvl}']
            for side in ('src', 'dst') for lvl in (1, 2, 3)}


def port_step(cfg, state_dict, batch, torch):
    """The port's bf16 train step from `state_dict`: (loss, gradients,
    keypoints)."""
    from pcd_reg_hregnet_torch.train import loop
    from pcd_reg_hregnet_torch.train.objective import RegistrationObjective
    from pcd_reg_hregnet_torch.train.optimizer import Optimizer
    obj = RegistrationObjective(cfg)
    obj.model.load_state_dict(state_dict, strict=True)
    state = loop.TrainState(obj, Optimizer(cfg.train, obj.named_parameters(), 100))
    kps = {}
    obj.model.register_forward_hook(lambda m, a, ret: kps.update(
        {k: v.detach().numpy().copy() for k, v in keypoints(ret).items()}))
    metrics = loop.make_train_step()(state, {k: torch.from_numpy(batch[k]) for k in loop.USED})
    grads = {n[len('model.'):]: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
             for n, p in obj.named_parameters()}
    return float(metrics['loss']), grads, kps


def xla_attention(torch):
    """The JAX model's dense attention path at these patch sizes, in q's
    dtype: q*scale and p rounded to it."""
    def attention(q, k, v, scale):
        s = torch.einsum('rhkd,rhmd->rhkm', (q * scale).to(q.dtype).float(), k.float())
        p = torch.softmax(s, dim=-1).to(v.dtype)
        return torch.einsum('rhkm,rhmd->rhkd', p.float(), v.float()).to(q.dtype)
    return attention


def kernel_rounding(torch):
    """The plain attention and backward with the bf16 kernels' roundings:
    (forward, backward) in place of `patch_attention_reference` and
    `patch_attention_backward_reference`."""
    def forward(q, k, v, scale):
        s = torch.einsum('rhkd,rhmd->rhkm', q.float() * scale, k.float())
        e = torch.exp(s - s.amax(-1, keepdim=True))
        o = torch.einsum('rhkm,rhmd->rhkd', e.to(q.dtype).float(), v.float())
        return (o / e.sum(-1, keepdim=True)).to(q.dtype)

    def backward(q, k, v, g, scale):
        qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
        p = torch.softmax(torch.einsum('rhkd,rhmd->rhkm', qf * scale, kf), dim=-1)
        pb = p.to(q.dtype).float()
        dv = torch.einsum('rhkm,rhkd->rhmd', pb, gf)
        dp = torch.einsum('rhkd,rhmd->rhkm', gf, vf)
        ds = (p * (dp - torch.sum(gf * forward(q, k, v, scale).float(), -1, keepdim=True)))
        dsb = ds.to(q.dtype).float()
        dq = torch.einsum('rhkm,rhmd->rhkd', dsb, kf) * scale
        dk = torch.einsum('rhkm,rhkd->rhmd', dsb, qf) * scale
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    return forward, backward


def kernel_rounding_spread(args, torch) -> int:
    """`--kernel-rounding N`: the plain attention against the kernels'
    rounding, one bf16 step per batch."""
    import numpy as np

    from pcd_reg_hregnet_torch.data import batch_iterator, load_dataset
    from pcd_reg_hregnet_torch.ops.kernels import attention as kattn
    from pcd_reg_hregnet_torch.utils import checkpoint
    torch.set_num_threads(args.threads)
    cfg, state_dict, _ = checkpoint.read(checkpoint.FLAGSHIP)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype='bfloat16'))
    it = batch_iterator(load_dataset(cfg.data, 'train'), args.batch, shuffle=True,
                        seed=cfg.train.seed, epoch=0)
    plain = (kattn.patch_attention_reference, kattn.patch_attention_backward_reference)
    rows = []
    for _ in range(args.kernel_rounding):
        batch = next(it)
        a = port_step(cfg, state_dict, batch, torch)
        kattn.patch_attention_reference, kattn.patch_attention_backward_reference = \
            kernel_rounding(torch)
        try:
            b = port_step(cfg, state_dict, batch, torch)
        finally:
            kattn.patch_attention_reference, kattn.patch_attention_backward_reference = plain
        row = compare(b, a)
        nudged = {k: (np.nextafter(x, np.inf).astype(np.float32)
                      if k in ('uncalibed_pcd', 'pcd_left') else x) for k, x in batch.items()}
        row['nudged_vs_plain'] = compare(port_step(cfg, state_dict, nudged, torch), a)
        rows.append(row)
    print(json.dumps({'batch': args.batch, 'kernel_rounding_vs_plain': rows,
                      'max_loss_rel': max(r['loss_rel'] for r in rows),
                      'max_dgrad_of_norm': max(r['max_dgrad_of_norm'] for r in rows),
                      'torch': torch.__version__}))
    return 0


def compare(a, b) -> dict:
    (la, ga, ka), (lb, gb, kb) = a, b
    norm = sum(float((g.double() ** 2).sum()) for g in ga.values()) ** 0.5
    worst = max(float((ga[n].double() - gb[n].double()).abs().max()) for n in ga)
    return {'loss': [la, lb], 'loss_rel': abs(la - lb) / abs(lb),
            'max_dgrad_of_norm': worst / norm,
            'same_keypoints': all(float(abs(ka[k] - kb[k]).max()) < 1e-3 for k in ka)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--batch', type=int, default=2)
    ap.add_argument('--threads', type=int, default=8)
    ap.add_argument('--kernel-rounding', type=int, default=0, metavar='N',
                    help='measure the kernels\' rounding against the plain versions over '
                         'N batches (no JAX) instead')
    args = ap.parse_args()
    if args.kernel_rounding:
        import torch
        return kernel_rounding_spread(args, torch)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from pcd_reg_hregnet_tpu.core.config import Config as JConfig
    from pcd_reg_hregnet_tpu.train.objective import RegistrationObjective as JObjective
    from pcd_reg_hregnet_torch.data import batch_iterator, load_dataset
    from pcd_reg_hregnet_torch.ops.kernels import attention as kattn
    from pcd_reg_hregnet_torch.utils import checkpoint

    if jax.devices()[0].platform != 'cpu':
        raise RuntimeError('run with JAX_PLATFORMS=cpu: the yardstick is the CPU step')
    torch.set_num_threads(args.threads)
    cfg, state_dict, _ = checkpoint.read(checkpoint.FLAGSHIP)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype='bfloat16'))
    batch = next(batch_iterator(load_dataset(cfg.data, 'train'), args.batch, shuffle=True,
                                seed=cfg.train.seed, epoch=0))
    variables = checkpoint.load_variables(checkpoint.FLAGSHIP)
    jcfg = JConfig.from_json(cfg.to_json())
    jobj = JObjective(jcfg)

    @jax.jit
    def jgrad(params, batch_stats, batch):
        def loss_fn(p):
            (loss, _, ret), _ = jobj.apply({'params': {'model': p},
                                            'batch_stats': {'model': batch_stats}},
                                           batch, train=True, mutable=['batch_stats'])
            return loss, keypoints(ret)
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    t = time.perf_counter()
    (jloss, jkps), jgrads = jgrad(variables['params'], variables['batch_stats'],
                                  {k: jnp.asarray(v) for k, v in batch.items()})
    from pcd_reg_hregnet_torch.utils.convert import from_flax
    jax_run = (float(jloss), from_flax({'params': jax.tree.map(np.asarray, jgrads)}),
               {k: np.asarray(v) for k, v in jkps.items()})
    jax_s = time.perf_counter() - t
    t = time.perf_counter()
    port = port_step(cfg, state_dict, batch, torch)
    plain = kattn.patch_attention_reference
    kattn.patch_attention_reference = xla_attention(torch)
    try:
        port_xla = port_step(cfg, state_dict, batch, torch)
    finally:
        kattn.patch_attention_reference = plain
    port_s = time.perf_counter() - t
    print(json.dumps({'batch': args.batch, 'points': cfg.data.pcd_min_samples,
                      'port_vs_jax': compare(port, jax_run),
                      'port_vs_port_with_xla_attention': compare(port, port_xla),
                      'jax_s': round(jax_s, 1), 'port_s': round(port_s, 1),
                      'jax': jax.__version__, 'torch': torch.__version__}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
