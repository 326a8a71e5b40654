"""The port's train step against the JAX package's (CPU).

* K3's backward (`patch_attention_backward_reference` and
  `PatchAttentionFunction`) against `jax.grad` of the Pallas
  `patch_attention` in interpret mode and of `_dense_reference`, within the
  JAX package's own gradient tolerance (rtol 1e-4, atol 1e-5): the same
  formulas in f32, other summation orders.
* The attention gradient reaches `Dense_0` of a PTv3 block in train mode as
  in JAX, and `patch_attention(out=...)` refuses inputs that require grad.
* Train-mode `BatchNorm` against `flax.linen.BatchNorm`: output and running
  statistics after two updates within 1e-6 (the same formulas in f32).
* The `reg_v11` train step at small levels (64/32/16 keypoints from 256
  points, PTv3 depths (1, 1)), both packages starting from the same
  variables: every gradient leaf at step 1 within rtol 1e-3 / atol 1e-6;
  over 3 steps on 3 batches the loss within 1e-4 relative, every parameter
  within 1e-5 + 1e-3 relative and the BatchNorm statistics within 1e-5.
  The two packages must pick the same keypoints at every level (a
  weighted-FPS near-tie would make a difference real, so the test would say
  so and fail).
* Checkpoints, resume and `fit` on the CPU; the train command resumes
  with the checkpoint's model config (compute dtype included), the options
  on top, as the JAX CLI's `train --resume` does.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from jax.experimental.pallas import tpu as pltpu

from pcd_reg_hregnet_tpu.models import ptv3 as jptv3
from pcd_reg_hregnet_tpu.ops.pallas import attention as jattn
from pcd_reg_hregnet_tpu.train import experiments as jexperiments
from pcd_reg_hregnet_tpu.train.objective import RegistrationObjective as JObjective
from pcd_reg_hregnet_tpu.train.optimizer import make_optimizer as jmake_optimizer
from pcd_reg_hregnet_torch.data import PairDataset, SyntheticPairSource
from pcd_reg_hregnet_torch.geometry import se3
from pcd_reg_hregnet_torch.models import layers, ptv3
from pcd_reg_hregnet_torch.ops.kernels import attention as kattn
from pcd_reg_hregnet_torch.train import experiments, loop
from pcd_reg_hregnet_torch.train.objective import RegistrationObjective
from pcd_reg_hregnet_torch.train.optimizer import Optimizer
from pcd_reg_hregnet_torch.utils import checkpoint
from pcd_reg_hregnet_torch.utils.convert import from_flax
from test_torch_model import J_LEVELS, LEVELS, SMALL, _rand, _variables

torch.set_num_threads(1)

# the forward's nine (K, d) per tower at R = 2, then ragged K and d, K = 1
BWD_SHAPES = [(2, h, kk, c // h) for kk, c in ((256, 64), (128, 128), (64, 256))
              for h in (2, 4, 8)] + [(2, 3, 100, 5), (2, 2, 1, 8)]
BWD_TOL = dict(rtol=1e-4, atol=1e-5)


def _qkvg(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


def _jax_grads(q, k, v, g, scale, pallas: bool):
    """dq, dk, dv of sum(g * attention) by `jax.grad`."""
    if pallas:
        def fn(a, b, c):
            return jnp.sum(jattn.patch_attention(a, b, c, scale) * g)
        with pltpu.force_tpu_interpret_mode():
            return [np.asarray(x) for x in jax.grad(fn, argnums=(0, 1, 2))(q, k, v)]

    def fn(a, b, c):
        return jnp.sum(jattn._dense_reference(a, b, c, scale) * g)
    return [np.asarray(x) for x in jax.grad(fn, argnums=(0, 1, 2))(q, k, v)]


class TestAttentionBackward:
    @pytest.mark.parametrize('shape', BWD_SHAPES)
    def test_plain_backward_and_function_match_jax_dense(self, shape):
        q, k, v, g = _qkvg(0, shape)
        scale = shape[-1] ** -0.5
        want = _jax_grads(q, k, v, g, scale, pallas=False)
        got = kattn.patch_attention_backward_reference(*map(torch.from_numpy, (q, k, v, g)),
                                                       scale)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b, **BWD_TOL)
        # the autograd Function on a packed [R, K, 3, H, d] projection
        qkv = torch.from_numpy(np.stack([q, k, v], 0)).permute(1, 3, 0, 2, 4).contiguous()
        qkv.requires_grad_()
        out = kattn.PatchAttentionFunction.apply(qkv, scale)
        assert out.grad_fn is not None and 'PatchAttentionFunction' in type(out.grad_fn).__name__
        out.backward(torch.from_numpy(g).transpose(1, 2))
        for a, b in zip(kattn.unpack_qkv(qkv.grad), want):
            np.testing.assert_allclose(a.numpy(), b, **BWD_TOL)

    @pytest.mark.parametrize('shape', [BWD_SHAPES[0], BWD_SHAPES[4], BWD_SHAPES[8],
                                       BWD_SHAPES[9], BWD_SHAPES[10]])
    def test_plain_backward_matches_pallas_interpret(self, shape):
        q, k, v, g = _qkvg(1, shape)
        scale = shape[-1] ** -0.5
        want = _jax_grads(q, k, v, g, scale, pallas=True)
        got = kattn.patch_attention_backward_reference(*map(torch.from_numpy, (q, k, v, g)),
                                                       scale)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b, **BWD_TOL)

    def test_strided_inputs_and_outputs(self):
        """Views of a [R, K, 3, H, d] projection in, views of one gradient
        buffer out, g a transposed view: the same as contiguous tensors."""
        R, H, K, d = 2, 4, 32, 16
        rng = np.random.default_rng(2)
        qkv = torch.from_numpy(rng.normal(size=(R, K, 3, H, d)).astype(np.float32))
        q, k, v = kattn.unpack_qkv(qkv)
        g = torch.from_numpy(rng.normal(size=(R, K, H, d)).astype(np.float32)).transpose(1, 2)
        o = kattn.patch_attention(q, k, v, d ** -0.5)
        buf = torch.empty_like(qkv)
        got = kattn.patch_attention_backward(q, k, v, o, g, d ** -0.5,
                                             out=kattn.unpack_qkv(buf))
        assert all(t.data_ptr() == buf[:, :, j].data_ptr() for j, t in enumerate(got))
        want = _jax_grads(*(t.contiguous().numpy() for t in (q, k, v, g)), d ** -0.5,
                          pallas=False)
        for a, b in zip(kattn.unpack_qkv(buf), want):
            np.testing.assert_allclose(a.numpy(), b, **BWD_TOL)

    @pytest.mark.parametrize('shape', [BWD_SHAPES[0], BWD_SHAPES[4], BWD_SHAPES[8],
                                       BWD_SHAPES[9], BWD_SHAPES[10]])
    def test_function_saves_the_log_sum_exp_of_the_jax_scores(self, shape):
        """The forward keeps each query row's log-sum-exp for K3b: on the
        CPU the plain one, equal to `jax.nn.logsumexp` of `_dense_reference`'s
        scores (f32, other summation orders)."""
        q, k, v, _ = _qkvg(4, shape)
        scale = shape[-1] ** -0.5
        s = jnp.einsum('rhkd,rhmd->rhkm', jnp.asarray(q) * scale, jnp.asarray(k))
        want = np.asarray(jax.nn.logsumexp(s, axis=-1))
        qkv = torch.from_numpy(np.stack([q, k, v], 0)).permute(1, 3, 0, 2, 4).contiguous()
        out = kattn.PatchAttentionFunction.apply(qkv.requires_grad_(), scale)
        saved_qkv, saved_out, lse = out.grad_fn.saved_tensors
        assert lse.shape == shape[:3] and lse.dtype == torch.float32
        np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-6)
        buf = torch.empty(shape[:3])
        kattn.patch_attention(*map(torch.from_numpy, (q, k, v)), scale, lse=buf)
        assert torch.equal(buf, lse)
        # the plain backward reads no lse: the same gradients with it and without
        g = torch.from_numpy(_qkvg(5, shape)[0])
        args = (*map(torch.from_numpy, (q, k, v)), saved_out.transpose(1, 2), g, scale)
        for a, b in zip(kattn.patch_attention_backward(*args, lse=lse),
                        kattn.patch_attention_backward(*args)):
            assert torch.equal(a, b)

    def test_no_log_sum_exp_without_a_gradient(self):
        qkv = torch.from_numpy(np.stack(_qkvg(6, (2, 2, 16, 8))[:3], 0)).permute(1, 3, 0, 2, 4)
        out = kattn.PatchAttentionFunction.apply(qkv.contiguous(), 0.5)
        assert out.grad_fn is None   # no graph, and the forward wrote no lse
        with pytest.raises(ValueError, match='lse'):
            kattn.patch_attention(*kattn.unpack_qkv(qkv), 0.5, lse=torch.empty(2, 16, 2))

    def test_cpu_wrapper_counts_no_launch_and_validates(self, monkeypatch):
        q, k, v, g = map(torch.from_numpy, _qkvg(3, (2, 2, 16, 8)))
        n = kattn.patch_attention_backward.launches
        kattn.patch_attention_backward(q, k, v, q, g, 0.5)
        assert kattn.patch_attention_backward.launches == n

        def no_build():
            raise AssertionError('built before validating')
        monkeypatch.setattr(kattn.build, 'library', no_build)
        lse = torch.zeros(2, 2, 16)
        with pytest.raises(ValueError, match='f32 or bf16'):
            kattn._launch_backward(*(t.half() for t in (q, k, v, q, g)), 0.5, None, lse)
        with pytest.raises(ValueError, match='contiguous last dim'):
            kattn._launch_backward(q, k, torch.zeros(2, 2, 16, 16)[..., ::2], q, g, 0.5, None,
                                   lse)
        with pytest.raises(ValueError, match='does not match'):
            kattn._launch_backward(q, k, v, q, torch.zeros(2, 2, 16, 4), 0.5, None, lse)
        with pytest.raises(ValueError, match='lse'):
            kattn._launch_backward(q, k, v, q, g, 0.5, None, None)


class TestAttentionGradient:
    def test_ptv3_block_attention_gradient_matches_jax(self):
        """Dense_0 of the attention (the qkv projection, upstream of K3) gets
        JAX's gradient through a PTv3 block in train mode, and the graph runs
        through `PatchAttentionFunction` (on the card, K3b)."""
        x = _rand(0, (2, 32, 16))
        jm = jptv3.PTv3Block(16, 2, 16, cpe='curve')
        v = _variables(jm, x)
        w = _rand(1, (2, 32, 16))

        def jloss(params):
            return jnp.sum(jm.apply({'params': params}, x) * w)
        jgrads = jax.grad(jloss)(v['params'])
        tm = ptv3.PTv3Block(16, 2, 16, cpe='curve')
        tm.load_state_dict(from_flax(v), strict=True)
        tm.train()
        torch.sum(tm(torch.from_numpy(x)) * torch.from_numpy(w)).backward()
        tgrads = {n: p.grad for n, p in tm.named_parameters()}
        want = from_flax({'params': jgrads})
        assert set(want) == set(tgrads)
        for name in want:
            np.testing.assert_allclose(tgrads[name].numpy(), want[name].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=name)
        assert float(tgrads['PatchAttention_0.Dense_0.weight'].abs().max()) > 0

    def test_attention_output_is_tracked(self):
        tm = ptv3.PatchAttention(16, 2, 16)
        out = tm(torch.from_numpy(_rand(2, (2, 32, 16))))
        fns, seen = [out.grad_fn], set()
        while fns:
            f = fns.pop()
            if f is None or f in seen:
                continue
            seen.add(f)
            fns.extend(n for n, _ in f.next_functions)
        assert any('PatchAttentionFunction' in type(f).__name__ for f in seen)

    def test_out_refused_for_inputs_that_require_grad(self):
        q, k, v = (torch.zeros(1, 2, 16, 8, requires_grad=True) for _ in range(3))
        with pytest.raises(RuntimeError, match='require grad'):
            kattn.patch_attention(q, k, v, 0.5, out=torch.empty(1, 2, 16, 8))
        with torch.no_grad():   # inference keeps its zero-copy output
            kattn.patch_attention(q, k, v, 0.5, out=torch.empty(1, 2, 16, 8))


class TestBatchNormTrain:
    @pytest.mark.parametrize('momentum,eps', [(0.9, 1e-5), (0.99, 1e-2)])
    def test_matches_flax_over_two_updates(self, momentum, eps):
        jm = nn.BatchNorm(use_running_average=False, momentum=momentum, epsilon=eps)
        x0 = _rand(0, (2, 16, 4, 8), -3, 5)
        v = _variables(jm, x0)
        tm = layers.BatchNorm(8, eps=eps, momentum=round(1 - momentum, 6))
        tm.load_state_dict(from_flax(v), strict=True)
        tm.train()
        stats = v['batch_stats']
        for seed in (1, 2):
            x = _rand(seed, (2, 16, 4, 8), -3, 5)
            y, mut = jm.apply({'params': v['params'], 'batch_stats': stats}, x,
                              mutable=['batch_stats'])
            stats = mut['batch_stats']
            got = tm(torch.from_numpy(x))
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), atol=1e-6, rtol=0)
            np.testing.assert_allclose(tm.running_mean.numpy(), np.asarray(stats['mean']),
                                       atol=1e-6, rtol=0)
            np.testing.assert_allclose(tm.running_var.numpy(), np.asarray(stats['var']),
                                       atol=1e-6, rtol=0)

    def test_eval_mode_unchanged(self):
        tm = layers.BatchNorm(8)
        tm.running_mean.uniform_(-1, 1)
        tm.running_var.uniform_(0.5, 2)
        x = torch.from_numpy(_rand(3, (2, 5, 8)))
        tm.eval()
        want = torch.nn.functional.batch_norm(x.reshape(-1, 8), tm.running_mean, tm.running_var,
                                              tm.weight, tm.bias, False, 0.1, 1e-5)
        assert torch.equal(tm(x), want.reshape(x.shape))


# --- the reg_v11 train step, both packages ---------------------------------

STEPS, BATCH, POINTS, STEPS_PER_EPOCH = 3, 2, 256, 100
TRAIN_OVER = dict(epochs=10)


def _configs():
    jcfg = jexperiments.experiment('reg_v11')
    jcfg = dataclasses.replace(
        jcfg, model=dataclasses.replace(jcfg.model, levels=J_LEVELS, **SMALL),
        train=dataclasses.replace(jcfg.train, **TRAIN_OVER))
    cfg = experiments.experiment('reg_v11')
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, levels=LEVELS, **SMALL),
        train=dataclasses.replace(cfg.train, **TRAIN_OVER))
    return jcfg, cfg


def _batches():
    """3 batches: random target clouds and decalibrated, noisy sources."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        dst = rng.uniform(-40, 40, (BATCH, POINTS, 3)).astype(np.float32)
        tw = np.concatenate([rng.uniform(-0.2, 0.2, (BATCH, 3)),
                             rng.uniform(-0.5, 0.5, (BATCH, 3))], 1).astype(np.float32)
        igt = se3.exp(torch.from_numpy(tw)).numpy()
        src = (np.einsum('bij,bnj->bni', igt[:, :3, :3], dst) + igt[:, None, :3, 3]
               + rng.normal(0, 0.01, dst.shape)).astype(np.float32)
        out.append({'uncalibed_pcd': src, 'pcd_left': dst, 'igt': igt})
    return out


def _keypoints(ret):
    return {f'{side}_{lvl}': ret[f'{side}_feats'][f'xyz_{lvl}']
            for side in ('src', 'dst') for lvl in (1, 2, 3)}


def _port_run(cfg, variables, batches, dtype):
    """3 port train steps from the flax variables in `dtype`: per step the
    gradients, metrics and keypoints; the final state_dict."""
    obj = RegistrationObjective(cfg)
    obj.model.load_state_dict(from_flax({'params': variables['params']['model'],
                                         'batch_stats': variables['batch_stats']['model']}),
                              strict=True)
    obj.to(dtype)
    state = loop.TrainState(obj, Optimizer(cfg.train, obj.named_parameters(), STEPS_PER_EPOCH))
    step = loop.make_train_step()
    out = []
    for batch in batches:
        kps = {}
        hook = obj.model.register_forward_hook(
            lambda m, a, ret: kps.update({k: v.detach().float().numpy().copy()
                                          for k, v in _keypoints(ret).items()}))
        metrics = step(state, {k: torch.from_numpy(batch[k]).to(dtype) for k in loop.USED})
        hook.remove()
        grads = {n[len('model.'):]: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                 for n, p in obj.named_parameters()}
        out.append((grads, {k: float(v) for k, v in metrics.items()}, kps))
    return out, obj.model.state_dict()


@pytest.fixture(scope='module')
def runs():
    """3 train steps in each package from the same variables (JAX's step is
    its `train/loop.py::make_train_step` body): per step the gradients,
    metrics and keypoints, and the final state.  The port also runs in
    float64, to measure how far f32 rounding alone moves each leaf."""
    jcfg, cfg = _configs()
    batches = _batches()
    jobj = JObjective(jcfg)
    variables = _variables(jobj, batches[0], seed=3, train=False)
    tx = jmake_optimizer(jcfg.train, STEPS_PER_EPOCH)

    @jax.jit
    def jstep(params, batch_stats, opt_state, batch):
        def loss_fn(p):
            (loss, metrics, ret), mut = jobj.apply({'params': p, 'batch_stats': batch_stats},
                                                   batch, train=True, mutable=['batch_stats'])
            return loss, (metrics, mut['batch_stats'], _keypoints(ret))
        grads, (metrics, new_bs, kps) = jax.grad(loss_fn, has_aux=True)(params)
        updates, new_opt = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_bs, new_opt, grads, metrics, kps

    params, bstats = variables['params'], variables['batch_stats']
    opt_state = tx.init(params)
    jax_out = []
    for batch in batches:
        params, bstats, opt_state, grads, metrics, kps = jstep(params, bstats, opt_state, batch)
        jax_out.append((from_flax({'params': jax.tree.map(np.asarray, grads)['model']}),
                        jax.tree.map(float, metrics), jax.tree.map(np.asarray, kps)))
    jax_final = from_flax({'params': params['model'], 'batch_stats': bstats['model']})
    port, port_final = _port_run(cfg, variables, batches, torch.float32)
    port64, port64_final = _port_run(cfg, variables, batches, torch.float64)
    return dict(jax=jax_out, jax_final=jax_final, port=port, port_final=port_final,
                port64=port64, port64_final=port64_final)


def _rounding(a: torch.Tensor, b64: torch.Tensor) -> float:
    """Largest |f32 - f64| of one leaf: what f32 rounding alone moves it."""
    return float((a.double() - b64.double()).abs().max())


class TestTrainStep:
    """Tolerances: rtol 1e-3 / atol 1e-6 on gradients, 1e-4 on the loss,
    1e-5 + 1e-3 relative on parameters, 1e-5 on BatchNorm statistics, each
    plus `ROUNDING` times the port's own f32 rounding of
    that leaf (its f32 result against its f64 one).  At random weights the
    coarse level's Kabsch backward (the SVD's 1/(s_i^2 - s_j^2)) magnifies
    f32 rounding to ~1e-3 of a gradient leaf in either package; the two
    round alike (on these inputs no JAX f32 leaf is more than 1.7x as far
    from the port's f64 one as the port's own), and a porting defect would
    show in the port's f32 and f64 runs alike, so it adds nothing to the
    allowance."""
    ROUNDING = 4

    def test_same_keypoints_in_both_packages(self, runs):
        """Keypoints identical (to 1e-3 m) in both packages and in the f64
        run, at all 3 levels of both towers in each of the 3 steps."""
        for i in range(STEPS):
            jk = runs['jax'][i][2]
            for what, tk in (('f32', runs['port'][i][2]), ('f64', runs['port64'][i][2])):
                for key in jk:
                    dev = float(np.abs(tk[key] - jk[key]).max())
                    assert dev < 1e-3, (f'step {i + 1} {key} ({what}): keypoints differ by '
                                        f'{dev} m: a weighted-FPS near-tie picked another point')

    def test_gradients_at_step_1(self, runs):
        want, got, g64 = runs['jax'][0][0], runs['port'][0][0], runs['port64'][0][0]
        assert set(got) == set(want) == set(g64)
        for name in want:
            np.testing.assert_allclose(
                got[name].numpy(), want[name].numpy(), rtol=1e-3,
                atol=1e-6 + self.ROUNDING * _rounding(got[name], g64[name]), err_msg=name)

    def test_loss_and_metrics_each_step(self, runs):
        for i in range(STEPS):
            jm, tm = runs['jax'][i][1], runs['port'][i][1]
            assert set(jm) <= set(tm)
            assert tm['loss'] == pytest.approx(jm['loss'], rel=1e-4), i
            for key in jm:
                assert tm[key] == pytest.approx(jm[key], rel=1e-3, abs=1e-4), (i, key)
            assert math.isfinite(tm['grad_norm']) and tm['grad_norm'] > 0

    def test_parameters_and_batch_stats_after_3_steps(self, runs):
        want, got, got64 = runs['jax_final'], runs['port_final'], runs['port64_final']
        assert set(got) == set(want)
        for name in want:
            stat = name.endswith(('running_mean', 'running_var'))
            np.testing.assert_allclose(
                got[name].numpy(), want[name].numpy(), err_msg=name, rtol=0 if stat else 1e-3,
                atol=1e-5 + self.ROUNDING * _rounding(got[name], got64[name]))


# --- one train step of each registration family, both packages ------------

PRESET_STEPS = ['reg_v0', 'reg_v2', 'reg_v6', 'reg_v7', 'reg_v9', 'reg_v10', 'reg_v12']
GRAD_REL_L2 = 1e-2        # of the whole gradient
LEAF_REL_L2 = 5e-2        # of a leaf, or of 1e-3 of the largest leaf's norm


def _preset_configs(name):
    jcfg, cfg = jexperiments.experiment(name), experiments.experiment(name)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, levels=J_LEVELS,
                                                               **SMALL))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, levels=LEVELS, **SMALL))
    return jcfg, cfg


def _port_step(cfg, variables, batch, dtype):
    """One port train step from the flax variables (model and MI
    discriminators) in `dtype`: gradients by objective name, metrics,
    keypoints."""
    obj = RegistrationObjective(cfg)
    obj.load_state_dict(from_flax(variables), strict=True)
    obj.to(dtype)
    state = loop.TrainState(obj, Optimizer(cfg.train, obj.named_parameters(), STEPS_PER_EPOCH))
    kps = {}
    hook = obj.model.register_forward_hook(
        lambda m, a, ret: kps.update({k: v.detach().double().numpy().copy()
                                      for k, v in _keypoints(ret).items()}))
    metrics = loop.make_train_step()(state, {k: torch.from_numpy(batch[k]).to(dtype)
                                             for k in loop.USED})
    hook.remove()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for n, p in obj.named_parameters()}
    return grads, {k: float(v) for k, v in metrics.items()}, kps


def preset_runs(name):
    """One train step of the experiment in each package from the same
    variables, and the port's step in float64 (`tools/probe_grad_kinks.py`
    reads them too).  model_v5's detector q and k projections are drawn at
    4x the scale, as in `test_torch_presets.py` (at the plain draw its
    keypoints coincide exactly and kNN meets exact ties)."""
    jcfg, cfg = _preset_configs(name)
    batch = _batches()[0]
    jobj = JObjective(jcfg)
    variables = _variables(jobj, batch, seed=3, train=False)
    if cfg.model.name == 'model_v5':
        for i in (1, 2, 3):
            for dense in ('Dense_0', 'Dense_1'):
                variables['params']['model'][f'detector_{i}'][dense]['kernel'] *= 4

    @jax.jit
    def jgrad(params, batch_stats, batch):
        def loss_fn(p):
            (loss, metrics, ret), _ = jobj.apply({'params': p, 'batch_stats': batch_stats},
                                                 batch, train=True, mutable=['batch_stats'])
            return loss, (metrics, _keypoints(ret))
        return jax.grad(loss_fn, has_aux=True)(params)

    grads, (metrics, kps) = jgrad(variables['params'], variables['batch_stats'], batch)
    return dict(name=name, jax=(from_flax({'params': jax.tree.map(np.asarray, grads)}),
                                jax.tree.map(float, metrics), jax.tree.map(np.asarray, kps)),
                port=_port_step(cfg, variables, batch, torch.float32),
                port64=_port_step(cfg, variables, batch, torch.float64),
                variables=variables, batch=batch)


@pytest.fixture(scope='module', params=PRESET_STEPS)
def preset_step(request):
    return preset_runs(request.param)


class TestPresetTrainStep:
    """One train step (B=2, 256 points, small levels) of the conv, MI,
    regression, circle, attention and PTv3-with-MI experiments, both
    packages from the same variables: the loss within 1e-4 relative, every
    metric within 1e-3 relative / 1e-4, each loss term under its JAX name,
    the same keypoints (1e-3 m, and 1e-3 of model_v5's km scale), and the
    same gradient leaves (the MI discriminators' included) in the L2 norm:
    the whole gradient within `GRAD_REL_L2`, every leaf within
    `LEAF_REL_L2` of its norm or of 1e-3 of the largest leaf's.

    Not `TestTrainStep`'s element-wise rule (rtol 1e-3 plus 4x the port's
    own f32-vs-f64 difference), which reg_v2 and reg_v10 meet but the others
    cannot: their conv towers end in ReLUs and maxima over k, and at random
    weights the loss has kinks within the two packages' rounding of the
    evaluation point.  `tools/probe_grad_kinks.py` shows it: in reg_v0,
    central finite differences (f64) of the `detector_2.ConvBNReLU_0.Dense_0`
    entry where the packages differ most read 4.95 and 4.55 at steps 1e-5
    and 1e-6 (and -4033 at 1e-4) around the port's 4.71 and JAX's 4.61, and
    the port's f32 and f64 runs fall on one side, so they measure nothing
    of it.  The same tool measures the differences these bounds hold
    (whole gradient 1.6e-4 to 6.3e-3, leaves up to 2.8e-2); a wrong or
    missing path leaves an O(1) difference in its leaves."""

    def test_same_keypoints(self, preset_step):
        jk, tk, tk64 = preset_step['jax'][2], preset_step['port'][2], preset_step['port64'][2]
        for key in jk:
            tol = 1e-3 * (1 + float(np.abs(jk[key]).max()))
            for what, got in (('f32', tk[key]), ('f64', tk64[key])):
                dev = float(np.abs(got - jk[key]).max())
                assert dev < tol, f'{preset_step["name"]} {key} ({what}): {dev} m'

    def test_loss_and_terms(self, preset_step):
        jm, tm = preset_step['jax'][1], preset_step['port'][1]
        assert set(jm) <= set(tm) and set(tm) - set(jm) == {'grad_norm'}
        cfg = experiments.experiment(preset_step['name'])
        terms = {'chamfer_loss': cfg.loss.chamfer, 'mi_loss': cfg.loss.mi,
                 'circle_loss': cfg.loss.circle}
        assert {t for t, on in terms.items() if on} == set(tm) & set(terms)
        assert tm['loss'] == pytest.approx(jm['loss'], rel=1e-4)
        for key in jm:
            assert tm[key] == pytest.approx(jm[key], rel=1e-3, abs=1e-4), key
        assert math.isfinite(tm['grad_norm']) and tm['grad_norm'] > 0

    def test_gradients(self, preset_step):
        want, got, g64 = preset_step['jax'][0], preset_step['port'][0], preset_step['port64'][0]
        assert set(got) == set(want) == set(g64)
        cfg = experiments.experiment(preset_step['name'])
        assert any(n.startswith('mi_loss.') for n in got) == cfg.loss.mi
        for name in want:
            assert got[name].shape == want[name].shape == g64[name].shape, name
        norms = {n: float(w.double().norm()) for n, w in want.items()}
        diffs = {n: float((got[n].double() - want[n].double()).norm()) for n in want}
        total = math.sqrt(sum(v * v for v in norms.values()))
        assert math.sqrt(sum(v * v for v in diffs.values())) <= GRAD_REL_L2 * total
        floor = 1e-3 * max(norms.values())
        for name in want:
            assert diffs[name] <= LEAF_REL_L2 * max(norms[name], floor), \
                (name, diffs[name], norms[name])


# --- the loop: fit, checkpoints, resume, refusals --------------------------

def _small_run_config():
    cfg = _configs()[1]
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, pcd_min_samples=POINTS, batch_size=2),
        train=dataclasses.replace(cfg.train, epochs=2))


def _datasets(cfg, n_train=6, n_val=3):
    """Synthetic train and val splits at 256 points: 3 steps per epoch, and
    a val split whose size is not a multiple of the batch."""
    return (PairDataset(SyntheticPairSource(n_train, 2 * POINTS, seed=0), cfg.data, 'train'),
            PairDataset(SyntheticPairSource(n_val, 2 * POINTS, seed=101), cfg.data, 'val'))


def _train_losses(log_dir):
    with open(log_dir / 'metrics.jsonl') as f:
        return {r['step']: r['loss'] for r in map(json.loads, f) if r['split'] == 'train'}


class TestLoop:
    def test_fit_on_cpu_and_val_mean_over_real_pairs(self, tmp_path):
        cfg = _small_run_config()
        train_ds, val_ds = _datasets(cfg)
        state, val = loop.fit(cfg, log_dir=str(tmp_path), max_steps=2,
                              datasets=(train_ds, val_ds), device='cpu')
        assert state.step == 2 and state.epoch == 0
        losses = _train_losses(tmp_path)
        assert sorted(losses) == [1, 2] and all(math.isfinite(v) for v in losses.values())
        # the val mean over 3 pairs in batches of 2 and 1 is the mean over the pairs
        step = loop.make_eval_step()
        per_pair = []
        for i in range(len(val_ds)):
            item = {k: v[None] for k, v in val_ds[i].items()}
            per_pair.append(step(state, loop.to_device(item, torch.device('cpu')))[0])
        for key, value in val.items():
            mean = float(np.mean([float(m[key]) for m in per_pair]))
            assert value == pytest.approx(mean, rel=1e-4, abs=1e-6), key
        assert (tmp_path / 'ckpt' / 'last' / checkpoint.TRAIN_STATE).exists()
        assert loop.latest_checkpoint(str(tmp_path / 'ckpt')) == str(tmp_path / 'ckpt' / 'last')

    def test_resume_continues_the_uninterrupted_run(self, tmp_path):
        """Stopped after 2 of an epoch's 3 steps and resumed with
        resume='auto', a run takes steps 3 (the same epoch's last batch) and 4
        (the next epoch's first) with the uninterrupted run's losses."""
        cfg = _small_run_config()
        whole, parts = tmp_path / 'whole', tmp_path / 'parts'
        loop.fit(cfg, log_dir=str(whole), max_steps=4, datasets=_datasets(cfg), device='cpu')
        loop.fit(cfg, log_dir=str(parts), max_steps=2, datasets=_datasets(cfg), device='cpu')
        state, _ = loop.fit(cfg, log_dir=str(parts), max_steps=4, datasets=_datasets(cfg),
                            resume='auto', device='cpu')
        assert (state.step, state.epoch) == (4, 1)
        want, got = _train_losses(whole), _train_losses(parts)
        assert sorted(got) == [1, 2, 3, 4]
        for step in (3, 4):
            assert got[step] == want[step], step

    def test_checkpoint_round_trip(self, tmp_path):
        cfg = _small_run_config()
        state = loop.create_state(cfg, 3, device='cpu')
        step = loop.make_train_step()
        batch = loop.to_device(_batches()[0], torch.device('cpu'))
        step(state, batch)
        state.epoch, state.best['rre'] = 5, 1.5
        checkpoint.save_train(tmp_path / 'ck', state, cfg)
        other = loop.create_state(cfg, 3, device='cpu', seed=99)
        checkpoint.restore_train(tmp_path / 'ck', other)
        assert (other.step, other.epoch, other.best['rre']) == (1, 5, 1.5)
        for (n, a), (_, b) in zip(state.objective.model.state_dict().items(),
                                  other.objective.model.state_dict().items()):
            assert torch.equal(a, b), n
        assert other.optimizer.count == 1
        for n, st in state.optimizer.state.items():
            assert all(torch.equal(v, other.optimizer.state[n][k]) for k, v in st.items()), n
        assert json.loads((tmp_path / 'ck' / 'meta.json').read_text())['step'] == 1
        # the next step is the same from both
        assert float(step(state, batch)['loss']) == float(step(other, batch)['loss'])

    def test_flagship_init_and_cuda_default(self, monkeypatch):
        cfg = experiments.experiment('reg_v11')
        state = loop.create_state(cfg, 256, device='cpu', init=checkpoint.FLAGSHIP)
        want = checkpoint.load(checkpoint.FLAGSHIP)[1]
        got = state.objective.model.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)
        monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            loop.create_state(cfg, 256)

    @pytest.mark.parametrize('name', sorted(set(experiments.available()) - {'reg_v11'}))
    def test_every_experiment_takes_a_step(self, name):
        """Every experiment of the table builds its objective and takes one
        finite step at small levels, reporting exactly its loss terms."""
        cfg = experiments.experiment(name)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, levels=LEVELS,
                                                                 **SMALL))
        state = loop.create_state(cfg, 3, device='cpu')
        m = loop.make_train_step()(state, loop.to_device(_batches()[0], torch.device('cpu')))
        terms = {'chamfer_loss': cfg.loss.chamfer, 'mi_loss': cfg.loss.mi,
                 'circle_loss': cfg.loss.circle}
        assert {t for t, on in terms.items() if on} == set(m) & set(terms)
        assert all(math.isfinite(float(v)) for v in m.values()), m
        assert hasattr(state.objective, 'mi_loss') == cfg.loss.mi

    def test_mi_refuses_a_batch_of_one_in_training(self):
        """The MI negatives are the batch rolled by one: training refuses B=1,
        as JAX does; eval still runs it."""
        cfg = _preset_configs('reg_v6')[1]
        state = loop.create_state(cfg, 3, device='cpu')
        one = loop.to_device({k: v[:1] for k, v in _batches()[0].items()}, torch.device('cpu'))
        with pytest.raises(ValueError, match='batch_size >= 2'):
            loop.make_train_step()(state, one)
        metrics, _ = loop.make_eval_step()(state, one)
        assert math.isfinite(float(metrics['mi_loss']))

    def test_checkpoint_round_trip_with_mi_discriminators(self, tmp_path):
        """`save_train`/`restore_train` carry the MI discriminators and
        their optimizer moments; the next step is the same from both."""
        cfg = _preset_configs('reg_v6')[1]
        state = loop.create_state(cfg, 3, device='cpu')
        step = loop.make_train_step()
        batch = loop.to_device(_batches()[0], torch.device('cpu'))
        step(state, batch)
        checkpoint.save_train(tmp_path / 'ck', state, cfg)
        other = loop.create_state(cfg, 3, device='cpu', seed=99)
        assert not torch.equal(other.objective.mi_loss.global_d.Dense_0.weight,
                               state.objective.mi_loss.global_d.Dense_0.weight)
        checkpoint.restore_train(tmp_path / 'ck', other)
        for (n, a), (_, b) in zip(state.objective.state_dict().items(),
                                  other.objective.state_dict().items()):
            assert torch.equal(a, b), n
        mi = [n for n in state.optimizer.state if n.startswith('mi_loss.')]
        assert len(mi) == 8     # 7 weights and the global head's bias
        for n in mi:
            for k, v in state.optimizer.state[n].items():
                assert torch.equal(v, other.optimizer.state[n][k]), (n, k)
        assert float(step(state, batch)['loss']) == float(step(other, batch)['loss'])
        # a train checkpoint without the discriminators does not load into MI
        plain = loop.create_state(_configs()[1], 3, device='cpu')
        checkpoint.save_train(tmp_path / 'plain', plain, _configs()[1])
        with pytest.raises((ValueError, RuntimeError)):
            checkpoint.restore_train(tmp_path / 'plain', other)

    def test_backward_runs_without_tf32(self):
        """The train step's backward sees both TF32 flags off (read by a
        gradient hook) though the process default has them on, and the
        caller's flags come back after the step."""
        from torch import backends
        cfg = _configs()[1]
        state = loop.create_state(cfg, 3, device='cpu')
        seen = []
        state.objective.model.feature_extraction.ptv3_1.PTv3Block_0.PatchAttention_0.Dense_0 \
            .weight.register_hook(lambda g: seen.append(
                (backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32)))
        prev = (backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32)
        backends.cuda.matmul.allow_tf32 = backends.cudnn.allow_tf32 = True
        try:
            loop.make_train_step()(state, loop.to_device(_batches()[0], torch.device('cpu')))
            assert seen == [(False, False)]
            assert backends.cuda.matmul.allow_tf32 and backends.cudnn.allow_tf32
        finally:
            backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32 = prev

    def test_watch_adds_module_norms_under_jax_names(self):
        cfg = _configs()[1]
        state = loop.create_state(cfg, 3, device='cpu')
        m = loop.make_train_step(watch=True)(state, loop.to_device(_batches()[0],
                                                                   torch.device('cpu')))
        modules = ('feature_extraction', 'coarse_corres', 'fine_corres_2', 'fine_corres_1')
        for tag in ('watch_grad_norm', 'watch_param_norm'):
            assert {k for k in m if k.startswith(tag)} == {f'{tag}/model.{n}' for n in modules}
        fe = [p for n, p in state.objective.named_parameters() if '.feature_extraction.' in n]
        want = math.sqrt(sum(float(torch.sum(p.grad * p.grad)) for p in fe if p.grad is not None))
        assert float(m['watch_grad_norm/model.feature_extraction']) == pytest.approx(want, rel=1e-5)

    def test_detached_transformation_and_fused_towers(self):
        """`detach_transformation`: the loss is 0 and no parameter moves but by
        weight decay.  `fuse_towers_train`: one 2B tower call, so one FPS
        launch-worth of rows and joint BatchNorm statistics (finite step)."""
        cfg = _configs()[1]
        batch = loop.to_device(_batches()[0], torch.device('cpu'))
        det = dataclasses.replace(cfg, loss=dataclasses.replace(cfg.loss,
                                                                detach_transformation=True))
        state = loop.create_state(det, 3, device='cpu')
        m = loop.make_train_step()(state, batch)
        assert float(m['loss']) == 0 and float(m['tf_loss']) > 0 and float(m['grad_norm']) == 0
        fused = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                   fuse_towers_train=True))
        state = loop.create_state(fused, 3, device='cpu')
        calls = []
        state.objective.model.feature_extraction.register_forward_hook(
            lambda mod, a, out: calls.append(a[0].shape[0]))
        m = loop.make_train_step()(state, batch)
        assert calls == [2 * BATCH] and math.isfinite(float(m['loss']))


# --- the train command: --resume takes the checkpoint's model config -------

def _cli_run(monkeypatch, argv):
    """`python -m pcd_reg_hregnet_torch.train ARGV` on the CPU at 256 points
    and B=2, with `fit` given small synthetic splits (the command's own
    splits would validate 256 pairs); returns the Config it ran."""
    from pcd_reg_hregnet_torch.train import __main__ as train_main
    seen = []

    def small_fit(cfg, **kw):
        seen.append(cfg)
        return loop.fit(cfg, datasets=_datasets(cfg), **kw)
    monkeypatch.setattr(train_main, 'fit', small_fit)
    assert train_main.main(['--device', 'cpu', '--npoints', str(POINTS), '--batch-size', '2',
                            *argv]) == 0
    return seen[0]


class TestResumeCommand:
    def test_resume_without_the_options_restores_and_steps(self, tmp_path, monkeypatch):
        """A `--debug-scale` run resumed with no model options rebuilds the
        checkpoint's small model (the options alone would build the full
        one, which the strict restore refuses), restores and steps on."""
        log = str(tmp_path)
        first = _cli_run(monkeypatch, ['--debug-scale', '--max-steps', '1', '--log-dir', log])
        again = _cli_run(monkeypatch, ['--max-steps', '2', '--resume', 'auto', '--log-dir', log])
        assert again.model == first.model
        assert json.loads((tmp_path / 'ckpt' / 'last' / 'meta.json').read_text())['step'] == 2

    def test_bf16_run_resumed_without_the_flag_stays_bf16(self, tmp_path, monkeypatch):
        log = str(tmp_path)
        _cli_run(monkeypatch, ['--debug-scale', '--compute-dtype', 'bfloat16', '--max-steps',
                               '1', '--log-dir', log])
        again = _cli_run(monkeypatch, ['--max-steps', '2', '--resume', 'auto', '--log-dir', log])
        assert again.model.compute_dtype == 'bfloat16'
        saved = checkpoint.load_config(tmp_path / 'ckpt' / 'last')
        assert saved.model.compute_dtype == 'bfloat16'
        # an option still overrides the checkpoint's value
        f32 = _cli_run(monkeypatch, ['--max-steps', '3', '--resume', 'auto', '--log-dir', log,
                                     '--compute-dtype', 'float32'])
        assert f32.model == dataclasses.replace(again.model, compute_dtype='float32')

    def test_debug_scale_shrinks_ptv3_only_for_the_ptv3_backbone(self):
        """`--debug-scale` sets the small pyramid for every backbone and the
        PTv3 fields only where the backbone is ptv3, as the JAX CLI does."""
        import argparse
        ap = argparse.ArgumentParser()
        experiments.add_config_args(ap)
        conv = experiments.config_from_args(ap.parse_args(['--experiment', 'reg_v0',
                                                           '--debug-scale']))
        base = experiments.experiment('reg_v0').model
        assert conv.model.levels != base.levels
        assert (conv.model.ptv3_depths, conv.model.ptv3_patch_sizes) == (
            base.ptv3_depths, base.ptv3_patch_sizes)
        ptv = experiments.config_from_args(ap.parse_args(['--debug-scale']))
        assert ptv.model.ptv3_depths == (1,) and ptv.model.ptv3_patch_sizes == (16, 16, 16)
