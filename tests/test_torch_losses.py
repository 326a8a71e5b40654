"""The port's loss, schedules, optimizer, experiment table and train twists
against the JAX package (CPU).

* `transformation_loss`: every output and the gradient of the loss within
  1e-6 (the same f32 formulas; full-f32 3x3 products in both); Euler and
  geodesic errors (degrees) within 2e-5 deg; near the identity the
  gradient also within 2e-3 relative (see the test).
* `chamfer_loss` (every reduction), `DeepMILoss` (either head, and both)
  and `overlap_circle_loss` (with and without weights): values within
  1e-5 relative and gradients (of the inputs, and of the discriminators'
  parameters) within 1e-5 relative / 1e-6 absolute; the same f32 formulas
  in other summation orders.
* `make_schedule` against the JAX `make_schedule` (optax's onecycle, cosine,
  staircase exponential and constant schedules) at every step of a 100-step
  run, rtol 1e-6: the port evaluates optax's formulas with its f32
  roundings.
* One to three optimizer steps on fixed gradients against the JAX
  `make_optimizer` chain (clip by global norm, AdamW / Adam / SGD per group,
  frozen groups): parameters within 1e-6.
* The experiment table equals the JAX one entry for entry, and the port's
  parameter groups are JAX's `group_label` of the same paths.
* Train twists: deterministic per (seed, epoch), fresh per epoch, within
  `max_rot_error` / `max_trans_error` (the port draws from numpy, not JAX's
  threefry stream, so the numbers are not JAX's).
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

from pcd_reg_hregnet_tpu.core import config as jconfig
from pcd_reg_hregnet_tpu.losses import chamfer as jchamfer
from pcd_reg_hregnet_tpu.losses import circle as jcircle
from pcd_reg_hregnet_tpu.losses import losses as jlosses
from pcd_reg_hregnet_tpu.losses import mi as jmi
from pcd_reg_hregnet_tpu.train import experiments as jexperiments
from pcd_reg_hregnet_tpu.train import optimizer as joptimizer
from pcd_reg_hregnet_torch.core.config import DataConfig, TrainConfig
from pcd_reg_hregnet_torch.data import PairDataset, SyntheticPairSource
from pcd_reg_hregnet_torch.geometry import perturbations, se3, so3
from pcd_reg_hregnet_torch.losses import (DeepMILoss, chamfer_loss, overlap_circle_loss,
                                          transformation_loss)
from pcd_reg_hregnet_torch.train import experiments, optimizer
from pcd_reg_hregnet_torch.train.objective import RegistrationObjective
from pcd_reg_hregnet_torch.utils.convert import from_flax
from test_torch_model import _rand, _variables

torch.set_num_threads(1)


def _rotations(seed, b, scale):
    rng = np.random.default_rng(seed)
    w = rng.uniform(-scale, scale, (b, 3)).astype(np.float32)
    return so3.exp(torch.from_numpy(w)).numpy()


class TestTransformationLoss:
    @pytest.mark.parametrize('scale', [1e-3, 0.3, 2.5])
    def test_values_and_gradients_match_jax(self, scale):
        gt_R = _rotations(0, 6, 1.0)
        pred_R = np.einsum('bij,bjk->bik', gt_R, _rotations(1, 6, scale)).astype(np.float32)
        rng = np.random.default_rng(2)
        gt_t = rng.uniform(-0.5, 0.5, (6, 3)).astype(np.float32)
        pred_t = (gt_t + rng.normal(0, scale / 4, (6, 3))).astype(np.float32)
        want = jlosses.transformation_loss(*map(jnp.asarray, (pred_R, pred_t, gt_R, gt_t)),
                                           alpha=1.5)
        tR, tt = (torch.from_numpy(x).requires_grad_() for x in (pred_R, pred_t))
        got = transformation_loss(tR, tt, torch.from_numpy(gt_R), torch.from_numpy(gt_t),
                                  alpha=1.5)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]),
                                       atol=2e-5 if key in ('rot_err', 'rre') else 1e-6,
                                       rtol=0, err_msg=key)
        jg = jax.grad(lambda R, t: jlosses.transformation_loss(
            R, t, jnp.asarray(gt_R), jnp.asarray(gt_t), alpha=1.5)['loss'], argnums=(0, 1))(
            jnp.asarray(pred_R), jnp.asarray(pred_t))
        got['loss'].backward()
        # near the identity the rotation term's gradient is the direction of
        # R_rel - I, a difference of near-equal f32 numbers: ~eps / 1e-3 of
        # relative rounding in either package
        rtol = 2e-3 if scale < 0.01 else 0
        np.testing.assert_allclose(tR.grad.numpy(), np.asarray(jg[0]), atol=1e-6, rtol=rtol)
        np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jg[1]), atol=1e-6, rtol=rtol)


LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


class TestRegistrationLosses:
    @pytest.mark.parametrize('reduction', ['mean', 'sum', 'none'])
    def test_chamfer(self, reduction):
        a, b = _rand(0, (2, 50, 3), -40, 40), _rand(1, (2, 40, 3), -40, 40)

        def jfn(x, y):
            return jnp.sum(jchamfer.chamfer_loss(x, y, scale=50.0, reduction=reduction))
        want, jg = jax.value_and_grad(jfn, argnums=(0, 1))(a, b)
        ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
        got = torch.sum(chamfer_loss(ta, tb, scale=50.0, reduction=reduction))
        got.backward()
        assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
        for t, g in zip((ta, tb), jg):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **LOSS_TOL)

    @pytest.mark.parametrize('heads', [(512, 128), (None, 128), (512, None)])
    def test_deep_mi(self, heads):
        """Sized as the objective sizes it at L2 of the full pyramid: global
        over 512 weights, local over 128 channels; inputs as the model makes
        them (sigmoid weights, ReLU features, rolled primes)."""
        g, c = heads
        w = _rand(2, (3, 512), 0, 1)
        cg = _rand(3, (3, 512), 0.001, 2)
        f = _rand(4, (3, 20, 128), 0, 2)
        cl = _rand(5, (3, 20, 128))
        args = dict(x_global=w, x_global_prime=np.roll(w, 1, 0), x_local=f,
                    x_local_prime=np.roll(f, 1, 0), c_local=cl, c_global=cg)
        jm = jmi.DeepMILoss(global_in_channels=g, local_in_channels=c)
        v = _variables(jm, **args)

        def jfn(params, inputs):
            return jm.apply({'params': params}, **inputs)
        want, (jgp, jgi) = jax.value_and_grad(jfn, argnums=(0, 1))(v['params'], args)
        tm = DeepMILoss(g, c)
        tm.load_state_dict(from_flax(v), strict=True)
        inputs = {k: torch.from_numpy(x).requires_grad_() for k, x in args.items()}
        got = tm(**inputs)
        got.backward()
        assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
        wantp = from_flax({'params': jgp})
        assert set(wantp) == {n for n, _ in tm.named_parameters()}
        for n, p in tm.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), wantp[n].numpy(), err_msg=n, **LOSS_TOL)
        for k, t in inputs.items():
            want_g = np.asarray(jgi[k])
            if t.grad is None:
                assert not want_g.any(), k
            else:
                np.testing.assert_allclose(t.grad.numpy(), want_g, err_msg=k, **LOSS_TOL)

    @pytest.mark.parametrize('weighted', [False, True])
    def test_overlap_circle(self, weighted):
        coords = _rand(6, (2, 40, 8), 0, 3)
        feats = _rand(7, (2, 40, 8), 0, 2)
        weights = _rand(8, (2, 40), 0, 1) if weighted else None

        def jfn(f):
            return jcircle.overlap_circle_loss(jnp.asarray(coords), f, weights)
        want, jg = jax.value_and_grad(jfn)(feats)
        tf = torch.from_numpy(feats).requires_grad_()
        got = overlap_circle_loss(torch.from_numpy(coords), tf,
                                  None if weights is None else torch.from_numpy(weights))
        got.backward()
        assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
        np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jg), **LOSS_TOL)


def _train_configs(**over):
    return jconfig.TrainConfig(**over), TrainConfig(**over)


class TestSchedules:
    @pytest.mark.parametrize('over', [
        dict(schedule='onecycle'), dict(schedule='onecycle', warmup_pct=0.3),
        dict(schedule='cosine'), dict(schedule='step', step_size=3, step_gamma=0.5),
        dict(schedule='constant')])
    def test_every_step_of_a_100_step_run(self, over):
        jcfg, cfg = _train_configs(epochs=10, **over)
        for lr in (1e-4, 1e-5):
            want = joptimizer.make_schedule(jcfg, lr, 10)
            got = optimizer.make_schedule(cfg, lr, 10)
            for count in range(103):
                assert got(count) == pytest.approx(float(want(count)), rel=1e-6, abs=0), count

    def test_onecycle_is_optax(self):
        got = optimizer.make_schedule(TrainConfig(epochs=1), 1e-4, 100)
        want = optax.cosine_onecycle_schedule(transition_steps=100, peak_value=1e-4,
                                              pct_start=0.08)
        assert got(0) == pytest.approx(1e-4 / 25, rel=1e-5)   # optax's f32 arithmetic
        assert got(8) == pytest.approx(1e-4, rel=1e-5)
        for count in range(100):
            assert got(count) == pytest.approx(float(want(count)), rel=1e-6), count


def _tree():
    """A parameter tree whose paths fall in every group, and fixed gradients."""
    rng = np.random.default_rng(0)
    shapes = {'feature_extraction': {'detector_1': {'Dense_0': {'kernel': (4, 3)}},
                                     'ptv3_1': {'PTv3Block_0': {'Dense_0': {'bias': (5,)}},
                                                'Dense_1': {'kernel': (3, 3)}}},
              'coarse_corres': {'MLPHead_0': {'Dense_0': {'bias': (6,)}}}}
    params = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32), {'model': shapes},
                          is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
             for _ in range(3)]
    return params, grads


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield '.'.join(prefix + (k,)), v


class TestOptimizer:
    @pytest.mark.parametrize('over,grad_scale', [
        (dict(), 10.0),                                   # clip triggered
        (dict(), 0.01),                                   # not triggered
        (dict(freeze_detector=True), 10.0),
        (dict(freeze_feats=True), 0.01),
        (dict(optimizer='adam', schedule='step', step_size=1), 10.0),
        (dict(optimizer='sgd', schedule='cosine'), 0.01)])
    def test_steps_match_the_jax_chain(self, over, grad_scale):
        jcfg, cfg = _train_configs(epochs=1, lr=1e-2, block_lr=1e-3, **over)
        params, grads = _tree()
        grads = [jax.tree.map(lambda g: g * grad_scale, g) for g in grads]
        tx = joptimizer.make_optimizer(jcfg, 20)
        jp, jstate = params, tx.init(params)
        named = {n: torch.nn.Parameter(torch.from_numpy(v.copy())) for n, v in _flat(params)}
        opt = optimizer.Optimizer(cfg, named.items(), 20)
        norm = math.sqrt(sum(float(np.sum(g * g)) for _, g in _flat(grads[0])))
        assert (norm >= cfg.grad_clip) == (grad_scale > 1)
        for g in grads:
            updates, jstate = tx.update(g, jstate, jp)
            jp = optax.apply_updates(jp, updates)
            for n, p in named.items():
                p.grad = torch.from_numpy(dict(_flat(g))[n].copy())
            got_norm = opt.step()
            assert float(got_norm) == pytest.approx(
                math.sqrt(sum(float(np.sum(x * x)) for _, x in _flat(g))), rel=1e-6)
            for n, want in _flat(jp):
                np.testing.assert_allclose(named[n].detach().numpy(), np.asarray(want),
                                           atol=1e-6, rtol=0, err_msg=n)
        for n, p in named.items():   # frozen parameters did not move
            if optimizer.group_label(n, cfg) == 'frozen':
                assert np.array_equal(p.detach().numpy(), dict(_flat(params))[n])

    def test_groups_follow_jax_paths(self):
        cfg = experiments.experiment('reg_v11')
        names = [n for n, _ in RegistrationObjective(cfg).named_parameters()]
        assert len(names) > 100
        labels = {optimizer.group_label(n, cfg.train) for n in names}
        assert labels == {'base', 'block'}
        for n in names:
            assert (optimizer.group_label(n, cfg.train) == 'block') == ('ptv3' in n)
        frozen = dataclasses.replace(cfg.train, freeze_feats=True)
        assert {optimizer.group_label(n, frozen) for n in names
                if '.feature_extraction.' in f'.{n}'} == {'frozen'}

    def test_mi_discriminators_are_base(self):
        """The JAX `group_label` reads `mi_loss/...` as neither frozen nor a
        PTv3 block: the discriminators train at `lr` (reg_v12 has both)."""
        cfg = experiments.experiment('reg_v12')
        names = [n for n, _ in RegistrationObjective(cfg).named_parameters()]
        mi = [n for n in names if n.startswith('mi_loss.')]
        assert len(mi) == 8
        frozen = dataclasses.replace(cfg.train, freeze_feats=True, freeze_detector=True)
        for train in (cfg.train, frozen):
            assert {optimizer.group_label(n, train) for n in mi} == {'base'}

    def test_state_dict_round_trip(self):
        cfg = TrainConfig(epochs=1)
        p = torch.nn.Parameter(torch.ones(3))
        opt = optimizer.Optimizer(cfg, [('model.a', p)], 10)
        p.grad = torch.full((3,), 0.5)
        opt.step()
        other = optimizer.Optimizer(cfg, [('model.a', torch.nn.Parameter(torch.ones(3)))], 10)
        other.load_state_dict(opt.state_dict())
        assert other.count == 1 and torch.equal(other.state['model.a']['mu'],
                                                opt.state['model.a']['mu'])
        with pytest.raises(ValueError, match='names'):
            optimizer.Optimizer(cfg, [('model.b', p)], 10).load_state_dict(opt.state_dict())


class TestExperiments:
    def test_table_equals_jax(self):
        assert experiments.available() == jexperiments.available()
        for name in experiments.available():
            got = json.loads(experiments.experiment(name).to_json())
            want = json.loads(jexperiments.experiment(name).to_json())
            assert got == want, name

    def test_unknown_experiment(self):
        with pytest.raises(KeyError, match='reg_v11'):
            experiments.experiment('reg_v99')


class TestTrainTwists:
    def _dataset(self, seed=0, **over):
        cfg = dataclasses.replace(DataConfig(), pcd_min_samples=64, **over)
        return PairDataset(SyntheticPairSource(40, 128, seed=0), cfg, 'train', seed=seed)

    @pytest.mark.parametrize('over', [dict(), dict(distribution='gaussian'),
                                      dict(mag_randomly=False, max_rot_error=5.0)])
    def test_deterministic_fresh_per_epoch_and_bounded(self, over):
        a, b = self._dataset(**over), self._dataset(**over)
        a.set_epoch(0)
        first = a._igts.copy()
        assert np.array_equal(first, b._epoch_igts(0))
        a.set_epoch(1)
        b.set_epoch(1)
        assert np.array_equal(a._igts, b._igts)
        assert not np.allclose(a._igts, first)
        assert not np.array_equal(self._dataset(seed=1, **over)._epoch_igts(0), first)
        cfg = a.cfg
        for igts in (first, a._igts):
            w = so3.log(torch.from_numpy(igts[:, :3, :3])).numpy()
            t = igts[:, :3, 3]
            amp = np.deg2rad(cfg.max_rot_error)
            if cfg.distribution == 'uniform':
                assert np.all(np.abs(w) <= amp + 1e-5) and np.all(np.abs(t) <= cfg.max_trans_error + 1e-6)
            else:
                assert np.all(np.linalg.norm(w, axis=1) <= amp + 1e-5)
                assert np.all(np.linalg.norm(t, axis=1) <= cfg.max_trans_error + 1e-6)
            if not cfg.mag_randomly:
                np.testing.assert_allclose(np.abs(w).max(), amp, rtol=0.5)
        item = a[3]
        np.testing.assert_allclose(item['igt'], a._igts[3])
        src = item['pcd_right'] @ item['igt'][:3, :3].T + item['igt'][:3, 3]
        np.testing.assert_allclose(item['uncalibed_pcd'], src, atol=1e-5)

    def test_torch_generator_and_refusals(self):
        tw = perturbations.sample_twist(torch.Generator().manual_seed(0), 20.0, 0.5, shape=(50,))
        again = perturbations.sample_twist(torch.Generator().manual_seed(0), 20.0, 0.5,
                                           shape=(50,))
        assert tw.shape == (50, 6) and torch.equal(tw, again)
        T = se3.exp(tw)
        assert float(T[:, :3, 3].abs().max()) <= 0.5 + 1e-6
        ig = perturbations.sample_twist(np.random.default_rng(0), 20.0, 0.5, 'inverse_gaussian',
                                        shape=(50,))
        assert ig.shape == (50, 6) and bool(torch.isfinite(ig).all())
        with pytest.raises(ValueError):
            perturbations.sample_twist(np.random.default_rng(0), 20.0, 0.5, 'cauchy')
