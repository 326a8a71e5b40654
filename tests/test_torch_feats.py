"""The port's feats pretrain against the JAX package's (CPU).

* `_pair_dist`, `prob_chamfer_loss` (with sigmas and with `sigma=None`)
  and `matching_loss` on seeded inputs: values within rtol 1e-5 and every
  input's gradient within rtol 1e-4 / atol 1e-6 of `jax.grad` (the same
  formulas in f32); `conf_weights` carries no gradient in either.
* `FeatsObjective` at small levels (64/32/16 keypoints from 256 points, one
  PTv3 block, patches of 16), both stages, from the same random variables:
  at `train=False` the loss and metrics; at `train=True` one step through
  the port's `train.loop.make_train_step` against JAX's
  `train/feats.py::make_feats_train_step` (and `jax.grad` of the same
  loss): loss and metrics within rtol 1e-4, every gradient within rtol
  1e-3 / atol 1e-6, the BatchNorm running statistics after the src-then-dst
  calls within 1e-5, the parameters after the Adam step within 1e-5 +
  1e-3 relative, each plus `ROUNDING` times the port's own f32-vs-f64
  difference of that leaf; in the descriptor stage every detector
  parameter bit-identical after the step.  Both packages must pick the same
  keypoints (a weighted-FPS near-tie would make a difference real).
* `transplant_backbone` on state_dicts against JAX's on param trees,
  exactly; both of JAX's refusals, and the port's own refusal of a partial
  or misshapen subtree.
* The three-stage chain through the port on the CPU: detector (resumed
  mid-stage, continuing at its step with the uninterrupted run's losses),
  descriptor from the detector stage's directory with the detector frozen,
  then `fit(pretrain_feats=...)`: finite, the backbone transplanted
  exactly and every other leaf the seeded init.
* The exported descriptor checkpoint at full width on its first 2 yardstick
  pairs (`port_assets/feats_desc_r5_feats_jax_cpu.json`; no JAX at test
  time): every per-pair loss within `chip_smoke.FEATS_ANY_RTOL` of the
  JAX-CPU value.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcd_reg_hregnet_tpu import losses as jlosses
from pcd_reg_hregnet_tpu.losses import losses as jlosses_mod
from pcd_reg_hregnet_tpu.models.registration import RegistrationModel as JModel
from pcd_reg_hregnet_tpu.parallel.mesh import make_mesh
from pcd_reg_hregnet_tpu.train import experiments as jexperiments
from pcd_reg_hregnet_tpu.train import feats as jfeats
from pcd_reg_hregnet_tpu.train.loop import TrainState as JTrainState
from pcd_reg_hregnet_tpu.train.optimizer import make_optimizer as jmake_optimizer
from pcd_reg_hregnet_torch.data import PairDataset, SyntheticPairSource
from pcd_reg_hregnet_torch.geometry import se3
from pcd_reg_hregnet_torch.losses import losses
from pcd_reg_hregnet_torch.models import zoo
from pcd_reg_hregnet_torch.train import experiments, feats, loop
from pcd_reg_hregnet_torch.train.feats_loop import fit_feats
from pcd_reg_hregnet_torch.train.optimizer import Optimizer
from pcd_reg_hregnet_torch.utils import checkpoint
from pcd_reg_hregnet_torch.utils.convert import from_flax
from test_torch_model import J_LEVELS, LEVELS, _variables

torch.set_num_threads(1)

# the PTv3 debug scale of both packages' `--debug-scale`
DEBUG = dict(ptv3_depths=(1,), ptv3_num_heads=(2,), ptv3_patch_sizes=(16, 16, 16))
BATCH, POINTS, STEPS_PER_EPOCH = 2, 256, 100
STAGES = ('detector', 'descriptor')


# --- the losses --------------------------------------------------------------

def _loss_inputs(seed, b=2, m=24, n=20, c=16):
    rng = np.random.default_rng(seed)
    tw = np.concatenate([rng.uniform(-0.3, 0.3, (b, 3)), rng.uniform(-1, 1, (b, 3))], 1)
    T = se3.exp(torch.from_numpy(tw.astype(np.float32))).numpy()
    return dict(kp1=rng.uniform(-10, 10, (b, m, 3)), kp2=rng.uniform(-10, 10, (b, n, 3)),
                s1=rng.uniform(0.1, 3.5, (b, m)), s2=rng.uniform(0.1, 3.5, (b, n)),
                d1=rng.normal(0, 1, (b, m, c)), d2=rng.normal(0, 1, (b, n, c)),
                R=T[:, :3, :3], t=T[:, :3, 3])


LOSSES = {
    'pair_dist': (('d1', 'd2'), lambda L, i: L._pair_dist(i['d1'], i['d2']).sum()),
    'chamfer': (('kp1', 'kp2', 's1', 's2'), lambda L, i: L.prob_chamfer_loss(
        i['kp1'], i['kp2'], i['s1'], i['s2'], i['R'], i['t'])),
    'chamfer_no_sigma': (('kp1', 'kp2'), lambda L, i: L.prob_chamfer_loss(
        i['kp1'], i['kp2'], None, None, i['R'], i['t'])),
    'matching': (('kp1', 's1', 'd1', 'kp2', 's2', 'd2'), lambda L, i: L.matching_loss(
        i['kp1'], i['s1'], i['d1'], i['kp2'], i['s2'], i['d2'], i['R'], i['t'])),
}


class TestLosses:
    @pytest.mark.parametrize('seed', [0, 1])
    @pytest.mark.parametrize('name', sorted(LOSSES))
    def test_values_and_gradients_match_jax(self, name, seed):
        wrt, fn = LOSSES[name]
        raw = {k: v.astype(np.float32) for k, v in _loss_inputs(seed).items()}

        def jfn(*args):
            return fn(jlosses_mod, dict(raw, **dict(zip(wrt, args))))
        want, jgrads = jax.value_and_grad(jfn, argnums=tuple(range(len(wrt))))(
            *(jnp.asarray(raw[k]) for k in wrt))
        inputs = {k: torch.from_numpy(v) for k, v in raw.items()}
        for k in wrt:
            inputs[k].requires_grad_()
        got = fn(losses, inputs)
        got.backward()
        assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
        for k, g in zip(wrt, jgrads):   # None: no gradient reaches it (the matching sigmas)
            grad = torch.zeros_like(inputs[k]) if inputs[k].grad is None else inputs[k].grad
            np.testing.assert_allclose(grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-6,
                                       err_msg=k)

    def test_exported_under_jax_names(self):
        from pcd_reg_hregnet_torch import losses as port
        assert port.prob_chamfer_loss is losses.prob_chamfer_loss
        assert port.matching_loss is losses.matching_loss
        assert jlosses.matching_loss is jlosses_mod.matching_loss

    def test_conf_weights_carry_no_gradient(self):
        """The sigmas reach the matching loss through `conf_weights` only,
        which is detached: no gradient reaches them, as in JAX."""
        raw = {k: torch.from_numpy(v.astype(np.float32)) for k, v in _loss_inputs(2).items()}
        raw['s1'].requires_grad_()
        raw['d1'].requires_grad_()
        LOSSES['matching'][1](losses, raw).backward()
        assert raw['s1'].grad is None and raw['d1'].grad is not None
        jg = jax.grad(lambda s: LOSSES['matching'][1](
            jlosses_mod, dict({k: jnp.asarray(v.detach().numpy()) for k, v in raw.items()},
                              s1=s)))(jnp.asarray(raw['s1'].detach().numpy()))
        assert not np.any(np.asarray(jg))


# --- the objective and one step of each stage, both packages ----------------

def _configs(stage):
    """reg_v11 at small levels with the pretrain recipe of the stage: as the
    JAX `pretrain-feats` builds it, and by the port's `feats.recipe`."""
    out = []
    for exps, levels in ((jexperiments, J_LEVELS), (experiments, LEVELS)):
        cfg = exps.experiment('reg_v11')
        out.append(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, levels=levels, **DEBUG),
            data=dataclasses.replace(cfg.data, pcd_min_samples=POINTS, batch_size=BATCH),
            train=dataclasses.replace(cfg.train, epochs=10)))
    jcfg, cfg = out
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, optimizer='adam', schedule='step', lr=1e-3,
        freeze_detector=stage == 'descriptor'))
    return jcfg, feats.recipe(cfg, stage)


def _batch(seed=7):
    """Random target clouds and decalibrated, noisy sources."""
    rng = np.random.default_rng(seed)
    dst = rng.uniform(-40, 40, (BATCH, POINTS, 3)).astype(np.float32)
    tw = np.concatenate([rng.uniform(-0.2, 0.2, (BATCH, 3)),
                         rng.uniform(-0.5, 0.5, (BATCH, 3))], 1).astype(np.float32)
    igt = se3.exp(torch.from_numpy(tw)).numpy()
    src = (np.einsum('bij,bnj->bni', igt[:, :3, :3], dst) + igt[:, None, :3, 3]
           + rng.normal(0, 0.01, dst.shape)).astype(np.float32)
    return {'uncalibed_pcd': src, 'pcd_left': dst, 'igt': igt}


def _keypoints(rets):
    return {f'{side}_{lvl}': np.asarray(ret[f'xyz_{lvl}'], np.float64)
            for side, ret in zip(('src', 'dst'), rets) for lvl in (1, 2, 3)}


def _port_run(cfg, stage, variables, batch, dtype):
    """The port's eval forward, then one train step from the flax
    variables in `dtype`: eval metrics, step metrics, gradients, keypoints,
    the state_dict after the step and the detector's before it."""
    obj = feats.FeatsObjective(cfg, train_desc=stage == 'descriptor')
    obj.load_state_dict(from_flax(variables), strict=True)
    obj.to(dtype)
    tensors = {k: torch.from_numpy(batch[k]).to(dtype) for k in loop.USED}
    obj.eval()
    with torch.no_grad():
        _, eval_metrics, _ = obj(tensors)
    state = loop.TrainState(obj, Optimizer(cfg.train, obj.named_parameters(), STEPS_PER_EPOCH))
    kps = {}
    hook = obj.register_forward_hook(lambda m, a, ret: kps.update(_keypoints(
        [{k: v.detach().double().numpy() for k, v in r.items()} for r in ret[2]])))
    before = {k: v.clone() for k, v in obj.state_dict().items() if '.detector_' in f'.{k}'}
    metrics = loop.make_train_step()(state, tensors)
    hook.remove()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for n, p in obj.named_parameters()}
    return dict(eval={k: float(v) for k, v in eval_metrics.items()},
                train={k: float(v) for k, v in metrics.items()}, grads=grads, kps=kps,
                final=obj.state_dict(), detector_before=before)


@pytest.fixture(scope='module', params=STAGES)
def stage_runs(request):
    """One stage in each package from the same random variables: JAX's
    `apply(train=False)`, `jax.grad` of the train-mode loss and one
    `make_feats_train_step`; the port's eval forward and one
    `make_train_step`, in f32 and in f64."""
    stage = request.param
    jcfg, cfg = _configs(stage)
    batch = _batch()
    jobj = jfeats.FeatsObjective(jcfg, train_desc=stage == 'descriptor')
    variables = _variables(jobj, batch, seed=5, train=False)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    _, jeval, _ = jax.jit(lambda v, b: jobj.apply(v, b, train=False))(variables, jbatch)

    @jax.jit
    def jgrad(params, batch_stats, b):
        def loss_fn(p):
            (loss, metrics, rets), _ = jobj.apply({'params': p, 'batch_stats': batch_stats},
                                                  b, train=True, mutable=['batch_stats'])
            return loss, (metrics, _keypoints_jax(rets))
        return jax.grad(loss_fn, has_aux=True)(params)

    grads, (jmetrics, jkps) = jgrad(variables['params'], variables['batch_stats'], jbatch)
    tx = jmake_optimizer(jcfg.train, STEPS_PER_EPOCH)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=variables['params'],
                         batch_stats=variables['batch_stats'],
                         opt_state=tx.init(variables['params']))
    jstate, jstep_metrics = jfeats.make_feats_train_step(jobj, tx, make_mesh(1))(jstate, jbatch)
    return dict(
        stage=stage,
        jax=dict(eval=jax.tree.map(float, jeval), train=jax.tree.map(float, jmetrics),
                 step=jax.tree.map(float, jstep_metrics),
                 grads=from_flax({'params': jax.tree.map(np.asarray, grads)}),
                 kps=jax.tree.map(np.asarray, jkps),
                 final=from_flax({'params': jax.tree.map(np.asarray, jstate.params),
                                  'batch_stats': jax.tree.map(np.asarray,
                                                              jstate.batch_stats)})),
        port=_port_run(cfg, stage, variables, batch, torch.float32),
        port64=_port_run(cfg, stage, variables, batch, torch.float64))


def _keypoints_jax(rets):
    return {f'{side}_{lvl}': ret[f'xyz_{lvl}']
            for side, ret in zip(('src', 'dst'), rets) for lvl in (1, 2, 3)}


def _rounding(a: torch.Tensor, b64: torch.Tensor) -> float:
    """Largest |f32 - f64| of one leaf: what f32 rounding alone moves it."""
    return float((a.double() - b64.double()).abs().max())


class TestFeatsObjective:
    """Tolerances as in `test_torch_train.py::TestTrainStep`: rtol 1e-3 /
    atol 1e-6 on gradients, 1e-4 on the loss and metrics, 1e-5 + 1e-3
    relative on parameters, 1e-5 on BatchNorm statistics, each plus
    `ROUNDING` times the port's own f32 rounding of that leaf (its f32
    result against its f64 one)."""
    ROUNDING = 4

    def test_same_keypoints_in_both_packages(self, stage_runs):
        jk = stage_runs['jax']['kps']
        for what in ('port', 'port64'):
            tk = stage_runs[what]['kps']
            assert set(tk) == set(jk)
            for key in jk:
                dev = float(np.abs(tk[key] - jk[key]).max())
                assert dev < 1e-3, (f'{key} ({what}): keypoints differ by {dev} m: a '
                                    'weighted-FPS near-tie picked another point')

    def test_eval_loss_and_metrics(self, stage_runs):
        want, got = stage_runs['jax']['eval'], stage_runs['port']['eval']
        names = {f'chamfer_l{i}' for i in (1, 2, 3)} | {'loss'}
        if stage_runs['stage'] == 'descriptor':
            names |= {f'matching_l{i}' for i in (1, 2, 3)}
        assert set(want) == set(got) == names
        for key in want:
            assert got[key] == pytest.approx(want[key], rel=1e-4), key

    def test_train_loss_and_metrics(self, stage_runs):
        jm, step_m, tm = (stage_runs['jax']['train'], stage_runs['jax']['step'],
                          stage_runs['port']['train'])
        assert set(tm) == set(jm) | {'grad_norm'} and set(step_m) == set(jm)
        for key in jm:
            assert step_m[key] == pytest.approx(jm[key], rel=1e-6), key
            assert tm[key] == pytest.approx(jm[key], rel=1e-4), key
        assert math.isfinite(tm['grad_norm']) and tm['grad_norm'] > 0

    def test_gradients(self, stage_runs):
        want, got, g64 = (stage_runs['jax']['grads'], stage_runs['port']['grads'],
                          stage_runs['port64']['grads'])
        assert set(got) == set(want) == set(g64)
        for name in want:
            np.testing.assert_allclose(
                got[name].numpy(), want[name].numpy(), rtol=1e-3,
                atol=1e-6 + self.ROUNDING * _rounding(got[name], g64[name]), err_msg=name)
        untouched = [n for n, g in want.items() if not np.any(g.numpy())]
        if stage_runs['stage'] == 'detector':
            # no loss reads the descriptors: the PTv3 encoders get no gradient
            assert untouched and all('ptv3_' in n for n in untouched)
            assert all(not torch.any(got[n]) for n in untouched)

    def test_parameters_and_batch_stats_after_the_step(self, stage_runs):
        """After one step: the BatchNorm running statistics of the two calls
        (src, then dst) and every parameter; in the descriptor stage the
        detector's parameters exactly as before the step."""
        want, got, got64 = (stage_runs['jax']['final'], stage_runs['port']['final'],
                            stage_runs['port64']['final'])
        assert set(got) == set(want)
        for name in want:
            stat = name.endswith(('running_mean', 'running_var'))
            np.testing.assert_allclose(
                got[name].numpy(), want[name].numpy(), err_msg=name, rtol=0 if stat else 1e-3,
                atol=1e-5 + self.ROUNDING * _rounding(got[name], got64[name]))
        before = stage_runs['port']['detector_before']
        params = stage_runs['port']['grads']
        moved = [n for n in before if n in params and not torch.equal(before[n], got[n])]
        if stage_runs['stage'] == 'descriptor':
            assert not moved
        else:
            assert moved


# --- transplant_backbone -----------------------------------------------------

@pytest.fixture(scope='module')
def trees():
    """Random flax variables of the small feats objective and the small
    registration model (no flax init compiled)."""
    jcfg, _ = _configs('descriptor')
    batch = _batch()
    fvars = _variables(jfeats.FeatsObjective(jcfg), batch, seed=1, train=False)
    mvars = _variables(JModel(jcfg.model), batch['uncalibed_pcd'], batch['pcd_left'], seed=2,
                       train=False)
    return fvars, mvars


class TestTransplant:
    @pytest.mark.parametrize('coll', ['params', 'batch_stats'])
    def test_matches_jax(self, trees, coll):
        fvars, mvars = trees
        want = from_flax({coll: jfeats.transplant_backbone(fvars[coll], mvars[coll])})
        got = feats.transplant_backbone(from_flax({coll: fvars[coll]}),
                                        from_flax({coll: mvars[coll]}))
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k

    def test_refusals(self, trees):
        fvars, mvars = trees
        fsd, msd = from_flax(fvars), from_flax(mvars)
        no_fe = {k: v for k, v in msd.items() if not k.startswith('feature_extraction.')}
        # JAX's two: no subtree on either side
        for args in ((mvars['params']['coarse_corres'], mvars['params']),
                     (fvars['params'], {'coarse_corres': mvars['params']['coarse_corres']})):
            with pytest.raises(KeyError, match='feature_extraction'):
                jfeats.transplant_backbone(*args)
        with pytest.raises(KeyError, match='pretrained'):
            feats.transplant_backbone(no_fe, msd)
        with pytest.raises(KeyError, match='target'):
            feats.transplant_backbone(fsd, no_fe)
        # the port's own: a partial or misshapen subtree
        partial = dict(fsd)
        partial.pop(next(k for k in fsd if 'running_var' in k))
        with pytest.raises(ValueError, match='missing'):
            feats.transplant_backbone(partial, msd)
        key = next(k for k in fsd if k.endswith('.weight') and fsd[k].ndim == 2)
        with pytest.raises(ValueError, match='shapes'):
            feats.transplant_backbone(dict(fsd, **{key: fsd[key][:, :1]}), msd)


# --- the three-stage chain through the port ----------------------------------

def _chain_cfg(stage=None):
    cfg = _configs(stage or 'detector')[1]
    if stage is None:   # the registration run: reg_v11's own train recipe
        reg = experiments.experiment('reg_v11')
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(reg.train, epochs=2))
    else:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, epochs=2))
    return cfg


def _train_ds(cfg, n=4):
    return PairDataset(SyntheticPairSource(n, 2 * POINTS, seed=0), cfg.data, 'train')


def _losses(log_dir):
    with open(log_dir / 'metrics.jsonl') as f:
        return {r['step']: r['loss'] for r in map(json.loads, f)}


class TestCommandLine:
    @pytest.mark.parametrize('stage', STAGES)
    def test_config_as_the_jax_cli_builds_it(self, stage):
        """`python -m pcd_reg_hregnet_torch.train.feats` builds the JAX
        `pretrain-feats` config: the experiment's (`reg_v11` by default),
        the options, then Adam 1e-3, StepLR and `freeze_detector` in the
        descriptor stage."""
        import argparse

        from pcd_reg_hregnet_tpu import cli as jcli
        argv = ['--batch-size', '16', '--epochs', '50', '--seed', '3']
        ap = argparse.ArgumentParser()
        experiments.add_config_args(ap)
        got = feats.recipe(experiments.config_from_args(ap.parse_args(argv)), stage)
        jap = argparse.ArgumentParser()
        jcli._common(jap)
        jcfg = jcli._build_config(jap.parse_args(argv))
        jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
            jcfg.train, optimizer='adam', schedule='step', lr=1e-3,
            freeze_detector=stage == 'descriptor'))
        assert json.loads(got.to_json()) == json.loads(jcfg.to_json())
        assert got.model.name == 'model_v6' and got.data.batch_size == 16

    def test_main_runs_a_stage_on_the_cpu(self, tmp_path, capsys):
        argv = ['--stage', 'detector', '--device', 'cpu', '--debug-scale', '--npoints', '64',
                '--batch-size', '2', '--max-steps', '1', '--log-dir', str(tmp_path)]
        assert feats.main(argv) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out['stage'] == 'detector' and out['step'] == 1
        assert math.isfinite(out['train']['loss'])
        assert (tmp_path / 'ckpt' / 'feats_detector' / checkpoint.TRAIN_STATE).exists()


class TestChain:
    def test_detector_descriptor_then_registration(self, tmp_path):
        det_cfg, desc_cfg, reg_cfg = _chain_cfg('detector'), _chain_cfg('descriptor'), _chain_cfg()
        # detector: 3 steps at once, and 1 then 2 more from its stage checkpoint
        whole, parts = tmp_path / 'whole', tmp_path / 'det'
        fit_feats(det_cfg, stage='detector', max_steps=3, log_dir=str(whole),
                  datasets=(_train_ds(det_cfg),), device='cpu')
        s1, _ = fit_feats(det_cfg, stage='detector', max_steps=1, log_dir=str(parts),
                          datasets=(_train_ds(det_cfg),), device='cpu')
        assert (s1.step, s1.epoch) == (1, 0)
        det, m_det = fit_feats(det_cfg, stage='detector', max_steps=3, log_dir=str(parts),
                               datasets=(_train_ds(det_cfg),), device='cpu')
        assert (det.step, det.epoch) == (3, 1)
        got, want = _losses(parts), _losses(whole)
        assert sorted(got) == [1, 2, 3] and all(math.isfinite(v) for v in got.values())
        assert got[2] == want[2] and got[3] == want[3]
        assert math.isfinite(m_det['loss']) and 'matching_l1' not in m_det
        det_dir = parts / 'ckpt' / 'feats_detector'
        assert checkpoint.load_config(det_dir) == det_cfg

        # descriptor: from the detector stage's directory, the detector frozen
        desc, m_desc = fit_feats(desc_cfg, stage='descriptor', max_steps=2,
                                 pretrain_detector=str(det_dir), log_dir=str(tmp_path / 'desc'),
                                 datasets=(_train_ds(desc_cfg),), device='cpu')
        assert desc.step == 2 and math.isfinite(m_desc['loss']) and 'matching_l3' in m_desc
        det_sd, desc_sd = det.objective.state_dict(), desc.objective.state_dict()
        frozen = [n for n, _ in desc.objective.named_parameters() if 'detector' in n]
        assert frozen and all(torch.equal(det_sd[n], desc_sd[n]) for n in frozen)
        ptv3 = [n for n, _ in desc.objective.named_parameters() if 'ptv3' in n]
        assert any(not torch.equal(det_sd[n], desc_sd[n]) for n in ptv3)

        # registration from the descriptor stage: transplanted exactly, the rest seeded
        desc_dir = tmp_path / 'desc' / 'ckpt' / 'feats_descriptor'
        state, _ = loop.fit(reg_cfg, log_dir=str(tmp_path / 'reg0'), max_steps=0,
                            datasets=(_train_ds(reg_cfg), _train_ds(reg_cfg, 2)),
                            pretrain_feats=str(desc_dir), device='cpu')
        seeded = loop.create_state(reg_cfg, 2, device='cpu').objective.model.state_dict()
        got = state.objective.model.state_dict()
        for k, v in got.items():
            src = desc_sd[k] if k.startswith('feature_extraction.') else seeded[k]
            assert torch.equal(v, src), k
        state, val = loop.fit(reg_cfg, log_dir=str(tmp_path / 'reg'), max_steps=1,
                              datasets=(_train_ds(reg_cfg), _train_ds(reg_cfg, 2)),
                              pretrain_feats=str(desc_dir), device='cpu')
        assert state.step == 1 and math.isfinite(val['loss'])

    def test_refusals(self, tmp_path):
        cfg = _chain_cfg('detector')
        with pytest.raises(ValueError, match='stage'):
            feats.create_feats_state(cfg, 1, stage='both', device='cpu')
        # a registration checkpoint is no feats checkpoint: strict load fails
        with pytest.raises(RuntimeError, match='Unexpected key'):
            fit_feats(cfg, stage='detector', max_steps=1, log_dir=str(tmp_path),
                      pretrain_detector=str(checkpoint.FLAGSHIP), datasets=(_train_ds(cfg),),
                      device='cpu')
        # a feats checkpoint has no registration model to build
        with pytest.raises(RuntimeError, match='Missing key'):
            zoo.build('model_v6', device='cpu', weights=checkpoint.FEATS)


# --- the trained descriptor checkpoint against its JAX-CPU yardstick ----------

class TestTrainedFeats:
    def test_yardstick_pairs(self):
        import chip_smoke
        got, ref = chip_smoke.feats_yardstick_run(torch, 'cpu', pairs=2)
        rel, same = chip_smoke.feats_deviation(got, ref)
        assert rel.shape == (2, 6)
        assert rel.max() <= chip_smoke.FEATS_ANY_RTOL, (rel, same)

    def test_export_holds_the_feature_extraction_only(self):
        cfg, weights, other = checkpoint.read(checkpoint.FEATS)
        assert other == {} and cfg.model.name == 'model_v6' and cfg.train.freeze_detector
        obj = feats.FeatsObjective(cfg, train_desc=True)
        assert set(weights) == set(obj.state_dict())
        assert all(k.startswith('feature_extraction.') for k in weights)
