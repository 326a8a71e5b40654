"""The port's evaluator, ICP and split runner against the JAX package (CPU).

* `CalibEval`: on random and near-identity poses, every key of
  `get_results()` and `summary()` within 1e-5 (f32 math in both).
* ICP: `estimate_normals` up to sign (|dot| within 1e-4; the eigen-solvers
  pick signs of their own, and point-to-plane ICP does not depend on it),
  both solvers within 1e-4 (R) and 1e-3 m (t) of the JAX ones on a case the
  trust gate accepts (corresponding clouds, a perturbed pose) and on one it
  rejects (a converged pose).
* `evaluate`: the flagship checkpoint on 3 test pairs of 2048 points at
  B=2 (one ragged batch) with point-to-plane ICP at 5 iterations, against
  the JAX package's `evaluate` of the same weights.  Per-pair Euler angles
  and RRE within 5e-3 deg, translations and RTE within 5e-4 m: the trained
  forward's 5e-5 / 5e-4 m gates in the evaluator's units.
* A train checkpoint directory the port wrote (`fit`'s `ckpt/last`) is
  weights for `zoo.build`, `evaluate` and `python -m
  pcd_reg_hregnet_torch.evaluate` alike: `reg_v11` and `reg_v6` (MI
  discriminators, kept out of the model) at small levels after one CPU
  step; the poses `evaluate` reports equal those of the in-memory model
  exactly.
* The warm-started `reg_v11` checkpoint
  (`port_assets/r4_v11_warm_best_rre.npz`) at full width on the first 2
  pairs of its JAX-CPU eval (`v11_warm_r4_eval_jax_cpu.json`, no JAX at
  test time): the three network layers' poses within the card's per-pair
  gate (`chip_smoke.POSE_TOL_R` / `POSE_TOL_T`).  Its ICP layer is held on
  the card (`chip_smoke.py` warm_eval): ICP over 8096 points takes about a
  minute on one CPU thread.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcd_reg_hregnet_tpu.core.config import Config as JConfig
from pcd_reg_hregnet_tpu.data import load_dataset as jload_dataset
from pcd_reg_hregnet_tpu.data import pipeline as jpipeline
from pcd_reg_hregnet_tpu.eval import calib_eval as jcalib
from pcd_reg_hregnet_tpu.eval import icp as jicp
from pcd_reg_hregnet_tpu.eval.runner import evaluate as jevaluate
from pcd_reg_hregnet_tpu.eval.runner import evaluate_icp_only as jevaluate_icp_only
from pcd_reg_hregnet_tpu.train.loop import TrainState
from pcd_reg_hregnet_torch.data import load_dataset
from pcd_reg_hregnet_torch.eval import calib_eval, icp
from pcd_reg_hregnet_torch.eval.runner import evaluate, evaluate_icp_only
from pcd_reg_hregnet_torch.geometry import se3
from pcd_reg_hregnet_torch.models import zoo
from pcd_reg_hregnet_torch.utils import checkpoint

torch.set_num_threads(1)

EVAL_POINTS, EVAL_PAIRS, EVAL_BATCH, EVAL_ICP_ITERS = 2048, 3, 2, 5
DEG_TOL, M_TOL = 5e-3, 5e-4


def _poses(seed, b, rot, trans):
    """[b, 4, 4] f32 poses with rotations up to `rot` rad and translations
    up to `trans` m."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.uniform(-rot, rot, (b, 3)), rng.uniform(-trans, trans, (b, 3))], 1)
    return se3.exp(torch.from_numpy(x.astype(np.float32))).numpy()


def _close(got, want, tol, key=''):
    """Every leaf of two results dicts within `tol`."""
    if isinstance(want, dict):
        assert set(got) == set(want), key
        for k in want:
            _close(got[k], want[k], tol, f'{key}/{k}')
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   atol=tol, rtol=0, err_msg=key)


class TestCalibEval:
    @pytest.mark.parametrize('rot,trans', [(0.3, 0.5), (1e-3, 1e-3)])
    def test_matches_jax(self, rot, trans):
        got, want = calib_eval.MultiLayerCalibEval(2, 0.1, 1.0), jcalib.MultiLayerCalibEval(2, 0.1, 1.0)
        for batch in range(3):
            gt = _poses(batch, 5, 0.3, 0.5)
            pred = np.linalg.inv(gt) @ _poses(10 + batch, 5, rot, trans)
            pred = pred.astype(np.float32)
            for layer in range(2):
                got.add_batch(layer, gt, torch.from_numpy(pred))
                want.add_batch(layer, jnp.asarray(gt), jnp.asarray(pred))
        for layer in range(2):
            g, w = got.evaluators[layer], want.evaluators[layer]
            _close(g.get_results(), w.get_results(), 1e-5)
            _close(g.summary(), w.summary(), 1e-5)
        if rot < 0.01:
            assert got.evaluators[0].compute_recall() == 1.0

    def test_pose_deviation(self):
        """Poses rebuilt from `pred_calib`, pair for pair, per layer."""
        ev = calib_eval.MultiLayerCalibEval(2)
        gt = _poses(0, 4, 0.3, 0.5)
        pred = _poses(1, 4, 0.3, 0.5)
        moved = pred.copy()
        moved[2, :3, 3] += np.float32(0.02)
        moved[3, :3, :3] = _poses(2, 1, 0.01, 0.0)[0, :3, :3] @ moved[3, :3, :3]
        ev.add_batch(0, gt, torch.from_numpy(pred))
        ev.add_batch(1, gt, torch.from_numpy(moved))
        a = {'layer_0': ev.evaluators[0].get_results(), 'x': 1}
        b = {'layer_0': ev.evaluators[1].get_results()}
        (name, (dR, dt)), = calib_eval.pose_deviation(a, b).items()
        assert name == 'layer_0'
        np.testing.assert_allclose(dR[:3], 0, atol=1e-6)
        np.testing.assert_allclose(dt, [0, 0, 0.02, 0], atol=1e-6)
        assert 1e-3 < dR[3] < 2e-2
        assert all(np.all(d == 0) for pair in calib_eval.pose_deviation(a, a).values() for d in pair)


def _clouds(seed, b, n):
    """dst: [b, n, 3] points on planes and boxes (normals well defined)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-10, 10, (b, n, 2))
    z = np.where(rng.uniform(size=(b, n)) < 0.5, 0.0, np.round(xy[..., 0] / 5) + 2)
    return np.concatenate([xy, z[..., None]], -1).astype(np.float32)


class TestICP:
    @pytest.fixture(scope='class')
    def case(self):
        dst = _clouds(0, 2, 512)
        gt = _poses(1, 2, 0.1, 0.3)                        # src = gt^-1 applied to dst
        src = np.einsum('bij,bnj->bni', np.linalg.inv(gt)[:, :3, :3], dst) \
            + np.linalg.inv(gt)[:, None, :3, 3]
        src = src.astype(np.float32)
        return src, dst, gt

    def test_normals(self, case, monkeypatch):
        _, dst, _ = case
        got = icp.estimate_normals(torch.from_numpy(dst))
        want = np.asarray(jicp.estimate_normals(jnp.asarray(dst)))
        np.testing.assert_allclose(np.abs(np.sum(got.numpy() * want, -1)), 1.0, atol=1e-4)
        monkeypatch.setattr(icp, 'EIGH_BATCH', 100)      # eigh in chunks: same normals
        assert torch.equal(icp.estimate_normals(torch.from_numpy(dst)), got)

    @pytest.mark.parametrize('method', ['point_to_point', 'point_to_plane'])
    @pytest.mark.parametrize('start', ['perturbed', 'converged'])
    def test_solvers_match_jax(self, case, method, start):
        src, dst, gt = case
        init = gt @ (_poses(2, 2, 0.03, 0.2) if start == 'perturbed' else np.eye(4, dtype=np.float32))
        init = init.astype(np.float32)
        got = icp.refine(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(init),
                         method, max_iters=10).numpy()
        want = np.asarray(jicp.refine(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(init),
                                      method, max_iters=10))
        np.testing.assert_allclose(got[:, :3, :3], want[:, :3, :3], atol=1e-4, rtol=0)
        np.testing.assert_allclose(got[:, :3, 3], want[:, :3, 3], atol=1e-3, rtol=0)
        accepted = np.abs(got - init).max(axis=(1, 2)) > 1e-6
        if start == 'perturbed':   # the gate accepts, and ICP lands on the truth
            assert accepted.all()
            np.testing.assert_allclose(got, gt, atol=1e-3)
        else:                      # nothing to gain: the gate keeps the pose
            assert not accepted.any()

    def test_truncated_residual(self, case):
        src, dst, gt = case
        got = icp.truncated_residual(torch.from_numpy(src), torch.from_numpy(dst),
                                     torch.from_numpy(np.eye(4, dtype=np.float32)[None]
                                                      .repeat(2, 0)), 0.5).numpy()
        want = np.asarray(jicp.truncated_residual(jnp.asarray(src), jnp.asarray(dst),
                                                  jnp.eye(4)[None].repeat(2, 0), 0.5))
        np.testing.assert_allclose(got, want, rtol=1e-5)


class TestEvaluate:
    @pytest.fixture(scope='class')
    def cfgs(self):
        cfg = checkpoint.load_config(checkpoint.FLAGSHIP)
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, pcd_min_samples=EVAL_POINTS,
                                                   batch_size=EVAL_BATCH))
        with open(checkpoint.meta_path(checkpoint.FLAGSHIP)) as f:
            jcfg = JConfig.from_json(json.load(f)['config'])
        jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data, pcd_min_samples=EVAL_POINTS,
                                                     batch_size=EVAL_BATCH))
        return cfg, jcfg

    def test_matches_jax_evaluate(self, cfgs, tmp_path):
        cfg, jcfg = cfgs
        ds = load_dataset(cfg.data, 'test', length=EVAL_PAIRS)
        jds = jload_dataset(jcfg.data, 'test', length=EVAL_PAIRS)
        jds._table = jpipeline.perturbation_table('', 256, jcfg.data, seed=2)[:EVAL_PAIRS]
        variables = checkpoint.load_variables(checkpoint.FLAGSHIP)
        state = TrainState(step=jnp.zeros((), jnp.int32),
                           params={'model': variables['params']},
                           batch_stats={'model': variables['batch_stats']}, opt_state=None)
        want = jevaluate(jcfg, state, icp='point_to_plane', icp_iters=EVAL_ICP_ITERS, dataset=jds)
        path = tmp_path / 'results.json'
        got = evaluate(cfg, checkpoint.FLAGSHIP, icp='point_to_plane', icp_iters=EVAL_ICP_ITERS,
                       dataset=ds, results_path=str(path), device='cpu')
        with open(path) as f:
            assert json.load(f) == json.loads(json.dumps(got))
        assert set(got) == set(want)
        for key in ('dataset', 'model', 'translation', 'rotation', 'distribution', 'icp'):
            assert got[key] == want[key], key
        for layer in range(4):
            g, w = got[f'layer_{layer}'], want[f'layer_{layer}']
            assert set(g) == set(w) and len(g['rre']) == EVAL_PAIRS
            for key in ('pred_calib', 'error_calib'):
                _close(np.asarray(g[key])[:, :3], np.asarray(w[key])[:, :3], DEG_TOL, key)
                _close(np.asarray(g[key])[:, 3:], np.asarray(w[key])[:, 3:], M_TOL, key)
            _close(g['rre'], w['rre'], DEG_TOL, 'rre')
            _close(g['rte'], w['rte'], M_TOL, 'rte')
            _close(g['mean_error'], w['mean_error'], DEG_TOL, 'mean_error')
            _close(g['sd'] + g['mean_sd'] + g['mean_sd_dRT'],
                   w['sd'] + w['mean_sd'] + w['mean_sd_dRT'], DEG_TOL, 'sd')
            assert g['recall'] == w['recall']
        for key in ('summary', 'summary_network'):
            _close(got[key], want[key], DEG_TOL, key)

    def test_refusals(self, cfgs):
        cfg, _ = cfgs
        with pytest.raises(RuntimeError, match='process group'):   # sharding needs ranks
            evaluate(cfg, checkpoint.FLAGSHIP, seq_parallel=2, device='cpu')
        with pytest.raises(ValueError, match='ICP'):
            evaluate(cfg, checkpoint.FLAGSHIP, icp='open3d', device='cpu')
        other = cfg.replace(model=dataclasses.replace(cfg.model, ptv3_depths=(1, 1, 1)))
        with pytest.raises(ValueError, match='another model configuration'):
            evaluate(other, checkpoint.FLAGSHIP, device='cpu')


class TestICPOnlyAndServe:
    @pytest.mark.parametrize('method', ['point_to_point', 'point_to_plane'])
    def test_icp_only_matches_jax(self, method):
        cfg = checkpoint.load_config(checkpoint.FLAGSHIP)
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, pcd_min_samples=512,
                                                   batch_size=EVAL_BATCH))
        with open(checkpoint.meta_path(checkpoint.FLAGSHIP)) as f:
            jcfg = JConfig.from_json(json.load(f)['config'])
        jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data, pcd_min_samples=512,
                                                     batch_size=EVAL_BATCH))
        jds = jload_dataset(jcfg.data, 'test', length=EVAL_PAIRS)
        jds._table = jpipeline.perturbation_table('', 256, jcfg.data, seed=2)[:EVAL_PAIRS]
        want = jevaluate_icp_only(jcfg, icp=method, icp_iters=10, dataset=jds)
        got = evaluate_icp_only(cfg, icp=method, icp_iters=10, device='cpu',
                                dataset=load_dataset(cfg.data, 'test', length=EVAL_PAIRS))
        assert set(got) == set(want)
        for key in ('dataset', 'model', 'translation', 'rotation', 'icp', 'icp_iters',
                    'icp_threshold'):
            assert got[key] == want[key], key
        g, w = got['layer_0'], want['layer_0']
        _close(np.asarray(g['pred_calib'])[:, :3], np.asarray(w['pred_calib'])[:, :3], DEG_TOL)
        _close(np.asarray(g['pred_calib'])[:, 3:], np.asarray(w['pred_calib'])[:, 3:], M_TOL)
        _close(g['rre'], w['rre'], DEG_TOL)
        _close(g['rte'], w['rte'], M_TOL)

    def test_infer_pair_icp(self, monkeypatch):
        from pcd_reg_hregnet_torch import serve
        from pcd_reg_hregnet_torch.core.config import DataConfig
        from test_torch_model import LEVELS, SMALL
        model = zoo.build('model_v6', device='cpu', levels=LEVELS, **SMALL)
        model.data_cfg = DataConfig(pcd_min_samples=128, max_range=30.0)
        rng = np.random.default_rng(5)
        dst = rng.uniform(-20, 20, (300, 3)).astype(np.float32)
        dst[:40] *= 3.0                                     # beyond max_range
        src = (dst + np.float32(0.05)).astype(np.float32)
        seen = []
        register = serve.register
        monkeypatch.setattr(serve, 'register', lambda m, s, d, **kw: (
            seen.append((s.copy(), d.copy())), register(m, s, d, **kw))[1])
        out = serve.infer_pair(model, src, dst, device='cpu', icp='point_to_plane',
                               icp_iters=5)
        (s, d), = seen
        assert s.shape == d.shape == (1, 128, 3)
        assert np.linalg.norm(d, axis=-1).max() < 30.0
        want = icp.refine(torch.from_numpy(s), torch.from_numpy(d),
                          torch.tensor(out['transform'], dtype=torch.float32)[None],
                          'point_to_plane', max_iters=5)
        np.testing.assert_array_equal(np.asarray(out['transform_icp'], np.float32), want[0].numpy())
        assert 'transform_icp' not in serve.infer_pair(model, src, dst, device='cpu')


class TestTrainCheckpointWeights:
    @pytest.mark.parametrize('name', ['reg_v11', 'reg_v6'])
    def test_fit_checkpoint_is_weights_everywhere(self, name, tmp_path, monkeypatch):
        from pcd_reg_hregnet_torch import evaluate as evaluate_cli
        from pcd_reg_hregnet_torch.data import PairDataset, SyntheticPairSource, batch_iterator
        from pcd_reg_hregnet_torch.train import experiments, loop
        from test_torch_model import LEVELS, SMALL
        cfg = experiments.experiment(name)
        cfg = cfg.replace(
            model=dataclasses.replace(cfg.model, levels=LEVELS,
                                      **(SMALL if cfg.model.backbone == 'ptv3' else {})),
            data=dataclasses.replace(cfg.data, pcd_min_samples=256, batch_size=2),
            train=dataclasses.replace(cfg.train, epochs=1))
        train = PairDataset(SyntheticPairSource(2, 512, seed=0), cfg.data, 'train')
        test = load_dataset(cfg.data, 'test', length=3)
        state, _ = loop.fit(cfg, log_dir=str(tmp_path), max_steps=1, datasets=(train, test),
                            device='cpu')
        last = tmp_path / 'ckpt' / 'last'

        model = zoo.build(cfg.model.name, device='cpu', weights=last)
        want_sd = state.objective.model.state_dict()
        assert set(model.state_dict()) == set(want_sd)
        assert all(torch.equal(v, want_sd[k]) for k, v in model.state_dict().items())
        assert model.data_cfg == cfg.data
        if cfg.loss.mi:   # the discriminators are the objective's, not the model's
            assert checkpoint.read(last)[2] and not any('mi_loss' in k for k in want_sd)

        got = evaluate(cfg, last, dataset=test, device='cpu')
        mem = calib_eval.MultiLayerCalibEval(3, 0.1, 1.0)
        ref = state.objective.model.eval()
        with torch.no_grad():
            for batch in batch_iterator(test, 2, drop_last=False):
                out = ref(torch.from_numpy(batch['uncalibed_pcd']),
                          torch.from_numpy(batch['pcd_left']))
                for layer, (R, t) in enumerate(zip(out['rotation'], out['translation'])):
                    mem.add_batch(layer, batch['igt'], se3.pack(R, t))
        for layer in range(3):
            np.testing.assert_array_equal(got[f'layer_{layer}']['pred_calib'],
                                          mem.evaluators[layer].get_results()['pred_calib'])

        # the command line takes the directory too (on 3 pairs)
        seen = []

        def small(cfg_, weights, **kw):
            seen.append((cfg_, weights))
            return evaluate(cfg_, weights, dataset=test, **kw)
        monkeypatch.setattr(evaluate_cli, 'evaluate', small)
        assert evaluate_cli.main(['--weights', str(last), '--device', 'cpu']) == 0
        assert seen == [(cfg, str(last))]


class TestWarmCheckpoint:
    def test_first_pairs_match_the_jax_cpu_eval(self):
        import chip_smoke
        from pcd_reg_hregnet_torch.core.config import ASSETS_DIR
        with open(ASSETS_DIR / 'v11_warm_r4_eval_jax_cpu.json') as f:
            ref = json.load(f)
        meta = ref['reference']
        cfg = checkpoint.load_config(checkpoint.WARM)
        assert (meta['split'], meta['batch_size'], ref['model']) == ('test', 8, cfg.model.name)
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=2))
        got = evaluate(cfg, checkpoint.WARM, dataset=load_dataset(cfg.data, 'test', length=2),
                       device='cpu')
        first = {k: {'pred_calib': ref[k]['pred_calib'][:2]} for k in ref
                 if k.startswith('layer_')}
        dev = calib_eval.pose_deviation(got, first)
        assert sorted(dev) == ['layer_0', 'layer_1', 'layer_2']
        for name, (dR, dt) in dev.items():
            assert dR.max() <= chip_smoke.POSE_TOL_R and dt.max() <= chip_smoke.POSE_TOL_T, \
                (name, dR, dt)
