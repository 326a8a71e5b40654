"""The conv, regression and attention model family of the port against the
JAX package (CPU), and the trained A1 checkpoint (`reg_v6`, model_v2).

* Layers (`DescExtractor`, `CoarseReg(mi_outputs=True)`, `RegressionHead`,
  `Regression6DHead`, `KeypointDetectorSelfAttention`,
  `MultiHeadCrossAttention`, `correspondence_estimator`): random flax
  variables (batch statistics randomised) through `from_flax`, the same
  inputs, eval mode; f32 round-off of other summation orders, atol 1e-4
  (2e-4 where keypoints at a 40 m scale are attention-weighted) and rtol
  1e-4.
* The same layers in train mode (BatchNorm on batch statistics): the
  gradients of a random projection of every output, with respect to every
  parameter and input, within 1e-4 relative plus 1e-5 of the largest
  parameter (or that input's) gradient entry: a bias that feeds a
  BatchNorm has a zero gradient, which both packages meet to rounding.
* The forward of every preset but model_v6 (`test_torch_forward.py`) at
  small levels (64/32/16 keypoints from 256 points): all three levels' R
  within 5e-5 and t within 5e-4 m (the tolerances of the model_v6
  forward; t also 1e-4 relative, for model_v5's km-scale poses), every
  other output within 5e-4 + 1e-4 relative, each plus `SENSITIVITY` times
  how far f32 rounding alone moves that output in the port: the largest
  deviation of its f32 result from its f64 one and from two f32 runs on
  inputs moved by up to one ulp.  At random weights the pose heads can be
  ill-conditioned (the regression head maps 40 m centroids through
  untrained MLPs to rotation vectors of several radians; model_v5's
  correspondences are near-uniform averages of km-scale points), and the
  two packages then round apart by up to ~1e-3 of R at the finest level;
  a porting defect would not shrink with the inputs' last bits.  All runs
  must pick the same keypoints (within 1e-3 of their scale plus 1e-3 m,
  far below a point's spacing: model_v5's detectors weight the neighbours
  by column sums of the attention, which add up to k, so its keypoints
  grow to km).  For model_v5 the detectors' q and k projections are drawn
  at 4x the scale: at the plain draw their attention is near uniform, so
  a keypoint is the sum of its neighbour set, two keypoints that share one
  coincide exactly, and the next level's kNN meets exact distance ties,
  which `torch.topk` and the JAX package's chunked `top_k` break in orders
  of their own (neither promises one).
* `port_assets/r4_v6_50_best_rre.npz` equals the orbax restore of
  `ckpts/r4_v6_50_best_rre.tar.gz` leaf for leaf (the model's and the MI
  discriminators'), loads strictly, and its full-width forward of one
  2048-point test pair at B=1 gives JAX's poses within 5e-5 (R) and 5e-4 m
  (t) at every level.
"""
import dataclasses
import json
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcd_reg_hregnet_tpu.core.config import Config as JConfig
from pcd_reg_hregnet_tpu.data import load_dataset as jload_dataset
from pcd_reg_hregnet_tpu.models import attention as jattention
from pcd_reg_hregnet_tpu.models import build as jbuild
from pcd_reg_hregnet_tpu.models import layers as jlayers
from pcd_reg_hregnet_tpu.train.objective import RegistrationObjective as JObjective
from pcd_reg_hregnet_torch.models import attention, layers, zoo
from pcd_reg_hregnet_torch.train import experiments, loop
from pcd_reg_hregnet_torch.utils import checkpoint
from pcd_reg_hregnet_torch.utils.convert import from_flax
from test_torch_forward import _pair
from test_torch_model import J_LEVELS, LEVELS, SMALL, _compare, _port, _rand, _variables

torch.set_num_threads(1)

A1_POINTS = 2048


def _coarse_args():
    sx, dx = _rand(4, (2, 32, 3), -40, 40), _rand(5, (2, 32, 3), -40, 40)
    sd, dd = _rand(6, (2, 32, 16)), _rand(7, (2, 32, 16))
    sw, dw = _rand(8, (2, 32), 0.1, 2), _rand(9, (2, 32), 0.1, 2)
    return sx, sd, dx, dd, sw, dw


class TestLayers:
    @pytest.mark.parametrize('in_feats', [0, 8])
    def test_desc_extractor(self, in_feats):
        """On the detector's own grouped features and attention map."""
        grouped = _rand(0, (2, 16, 8, in_feats + 4))
        att_map = _rand(1, (2, 16, 8, 16), 0, 1)
        jm = jlayers.DescExtractor(out_channels=(8, 8, 16), desc_dim=24)
        v = _variables(jm, grouped, att_map)
        tm = _port(layers.DescExtractor(in_feats + 4, 16, (8, 8, 16), 24), v)
        _compare(jm.apply(v, grouped, att_map),
                 tm(torch.from_numpy(grouped), torch.from_numpy(att_map)), 1e-4)

    @pytest.mark.parametrize('use_neighbor,return_dists', [(True, False), (False, False),
                                                           (True, True)])
    def test_coarse_reg_mi_outputs(self, use_neighbor, return_dists):
        """model_v1's MI outputs, the batch-rolled primes included (they take
        the place of the circle distances when both are asked for)."""
        args = _coarse_args()
        jm = jlayers.CoarseReg(k=8, in_channels=16, use_neighbor=use_neighbor,
                               return_dists=return_dists, mi_outputs=True)
        v = _variables(jm, *args)
        tm = _port(layers.CoarseReg(8, 16, True, use_neighbor, return_dists, mi_outputs=True), v)
        got = tm(*map(torch.from_numpy, args))
        assert len(got) == 5
        assert torch.equal(got[2], torch.roll(got[1], 1, 0))
        assert torch.equal(got[4], torch.roll(got[3], 1, 0))
        _compare(jm.apply(v, *args), got, 1e-4)

    @pytest.mark.parametrize('head', ['regression', 'regression6d'])
    def test_regression_heads(self, head):
        src, cor = _rand(16, (2, 40, 3), -40, 40), _rand(17, (2, 40, 3), -40, 40)
        w = _rand(18, (2, 40), 0, 1)
        jm = {'regression': jlayers.RegressionHead,
              'regression6d': jlayers.Regression6DHead}[head]()
        v = _variables(jm, src, cor, w)
        tm = _port({'regression': layers.RegressionHead,
                    'regression6d': layers.Regression6DHead}[head](), v)
        R, t = tm(*map(torch.from_numpy, (src, cor, w)))
        _compare(jm.apply(v, src, cor, w), (R, t), 1e-4)
        eye = torch.eye(3).expand(2, 3, 3)
        torch.testing.assert_close(R @ R.transpose(1, 2), eye, atol=1e-5, rtol=0)

    @pytest.mark.parametrize('with_feats', [False, True])
    def test_self_attention_detector(self, with_feats):
        xyz = _rand(1, (2, 96, 3), -40, 40)
        feat = _rand(2, (2, 96, 8)) if with_feats else None
        w = _rand(3, (2, 96), 0.5, 1.5) if with_feats else None
        jm = jattention.KeypointDetectorSelfAttention(nsample=32, k=8, out_channels=(8, 8, 16))
        v = _variables(jm, xyz, feat, w)
        tm = _port(attention.KeypointDetectorSelfAttention(8 if with_feats else 0, 32, 8,
                                                           (8, 8, 16)), v)
        t = [None if a is None else torch.from_numpy(a) for a in (xyz, feat, w)]
        _compare(jm.apply(v, xyz, feat, w), tm(*t), 2e-4)

    def test_cross_attention_and_correspondences(self):
        left, right = _rand(4, (2, 24, 16)), _rand(5, (2, 20, 16))
        jm = jattention.MultiHeadCrossAttention(16)
        v = _variables(jm, left, right)
        tm = _port(attention.MultiHeadCrossAttention(16), v)
        jout = jm.apply(v, left, right)
        tout = tm(torch.from_numpy(left), torch.from_numpy(right))
        _compare(jout, tout, 1e-5)
        dst, sig = _rand(6, (2, 20, 3), -40, 40), _rand(7, (2, 24), 0.1, 2)
        _compare(jattention.correspondence_estimator(dst, jout[1], sig),
                 attention.correspondence_estimator(torch.from_numpy(dst), tout[1],
                                                    torch.from_numpy(sig)), 1e-4)


SENSITIVITY = 2


def _runs(tm, src, dst):
    """The port's f32 forward, and the runs that measure its rounding: f64,
    and f32 on inputs moved by up to one ulp (two seeds)."""
    with torch.no_grad():
        t32 = tm(torch.from_numpy(src), torch.from_numpy(dst))
        others = []
        for seed in (1, 2):
            rng = np.random.default_rng(seed)
            moved = [torch.from_numpy((a * (1 + rng.uniform(-1.2e-7, 1.2e-7, a.shape)))
                                      .astype(np.float32)) for a in (src, dst)]
            others.append(tm(*moved))
        others.append(tm.double()(torch.from_numpy(src).double(),
                                  torch.from_numpy(dst).double()))
    return t32, others


def _spread(got: torch.Tensor, others) -> float:
    """Largest deviation of one f32 output from its rounding runs."""
    return max(float((got.double() - o.double()).abs().max()) for o in others)


def _train_grads(jm, v, tm, args, seed):
    """Gradients of sum(out * r) over every output, in train mode, in both
    packages: (JAX params, JAX inputs), (port params, port inputs)."""
    outs = jax.eval_shape(lambda *a: jm.apply(v, *a), *args)
    rs = [_rand(seed + i, o.shape) for i, o in enumerate(jax.tree.leaves(outs))]
    live = [i for i, a in enumerate(args) if a is not None]

    def jf(params, *xs):
        full = list(args)
        for i, x in zip(live, xs):
            full[i] = x
        out, _ = jm.apply({'params': params, 'batch_stats': v.get('batch_stats', {})}, *full,
                          train=True, mutable=['batch_stats'])
        return sum(jnp.sum(o * r) for o, r in zip(jax.tree.leaves(out), rs))
    jg = jax.grad(jf, argnums=tuple(range(1 + len(live))))(v['params'],
                                                           *(args[i] for i in live))
    _port(tm, v).train()
    targs = [None if a is None else torch.from_numpy(a).requires_grad_() for a in args]
    out = tm(*targs)
    sum(torch.sum(o * torch.from_numpy(r)) for o, r in zip(jax.tree.leaves(out), rs)).backward()
    want = from_flax({'params': jg[0]})
    got = {n: p.grad for n, p in tm.named_parameters()}
    return (want, [np.asarray(g) for g in jg[1:]]), (got, [targs[i].grad for i in live])


def _close_grads(got, want, scale, err_msg):
    got = np.zeros_like(want) if got is None else got.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale, err_msg=err_msg)


class TestTrainModeGradients:
    @pytest.mark.parametrize('layer', ['desc_extractor', 'detector', 'self_attention_detector',
                                       'coarse_reg_mi', 'fine_reg_mi'])
    def test_layer_gradients_match_jax(self, layer):
        if layer == 'desc_extractor':
            args = (_rand(0, (2, 16, 8, 12)), _rand(1, (2, 16, 8, 16), 0, 1))
            jm = jlayers.DescExtractor(out_channels=(8, 8, 16), desc_dim=24)
            tm = layers.DescExtractor(12, 16, (8, 8, 16), 24)
        elif layer in ('detector', 'self_attention_detector'):
            args = (_rand(1, (2, 96, 3), -40, 40), _rand(2, (2, 96, 8)),
                    _rand(3, (2, 96), 0.5, 1.5))
            if layer == 'detector':
                jm = jlayers.KeypointDetector(nsample=32, k=8, out_channels=(8, 8, 16))
                tm = layers.KeypointDetector(8, 32, 8, (8, 8, 16))
            else:
                jm = jattention.KeypointDetectorSelfAttention(nsample=32, k=8,
                                                              out_channels=(8, 8, 16))
                tm = attention.KeypointDetectorSelfAttention(8, 32, 8, (8, 8, 16))
        elif layer == 'coarse_reg_mi':
            args = _coarse_args()
            jm = jlayers.CoarseReg(k=8, in_channels=16, mi_outputs=True)
            tm = layers.CoarseReg(8, 16, mi_outputs=True)
        else:
            args = _coarse_args()
            jm = jlayers.FineReg(k=8, in_channels=16, mi_outputs=True)
            tm = layers.FineReg(8, 16, mi_outputs=True)
        v = _variables(jm, *args)
        (want, want_in), (got, got_in) = _train_grads(jm, v, tm, args, 40)
        assert set(want) == set(got)
        scale = max(float(w.abs().max()) for w in want.values())
        for name in want:
            _close_grads(got[name], want[name].numpy(), scale, name)
        for i, (g, w) in enumerate(zip(got_in, want_in)):
            _close_grads(g, w, np.abs(w).max(), f'input {i}')


class TestPresetForward:
    @pytest.mark.parametrize('name', ['hregnet', 'model_v1', 'model_v2', 'model_v3',
                                      'model_v4', 'model_v5'])
    def test_forward_all_levels(self, name):
        src, dst = _pair(1, 2, 256)
        jm = jbuild(name, levels=J_LEVELS, **SMALL)
        v = _variables(jm, src, dst, seed=1, train=False)
        if name == 'model_v5':
            for i in (1, 2, 3):
                for dense in ('Dense_0', 'Dense_1'):
                    v['params'][f'detector_{i}'][dense]['kernel'] *= 4
        jout = jax.jit(lambda v, a, b: jm.apply(v, a, b, train=False))(v, src, dst)
        tm = zoo.build(name, device='cpu', levels=LEVELS, **SMALL)
        assert type(tm).__name__ == type(jm).__name__
        tm.load_state_dict(from_flax(v), strict=True)
        tout, others = _runs(tm, src, dst)
        for side in ('src_feats', 'dst_feats'):
            for lvl in (1, 2, 3):
                got = tout[side][f'xyz_{lvl}']
                scale = float(got.abs().max())
                assert _spread(got, [o[side][f'xyz_{lvl}'] for o in others]) < \
                    1e-3 * (1 + scale), (side, lvl)
        for lvl in range(3):
            for key, tol, rtol in (('rotation', 5e-5, 0), ('translation', 5e-4, 1e-4)):
                got = tout[key][lvl]
                spread = _spread(got, [o[key][lvl] for o in others])
                np.testing.assert_allclose(got.numpy(), np.asarray(jout[key][lvl]), rtol=rtol,
                                           atol=tol + SENSITIVITY * spread, err_msg=(key, lvl))
        assert set(tout) == set(jout)
        for key in jout:
            for j, (ref, got) in enumerate(zip(jax.tree.leaves(jout[key]),
                                               jax.tree.leaves(tout[key]))):
                spread = _spread(got, [jax.tree.leaves(o[key])[j] for o in others])
                np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                           atol=5e-4 + SENSITIVITY * spread, err_msg=key)


# --- the trained A1 checkpoint -----------------------------------------------

@pytest.fixture(scope='module')
def a1_orbax(tmp_path_factory):
    """`params`/`batch_stats` of the orbax checkpoint and its meta.json."""
    import orbax.checkpoint as ocp
    tmp = tmp_path_factory.mktemp('a1')
    tarball = checkpoint.ASSETS_DIR.parent / 'ckpts' / 'r4_v6_50_best_rre.tar.gz'
    subprocess.run(['tar', 'xzf', str(tarball), '-C', str(tmp)], check=True)
    (meta,) = tmp.glob('*/meta.json')
    restored = ocp.StandardCheckpointer().restore(str(meta.parent))
    return restored, json.loads(meta.read_text())


class TestA1Checkpoint:
    def test_npz_equals_orbax_restore(self, a1_orbax):
        """Model leaves under `params/`, `batch_stats/`; the MI
        discriminators under `objective/params/mi_loss/`."""
        restored, meta = a1_orbax
        assert json.loads(checkpoint.meta_path(checkpoint.A1).read_text()) == meta
        want = {}
        for coll in ('params', 'batch_stats'):
            for top, sub in restored[coll].items():
                prefix = [coll] if top == 'model' else ['objective', coll, top]
                for path, leaf in jax.tree_util.tree_leaves_with_path(sub):
                    want['/'.join(prefix + [p.key for p in path])] = np.asarray(leaf)
        assert set(restored['params']) == {'model', 'mi_loss'}
        with np.load(checkpoint.A1) as npz:
            assert sorted(npz.files) == sorted(want)
            for k, v in want.items():
                np.testing.assert_array_equal(npz[k], v, err_msg=k)
        assert sum(np.asarray(a).size for a in jax.tree.leaves(restored['params'])) == 2822503

    def test_strict_loads_and_config(self, a1_orbax):
        cfg = checkpoint.load_config(checkpoint.A1)
        want = experiments.experiment('reg_v6')
        assert (cfg.model, cfg.loss) == (want.model, want.loss)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            JConfig.from_json(a1_orbax[1]['config']))
        assert cfg.model.name == 'model_v2' and cfg.loss.mi and cfg.loss.chamfer
        assert cfg.data == checkpoint.load_config(checkpoint.FLAGSHIP).data
        model = zoo.build('model_v2', device='cpu', weights=checkpoint.A1)
        assert set(model.state_dict()) == set(checkpoint.load(checkpoint.A1)[1])
        mi = checkpoint.load_objective(checkpoint.A1)
        assert tuple(mi['mi_loss.global_d.Dense_0.weight'].shape) == (256, 1024)
        assert tuple(mi['mi_loss.local_d.Dense_0.weight'].shape) == (64, 256)
        state = loop.create_state(cfg, 10, device='cpu', init=checkpoint.A1)
        got = state.objective.mi_loss.state_dict()
        assert set(got) == {k[len('mi_loss.'):] for k in mi}
        assert all(torch.equal(got[k[len('mi_loss.'):]], v) for k, v in mi.items())
        # a checkpoint without the discriminators cannot start an MI run
        flag = checkpoint.load_config(checkpoint.FLAGSHIP)
        with pytest.raises(ValueError, match='objective holds'):
            loop.create_state(flag.replace(loss=cfg.loss), 10, device='cpu',
                              init=checkpoint.FLAGSHIP)

    def test_trained_forward_matches_jax(self):
        cfg = checkpoint.load_config(checkpoint.A1)
        jcfg = JConfig.from_json(json.loads(checkpoint.meta_path(checkpoint.A1).read_text())
                                 ['config'])
        ds = jload_dataset(dataclasses.replace(jcfg.data, pcd_min_samples=A1_POINTS), 'test')
        item = ds[0]
        src, dst = item['uncalibed_pcd'][None], item['pcd_left'][None]
        variables = checkpoint.load_variables(checkpoint.A1)
        jobj = JObjective(jcfg)
        jv = {'params': {'model': variables['params'],
                         **variables['objective']['params']},
              'batch_stats': {'model': variables['batch_stats']}}
        batch = {'uncalibed_pcd': src, 'pcd_left': dst, 'igt': item['igt'][None]}
        jloss, jmetrics, jout = jax.jit(lambda v, b: jobj.apply(v, b, train=False))(jv, batch)
        assert cfg.model.name == 'model_v2'
        tm = zoo.build('model_v2', device='cpu', weights=checkpoint.A1)
        with torch.no_grad():
            tout = tm(torch.from_numpy(src), torch.from_numpy(dst))
        for lvl in range(3):
            np.testing.assert_allclose(tout['rotation'][lvl].numpy(),
                                       np.asarray(jout['rotation'][lvl]), atol=5e-5, rtol=0)
            np.testing.assert_allclose(tout['translation'][lvl].numpy(),
                                       np.asarray(jout['translation'][lvl]), atol=5e-4, rtol=0)
        err = np.asarray(jout['rotation'][2])[0] @ item['igt'][:3, :3]
        assert np.degrees(np.arccos(np.clip((np.trace(err) - 1) / 2, -1, 1))) < 2.0
        # the eval-mode objective, MI at B=1 included (degenerate, but run)
        state = loop.create_state(cfg, 10, device='cpu', init=checkpoint.A1)
        state.objective.eval()
        with torch.no_grad():
            loss, metrics, _ = state.objective({k: torch.tensor(v) for k, v in batch.items()})
        for key in ('tf_loss', 'chamfer_loss', 'mi_loss', 'loss'):
            assert float(metrics[key]) == pytest.approx(float(jmetrics[key]), rel=1e-3,
                                                        abs=1e-4), key
