"""Port layers against the JAX package (CPU).

Each flax module is initialised at a small size, its batch statistics are
randomised (so BatchNorm is not an identity), its variables go through
`utils.convert.from_flax` into the port's module (strict `load_state_dict`),
and both run the same numpy inputs in eval mode.  `test_torch_forward.py`
holds the whole `model_v6` forward.  Tolerances are f32
round-off of different summation orders; the detector and encoder ones
also carry attention-weighted keypoints at a 40 m scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcd_reg_hregnet_tpu.core.config import LevelConfig as JLevelConfig
from pcd_reg_hregnet_tpu.models import layers as jlayers
from pcd_reg_hregnet_tpu.models import ptv3 as jptv3
from pcd_reg_hregnet_torch.core.config import LevelConfig
from pcd_reg_hregnet_torch.models import layers, ptv3
from pcd_reg_hregnet_torch.utils.convert import from_flax

torch.set_num_threads(1)

SMALL = dict(ptv3_depths=(1, 1), ptv3_num_heads=(2, 4), ptv3_patch_sizes=(16, 16, 16))
J_LEVELS = (JLevelConfig(64, 16, (16, 16, 32), 32), JLevelConfig(32, 8, (32, 32, 64), 64),
            JLevelConfig(16, 8, (64, 64, 128), 128))
LEVELS = tuple(LevelConfig(l.nsample, l.k, l.conv_channels, l.desc_dim) for l in J_LEVELS)


def _rand(seed, shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _variables(jmod, *args, seed=0, **kw):
    """Random flax variables of `jmod`'s shapes (no flax init is compiled):
    kernels N(0, 1/fan_in), biases N(0, 0.1), scales U(0.5, 1.5), batch
    statistics random so that BatchNorm is not an identity."""
    shapes = jax.eval_shape(lambda *a: jmod.init(jax.random.PRNGKey(0), *a, **kw), *args)
    rng = np.random.default_rng(seed + 100)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == 'kernel':
            a = rng.normal(0, 1, shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ('bias', 'mean'):
            a = rng.normal(0, 0.1, shape)
        else:                                   # BatchNorm/LayerNorm scale, var
            a = rng.uniform(0.5, 1.5, shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port(tmod, variables):
    tmod.load_state_dict(from_flax(variables), strict=True)
    return tmod.eval()


def _compare(jouts, touts, atol):
    jl, tl = jax.tree.leaves(jouts), [t for t in jax.tree.leaves(touts)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=atol, rtol=1e-4)


class TestLayers:
    def test_conv_bn_relu_and_mlp_head(self):
        x = _rand(0, (2, 8, 4, 6))
        jm = jlayers.ConvBNReLU((16, 8))
        v = _variables(jm, x)
        _compare(jm.apply(v, x), _port(layers.ConvBNReLU(6, (16, 8)), v)(torch.from_numpy(x)),
                 1e-5)
        jm = jlayers.MLPHead((12, 12), 1)
        v = _variables(jm, x)
        _compare(jm.apply(v, x), _port(layers.MLPHead(6, (12, 12), 1), v)(torch.from_numpy(x)),
                 1e-5)

    @pytest.mark.parametrize('with_feats,use_fps', [(False, True), (True, True),
                                                    (True, False)])
    def test_keypoint_detector(self, with_feats, use_fps):
        xyz = _rand(1, (2, 96, 3), -40, 40)
        feat = _rand(2, (2, 96, 8)) if with_feats else None
        w = _rand(3, (2, 96), 0.5, 1.5) if with_feats else None
        jm = jlayers.KeypointDetector(nsample=32, k=8, out_channels=(8, 8, 16),
                                      use_fps=use_fps)
        v = _variables(jm, xyz, feat, w)
        tm = _port(layers.KeypointDetector(8 if with_feats else 0, 32, 8, (8, 8, 16),
                                           use_fps), v)
        t = [None if a is None else torch.from_numpy(a) for a in (xyz, feat, w)]
        _compare(jm.apply(v, xyz, feat, w), tm(*t), 2e-4)

    @pytest.mark.parametrize('return_dists,use_sim,use_neighbor', [
        (False, True, True), (True, True, True), (False, False, True), (False, True, False)])
    def test_coarse_reg(self, return_dists, use_sim, use_neighbor):
        sx, dx = _rand(4, (2, 32, 3), -40, 40), _rand(5, (2, 32, 3), -40, 40)
        sd, dd = _rand(6, (2, 32, 16)), _rand(7, (2, 32, 16))
        sw, dw = _rand(8, (2, 32), 0.1, 2), _rand(9, (2, 32), 0.1, 2)
        args = (sx, sd, dx, dd, sw, dw)
        jm = jlayers.CoarseReg(k=8, in_channels=16, return_dists=return_dists,
                               use_sim=use_sim, use_neighbor=use_neighbor)
        v = _variables(jm, *args)
        tm = _port(layers.CoarseReg(8, 16, use_sim, use_neighbor, return_dists), v)
        _compare(jm.apply(v, *args), tm(*map(torch.from_numpy, args)), 1e-4)

    @pytest.mark.parametrize('mi_outputs', [False, True])
    def test_fine_reg(self, mi_outputs):
        sx, dx = _rand(10, (2, 32, 3), -40, 40), _rand(11, (2, 32, 3), -40, 40)
        sd, dd = _rand(12, (2, 32, 8)), _rand(13, (2, 32, 8))
        sw, dw = _rand(14, (2, 32), 0.1, 2), _rand(15, (2, 32), 0.1, 2)
        args = (sx, sd, dx, dd, sw, dw)
        jm = jlayers.FineReg(k=8, in_channels=8, mi_outputs=mi_outputs)
        v = _variables(jm, *args)
        tm = _port(layers.FineReg(8, 8, mi_outputs=mi_outputs), v)
        _compare(jm.apply(v, *args), tm(*map(torch.from_numpy, args)), 1e-4)

    def test_svd_head_and_similarity(self):
        src, cor = _rand(16, (2, 40, 3), -40, 40), _rand(17, (2, 40, 3), -40, 40)
        w = _rand(18, (2, 40), 0, 1)
        _compare(jlayers.SVDHead()(src, cor, w),
                 layers.SVDHead()(*map(torch.from_numpy, (src, cor, w))), 5e-4)
        a, b = _rand(19, (2, 10, 6)), _rand(20, (2, 12, 6))
        _compare(jlayers._cosine_similarity_matrix(a, b),
                 layers._cosine_similarity_matrix(torch.from_numpy(a), torch.from_numpy(b)),
                 1e-6)
        _compare(jlayers._safe_dist(a), layers._safe_dist(torch.from_numpy(a)), 1e-6)


class TestPTv3:
    def test_depthwise_conv_and_knn_cpe(self):
        x = _rand(0, (2, 32, 8))
        jm = jptv3.SerializedDepthwiseConv(8, kernel=5)
        v = _variables(jm, x)
        _compare(jm.apply(v, x), _port(ptv3.SerializedDepthwiseConv(8, 5), v)(
            torch.from_numpy(x)), 1e-5)
        xyz = _rand(1, (2, 32, 3), -40, 40)
        jidx, jrel = jptv3.cpe_neighbors(jnp.asarray(xyz))
        idx, rel = ptv3.cpe_neighbors(torch.from_numpy(xyz))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(rel.numpy(), np.asarray(jrel), atol=1e-5)
        jm = jptv3.KnnCPE(8)
        v = _variables(jm, x, jidx, jrel)
        _compare(jm.apply(v, x, jidx, jrel), _port(ptv3.KnnCPE(8), v)(
            torch.from_numpy(x), idx, rel), 1e-5)

    def test_patch_attention_and_mlp(self):
        x = _rand(2, (2, 32, 16))
        jm = jptv3.PatchAttention(16, 2, 16)
        v = _variables(jm, x)
        _compare(jm.apply(v, x), _port(ptv3.PatchAttention(16, 2, 16), v)(
            torch.from_numpy(x)), 1e-5)
        jm = jptv3.PTv3Mlp(16)
        v = _variables(jm, x)
        _compare(jm.apply(v, x), _port(ptv3.PTv3Mlp(16), v)(torch.from_numpy(x)), 1e-5)

    def test_patch_attention_takes_strided_views(self):
        # the module hands the kernel views of the qkv projection and writes
        # into an [R, K, H, d] buffer; the result must equal the path through
        # contiguous copies, and still match the JAX module
        from pcd_reg_hregnet_torch.ops.kernels.attention import patch_attention
        x = _rand(5, (2, 48, 24))
        jm = jptv3.PatchAttention(24, 2, 16)
        v = _variables(jm, x)
        tm = _port(ptv3.PatchAttention(24, 2, 16), v)
        with torch.no_grad():
            got = tm(torch.from_numpy(x))
            qkv = tm.Dense_0(torch.from_numpy(x)).reshape(6, 16, 3, 2, 12)
            q, k, w = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
            out = patch_attention(q, k, w, 12 ** -0.5).transpose(1, 2).reshape(2, 48, 24)
            assert torch.equal(got, tm.Dense_1(out))
        _compare(jm.apply(v, x), got, 1e-5)

    @pytest.mark.parametrize('cpe', ['knn', 'curve', 'none'])
    def test_block(self, cpe):
        x = _rand(3, (2, 32, 16))
        xyz = _rand(4, (2, 32, 3), -40, 40)
        jidx, jrel = jptv3.cpe_neighbors(jnp.asarray(xyz))
        jm = jptv3.PTv3Block(16, 2, 16, cpe=cpe)
        v = _variables(jm, x, jidx, jrel)
        tm = _port(ptv3.PTv3Block(16, 2, 16, cpe=cpe), v)
        idx, rel = ptv3.cpe_neighbors(torch.from_numpy(xyz))
        _compare(jm.apply(v, x, jidx, jrel), tm(torch.from_numpy(x), idx, rel), 1e-4)

    def test_encoder(self):
        xyz, feat = _rand(5, (2, 64, 3), -40, 40), _rand(6, (2, 64, 8))
        jm = jptv3.PointTransformerEncoder(16, depths=(1, 1), num_heads=(2, 4),
                                           patch_size=16, cpe='knn')
        v = _variables(jm, xyz, feat)
        tm = _port(ptv3.PointTransformerEncoder(8, 16, (1, 1), (2, 4), 16, cpe='knn'), v)
        _compare(jm.apply(v, xyz, feat), tm(torch.from_numpy(xyz), torch.from_numpy(feat)),
                 2e-4)


class TestUnportedConfig:
    @pytest.mark.parametrize('override', [{'compute_dtype': 'float16'}])
    def test_build_refuses_values_the_port_does_not_implement(self, override):
        from pcd_reg_hregnet_torch.models import zoo
        with pytest.raises(NotImplementedError, match=next(iter(override))):
            zoo.build('model_v6', device='cpu', levels=LEVELS, **SMALL, **override)
