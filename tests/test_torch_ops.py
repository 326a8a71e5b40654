"""Port ops against the JAX package on the CPU: kNN, gathers,
serialization, weighted Kabsch, SE(3), and the serving preprocessing.

Tolerances: kNN indices and serialization orders must be identical;
distances and poses agree to f32 round-off of the different summation
orders (stated per test).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcd_reg_hregnet_tpu.data import pipeline as jpipe
from pcd_reg_hregnet_tpu.geometry import se3 as jse3
from pcd_reg_hregnet_tpu.geometry import so3 as jso3
from pcd_reg_hregnet_tpu.ops import neighbors as jnb
from pcd_reg_hregnet_tpu.ops import serialization as jser
from pcd_reg_hregnet_tpu.ops.procrustes import weighted_kabsch as jkabsch
from pcd_reg_hregnet_tpu.ops.sampling import gather_points as jgather_points
from pcd_reg_hregnet_torch.data import pipeline
from pcd_reg_hregnet_torch.geometry import se3, so3
from pcd_reg_hregnet_torch.ops import neighbors, serialization
from pcd_reg_hregnet_torch.ops.procrustes import weighted_kabsch
from pcd_reg_hregnet_torch.ops.sampling import gather_points

torch.set_num_threads(1)


def _rand(seed, shape, lo=-40.0, hi=40.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _rotations(seed, b):
    w = np.random.default_rng(seed).normal(size=(b, 3)).astype(np.float32)
    return np.array(jso3.exp(jnp.asarray(w)))


class TestNeighbors:
    def test_pairwise_sqdist(self):
        q, d = _rand(0, (2, 40, 3)), _rand(1, (2, 70, 3))
        ref = np.asarray(jnb.pairwise_sqdist(jnp.asarray(q), jnp.asarray(d)))
        got = neighbors.pairwise_sqdist(torch.from_numpy(q), torch.from_numpy(d))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-2)

    @pytest.mark.parametrize('m,n,k,dim', [(40, 70, 8, 3), (64, 64, 16, 3), (32, 48, 8, 32)])
    def test_knn_exact(self, m, n, k, dim):
        q, d = _rand(2, (2, m, dim)), _rand(3, (2, n, dim))
        rd, ri = jnb.knn(jnp.asarray(q), jnp.asarray(d), k, approx=False)
        gd, gi = neighbors.knn(torch.from_numpy(q), torch.from_numpy(d), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=1e-5, atol=1e-2)

    def test_knn_group_and_gathers(self):
        xyz1, xyz2 = _rand(4, (2, 32, 3)), _rand(5, (2, 96, 3))
        feat = _rand(6, (2, 96, 5), -1, 1)
        rg, rx = jnb.knn_group(jnp.asarray(xyz1), jnp.asarray(xyz2), jnp.asarray(feat), 8,
                               approx=False)
        gg, gx = neighbors.knn_group(torch.from_numpy(xyz1), torch.from_numpy(xyz2),
                                     torch.from_numpy(feat), 8)
        np.testing.assert_allclose(gg.numpy(), np.asarray(rg), atol=1e-5, rtol=1e-6)
        np.testing.assert_array_equal(gx.numpy(), np.asarray(rx))
        idx = np.random.default_rng(7).integers(0, 96, (2, 32)).astype(np.int32)
        np.testing.assert_array_equal(
            gather_points(torch.from_numpy(xyz2), torch.from_numpy(idx)).numpy(),
            np.asarray(jgather_points(jnp.asarray(xyz2), jnp.asarray(idx))))


class TestSerialization:
    def test_z_order_keys(self):
        g = np.random.default_rng(0).integers(0, 2 ** 20, (3, 50, 3)).astype(np.int32)
        rhi, rlo = jser.z_order_keys(jnp.asarray(g))
        hi, lo = serialization.z_order_keys(torch.from_numpy(g))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(rhi).astype(np.int64))
        np.testing.assert_array_equal(lo.numpy(), np.asarray(rlo).astype(np.int64))

    @pytest.mark.parametrize('grid', [0.01, 0.5, 1.0, 5.0])
    def test_serialize_matches(self, grid):
        # coarse grids put many points in one cell: the stable tie order matters
        xyz = _rand(1, (2, 300, 3))
        ro, ri = jser.serialize(jnp.asarray(xyz), grid, 'z')
        go, gi = serialization.serialize(torch.from_numpy(xyz), grid)
        np.testing.assert_array_equal(go.numpy(), np.asarray(ro))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))


class TestKabsch:
    def test_recovers_pose_like_jax(self):
        b, n = 3, 200
        src = _rand(0, (b, n, 3))
        R = _rotations(1, b)
        t = _rand(2, (b, 3), -1, 1)
        corres = np.einsum('bij,bnj->bni', R, src) + t[:, None, :]
        corres = corres + np.random.default_rng(3).normal(0, 0.05, corres.shape)
        w = _rand(4, (b, n), 0.0, 1.0)
        rR, rt = jkabsch(*(jnp.asarray(x, jnp.float32) for x in (src, corres, w)))
        gR, gt = weighted_kabsch(*(torch.tensor(x, dtype=torch.float32)
                                   for x in (src, corres, w)))
        # f32 SVD of a 40 m-scale covariance: ~1e-6 on R, ~1e-4 m on t
        np.testing.assert_allclose(gR.numpy(), np.asarray(rR), atol=2e-5)
        np.testing.assert_allclose(gt.numpy(), np.asarray(rt), atol=5e-4)
        np.testing.assert_allclose(gR.numpy(), R, atol=2e-3)

    def test_identity_fallback_on_nonfinite(self):
        src = _rand(5, (2, 16, 3))
        corres = src.copy()
        corres[1, 3, 0] = np.nan
        w = np.ones((2, 16), np.float32)
        R, t = weighted_kabsch(*map(torch.from_numpy, (src, corres, w)))
        np.testing.assert_array_equal(R[1].numpy(), np.eye(3, dtype=np.float32))
        np.testing.assert_array_equal(t[1].numpy(), np.zeros(3, np.float32))
        np.testing.assert_allclose(R[0].numpy(), np.eye(3), atol=1e-5)


class TestSE3:
    def test_pack_apply_compose_inverse(self):
        R = _rotations(0, 4)
        t = _rand(1, (4, 3), -2, 2)
        pts = _rand(2, (4, 10, 3))
        jT = jse3.pack(jnp.asarray(R), jnp.asarray(t))
        T = se3.pack(torch.from_numpy(R), torch.from_numpy(t))
        np.testing.assert_array_equal(T.numpy(), np.asarray(jT))
        gR, gt = se3.unpack(T)
        np.testing.assert_array_equal(gR.numpy(), R)
        np.testing.assert_array_equal(gt.numpy(), t)
        np.testing.assert_allclose(
            se3.apply(torch.from_numpy(R), torch.from_numpy(t), torch.from_numpy(pts)).numpy(),
            np.asarray(jse3.apply(jnp.asarray(R), jnp.asarray(t), jnp.asarray(pts))),
            atol=1e-5)
        np.testing.assert_allclose(se3.inverse(T).numpy(), np.asarray(jse3.inverse(jT)),
                                   atol=1e-6)
        T2 = T.flip(0)
        np.testing.assert_allclose(se3.compose(T, T2).numpy(),
                                   np.asarray(jse3.compose(jT, jT[::-1])), atol=1e-5)

    def test_hat(self):
        w = _rand(3, (5, 3), -1, 1)
        np.testing.assert_array_equal(so3.hat(torch.from_numpy(w)).numpy(),
                                      np.asarray(jso3.hat(jnp.asarray(w))))


class TestPipeline:
    @pytest.mark.parametrize('n,num', [(500, 256), (100, 256), (0, 16)])
    def test_range_filter_and_resample_match(self, n, num):
        pts = _rand(0, (n, 3), -100, 100)
        a, _ = pipeline.range_filter(pts, 80.0)
        b, _ = jpipe.range_filter(pts, 80.0)
        np.testing.assert_array_equal(a, b)
        ra, _ = pipeline.resample(a, num, np.random.default_rng(1))
        rb, _ = jpipe.resample(b, num, np.random.default_rng(1))
        np.testing.assert_array_equal(ra, rb)
        assert ra.shape == (num, 3)
