"""Geometry and neighbour helpers of the port against the JAX package (CPU).

SE(3) adjoints, SO(3) inverse / geodesic distance / random rotations, the
quaternion conversions, `mat2xyzrpy`, z-order decoding, ball query, 3-NN
interpolation and the inverse-Gaussian decalibrations: the same numpy
inputs through both packages.  Samplers draw from their own generators
(JAX's threefry stream is not reproduced), so they are held to the same
distribution, not the same numbers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcd_reg_hregnet_tpu.geometry import perturbations as jperturbations
from pcd_reg_hregnet_tpu.geometry import rotations as jrotations
from pcd_reg_hregnet_tpu.geometry import se3 as jse3
from pcd_reg_hregnet_tpu.geometry import so3 as jso3
from pcd_reg_hregnet_tpu.ops import neighbors as jneighbors
from pcd_reg_hregnet_tpu.ops import serialization as jserialization
from pcd_reg_hregnet_torch.geometry import perturbations, rotations, se3, so3
from pcd_reg_hregnet_torch.ops import neighbors, serialization

torch.set_num_threads(1)
TOL = 1e-5


def _twists(seed, n=16, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, (n, 6))).astype(np.float32)


def _rotations(seed, n=16, angles=None):
    """Rotations [n, 3, 3] f32 about random axes, by `angles` (radians) or
    random ones."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.uniform(0, np.pi, n) if angles is None else np.asarray(angles)
    return np.asarray(jso3.exp(jnp.asarray((axis * ang[:, None]).astype(np.float32))))


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


class TestSE3SO3:
    def test_adjoint_and_little_adjoint(self):
        T = np.asarray(jse3.exp(jnp.asarray(_twists(0))))
        _close(se3.adjoint(torch.from_numpy(T)), jse3.adjoint(jnp.asarray(T)))
        x = _twists(1)
        _close(se3.ad(torch.from_numpy(x)), jse3.ad(jnp.asarray(x)))
        # Ad(exp(x)) x = x: a twist is fixed by its own adjoint
        T = se3.exp(torch.from_numpy(x))
        _close(torch.einsum('nij,nj->ni', se3.adjoint(T), torch.from_numpy(x)), x, 1e-4)

    def test_inverse_and_geodesic_distance(self):
        R1, R2 = _rotations(2), _rotations(3)
        _close(so3.inverse(torch.from_numpy(R1)), jso3.inverse(jnp.asarray(R1)), 0)
        _close(so3.geodesic_distance(torch.from_numpy(R1), torch.from_numpy(R2)),
               jso3.geodesic_distance(jnp.asarray(R1), jnp.asarray(R2)))

    @pytest.mark.parametrize('deg', [0.0, 0.01, 0.05, 0.5, 5.0])
    def test_geodesic_distance_near_identity(self, deg):
        # R1^T R2 a small turn.  The JAX function's f32 arccos is steep near
        # 1 (one ulp of the trace reads ~1e-4 rad there); the port's atan2
        # form holds the f64 angle within 1e-5, and JAX's within JAX's own
        # distance from it
        R1 = _rotations(4).astype(np.float64)
        R2 = R1 @ _rotations(5, angles=np.full(16, np.deg2rad(deg))).astype(np.float64)
        M = np.swapaxes(R1, 1, 2) @ R2
        skew = np.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0],
                         M[:, 1, 0] - M[:, 0, 1]], -1)
        truth = np.arctan2(0.5 * np.linalg.norm(skew, axis=-1), (np.trace(M, axis1=1, axis2=2)
                                                                  - 1) / 2)
        R1, R2 = R1.astype(np.float32), R2.astype(np.float32)
        got = so3.geodesic_distance(torch.from_numpy(R1), torch.from_numpy(R2)).numpy()
        want = np.asarray(jso3.geodesic_distance(jnp.asarray(R1), jnp.asarray(R2)))
        _close(got, truth)
        assert np.all(np.abs(got - want) <= np.abs(want - truth) + TOL)

    def test_random_rotation(self):
        R = so3.random_rotation(torch.Generator().manual_seed(0), (2000,))
        again = so3.random_rotation(torch.Generator().manual_seed(0), (2000,))
        assert R.shape == (2000, 3, 3) and torch.equal(R, again)
        _close(R @ R.transpose(1, 2), np.broadcast_to(np.eye(3), (2000, 3, 3)), 1e-5)
        _close(torch.linalg.det(R), np.ones(2000), 1e-5)
        # the angle is uniform in [0, pi): mean pi/2
        ang = so3.geodesic_distance(torch.eye(3).expand_as(R), R).numpy()
        assert ang.max() <= np.pi and abs(ang.mean() - np.pi / 2) < 0.05


class TestRotations:
    def test_quaternion_round_trip(self):
        q = np.random.default_rng(6).normal(size=(64, 4)).astype(np.float32)
        R = rotations.quaternion_to_matrix(torch.from_numpy(q))
        _close(R, jrotations.quaternion_to_matrix(jnp.asarray(q)))
        back = rotations.matrix_to_quaternion(R)
        _close(back, jrotations.matrix_to_quaternion(jnp.asarray(R.numpy())))
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        _close(back, qn * np.sign(qn[:, :1]), 1e-5)

    @pytest.mark.parametrize('deg', [0.0, 1e-3, 90.0, 179.0, 179.999, 180.0])
    def test_matrix_to_quaternion_branches(self, deg):
        # near 0 the w branch, near 180 deg the largest-diagonal branches,
        # with their ties decided as in JAX (earlier axes first)
        axes = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 1, 1],
                         [0.3, -0.5, 0.8], [-1, 2, -3]], np.float64)
        axes /= np.linalg.norm(axes, axis=1, keepdims=True)
        w = (axes * np.deg2rad(deg)).astype(np.float32)
        R = np.asarray(jso3.exp(jnp.asarray(w)))
        got = rotations.matrix_to_quaternion(torch.from_numpy(R))
        _close(got, jrotations.matrix_to_quaternion(jnp.asarray(R)))

    def test_quaternion_distance_and_mat2xyzrpy(self):
        q1, q2 = (np.random.default_rng(s).normal(size=(32, 4)).astype(np.float32)
                  for s in (7, 8))
        q1 /= np.linalg.norm(q1, axis=1, keepdims=True)
        q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
        _close(rotations.quaternion_distance(torch.from_numpy(q1), torch.from_numpy(q2)),
               jrotations.quaternion_distance(jnp.asarray(q1), jnp.asarray(q2)))
        T = np.asarray(jse3.exp(jnp.asarray(_twists(9, 32))))
        _close(rotations.mat2xyzrpy(torch.from_numpy(T)), jrotations.mat2xyzrpy(jnp.asarray(T)))


class TestZOrderDecode:
    def test_round_trip_and_against_jax(self):
        g = np.random.default_rng(10).integers(0, 1 << 20, (4, 256, 3)).astype(np.int32)
        g[0, :3] = [[0, 0, 0], [(1 << 20) - 1] * 3, [1, 2, 3]]
        hi, lo = serialization.z_order_keys(torch.from_numpy(g))
        jhi, jlo = jserialization.z_order_keys(jnp.asarray(g))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
        got = serialization.z_order_decode(hi, lo)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), g)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jserialization.z_order_decode(
            jhi, jlo)))


def _grid_cloud(seed, B, N, spacing=1.0):
    """Points on an integer lattice (exact squared distances, many ties)."""
    return (np.random.default_rng(seed).integers(-4, 5, (B, N, 3)) * spacing).astype(np.float32)


class TestBallQuery:
    @pytest.mark.parametrize('radius,k', [(1.0, 4), (1.5, 8), (2.0, 16), (0.5, 3), (100.0, 5)])
    def test_against_jax(self, radius, k):
        # lattice clouds: ties at every distance; radius 0.5 leaves rows
        # whose only in-radius points are duplicates of the query itself,
        # and far queries have none at all
        db = _grid_cloud(11, 2, 64)
        q = np.concatenate([_grid_cloud(12, 2, 24), np.full((2, 4, 3), 50.0, np.float32)], 1)
        idx, mask = neighbors.ball_query(torch.from_numpy(q), torch.from_numpy(db), radius, k)
        jidx, jmask = jneighbors.ball_query(jnp.asarray(q), jnp.asarray(db), radius, k)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        m = mask.numpy()
        if radius < 100:
            assert (~m[:, -4:]).all() and (idx.numpy()[:, -4:] == 0).all()   # no neighbour
            assert ((m.sum(-1) < k) & m.any(-1)).any()                        # short rows
        else:
            assert m.all()

    def test_three_nn_interpolate(self):
        rng = np.random.default_rng(13)
        db = rng.uniform(-20, 20, (2, 64, 3)).astype(np.float32)
        q = rng.uniform(-20, 20, (2, 40, 3)).astype(np.float32)
        q[:, :5] = db[:, :5]                       # queries on database points
        f = rng.normal(size=(2, 64, 7)).astype(np.float32)
        got = neighbors.three_nn_interpolate(*map(torch.from_numpy, (q, db, f)))
        _close(got, jneighbors.three_nn_interpolate(*map(jnp.asarray, (q, db, f))))


class TestInverseGaussian:
    def test_sampler_matches_scipy_moments(self):
        # scipy's invgauss(mu, scale): mean mu * scale, variance mu^3 scale^2
        stats = pytest.importorskip('scipy.stats')
        for gen in (np.random.default_rng(14), torch.Generator().manual_seed(14)):
            for mu, scale in ((1.0, 0.1), (0.01, 0.002)):
                x = perturbations._sample_invgauss(gen, mu, scale, (40000,)).double().numpy()
                assert np.all(x > 0)
                mean, var = stats.invgauss.stats(mu, scale=scale, moments='mv')
                np.testing.assert_allclose(x.mean(), mean, rtol=0.05)
                np.testing.assert_allclose(x.var(), var, rtol=0.1)

    @pytest.mark.parametrize('mag_randomly', [True, False])
    def test_sample_igt_against_jax_distribution(self, mag_randomly):
        import jax
        n = 4000
        igt = perturbations.sample_igt(np.random.default_rng(15), 20.0, 0.5,
                                       'inverse_gaussian', mag_randomly, batch=n)
        jigt = np.asarray(jperturbations.sample_igt(
            jax.random.PRNGKey(15), 20.0, 0.5, 'inverse_gaussian', mag_randomly, batch=n))
        assert igt.shape == (n, 4, 4) and igt.dtype == torch.float32
        tw = se3.log(igt).numpy()
        jtw = np.asarray(jse3.log(jnp.asarray(jigt)))
        for a in (tw, jtw):        # the protocol's bounds, axes in the positive octant
            assert np.linalg.norm(a[:, :3], axis=1).max() <= np.deg2rad(20) + 1e-4
            assert np.abs(np.asarray(igt[:, :3, 3])).max() <= 0.5 + 1e-5
            assert (a[:, :3] > -1e-6).all()
        t, jt = igt[:, :3, 3].numpy(), jigt[:, :3, 3]
        assert (t > -1e-6).all() and (jt > -1e-6).all()
        # the same distribution: angle and translation norms, and the
        # direction's mean, within sampling error
        for a, b in ((np.linalg.norm(tw[:, :3], axis=1), np.linalg.norm(jtw[:, :3], axis=1)),
                     (np.linalg.norm(t, axis=1), np.linalg.norm(jt, axis=1))):
            np.testing.assert_allclose(a.mean(), b.mean(), rtol=0.05)
            np.testing.assert_allclose(a.std(), b.std(), rtol=0.1, atol=1e-4)
        for a, b in ((tw[:, :3], jtw[:, :3]), (t, jt)):
            da = a / np.linalg.norm(a, axis=1, keepdims=True)
            db = b / np.linalg.norm(b, axis=1, keepdims=True)
            np.testing.assert_allclose(da.mean(0), db.mean(0), atol=0.03)

    def test_sample_twist_inverse_gaussian(self):
        tw = perturbations.sample_twist(torch.Generator().manual_seed(16), 20.0, 0.5,
                                        'inverse_gaussian', shape=(64,))
        again = perturbations.sample_twist(torch.Generator().manual_seed(16), 20.0, 0.5,
                                           'inverse_gaussian', shape=(64,))
        assert tw.shape == (64, 6) and torch.equal(tw, again) and torch.isfinite(tw).all()
