"""The port's pose-graph SLAM (`pcd_reg_hregnet_torch/slam/`) against the
JAX package's (CPU).

Graphs are built as `tests/test_pose_graph.py` builds them (ring and
chunked graphs; numpy draws) and handed to both packages.  Tolerances:
* residuals and chi2 of the same poses: f32 round-off of SE(3) log/inverse
  chains, 1e-5 absolute on residuals, 1e-4 relative on chi2;
* `optimize`: both packages run the same Gauss-Newton in f32 with a 1e6
  anchor prior, whose dense solve loses ~1e-5 of the pose entries to
  rounding per iteration, in other summation orders: poses within 2e-4;
* `partition_graph`: every array equal;
* `distributed_optimize` on 4 gloo ranks (the graph's 20 edges padded to
  24, 6 per rank) and `schur_optimize` on 4 gloo ranks (one partition per
  rank) against the JAX package's on `make_mesh(4)` and the port's dense
  `optimize` within 1e-3 (the JAX test's own tolerance between the Schur
  and the dense solve; the dense-vs-sharded one is 1e-4);
* `build_pose_graph` + `icp_register_fn` recover the JAX test's drifting
  trajectory within 0.5 deg and 0.05 m;
* `model_register_fn` at small widths against the JAX package's on the
  same converted weights: measurements and chained poses within 1e-4,
  weights within 1e-5 (f32 round-off of the forward at a 10 m scale; the
  forward tolerances of `test_torch_forward.py`).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcd_reg_hregnet_tpu import slam as jslam
from pcd_reg_hregnet_tpu.geometry import se3 as jse3
from pcd_reg_hregnet_tpu.parallel.mesh import make_mesh
from pcd_reg_hregnet_torch import slam
from pcd_reg_hregnet_torch.geometry import se3, so3
from test_torch_parallel import spawn_ranks

torch.set_num_threads(1)


def _chain(rng, K, scale):
    """Ground-truth trajectory [K, 4, 4]: a random walk of normal twists."""
    tw = torch.from_numpy((rng.standard_normal((K - 1, 6)) * scale).astype(np.float32))
    gt = [torch.eye(4)]
    for k in range(K - 1):
        gt.append(gt[-1] @ se3.exp(tw[k]))
    return torch.stack(gt)


def _graph(rng, gt, edges_i, edges_j, noise, init_noise):
    """Noisy measurements of `gt` on the edges, an initial guess off by
    `init_noise` (pose 0 exact), unit weights; as jax arrays."""
    K, M = len(gt), len(edges_i)
    Z = torch.stack([se3.inverse(gt[a]) @ gt[b] for a, b in zip(edges_i, edges_j)])
    Z = Z @ se3.exp(torch.from_numpy((rng.standard_normal((M, 6)) * noise).astype(np.float32)))
    init = gt @ se3.exp(torch.from_numpy(
        (rng.standard_normal((K, 6)) * init_noise).astype(np.float32)))
    init[0] = gt[0]
    return jslam.PoseGraph(jnp.asarray(init.numpy()), jnp.asarray(edges_i, jnp.int32),
                           jnp.asarray(edges_j, jnp.int32), jnp.asarray(Z.numpy()),
                           jnp.ones((M,), jnp.float32)), gt.numpy()


@functools.lru_cache(maxsize=None)
def _ring(seed, K=16, noise=0.05, loop_closures=8):
    """`test_pose_graph.py::make_ring_graph`'s graph, drawn with numpy: an
    odometry chain and loop closures (i, i + 2) of a random walk."""
    rng = np.random.default_rng(seed)
    gt = _chain(rng, K, 0.4)
    ii = rng.integers(0, K - 3, loop_closures)
    edges_i = list(range(K - 1)) + ii.tolist()
    edges_j = list(range(1, K)) + (ii + 2).tolist()
    return _graph(rng, gt, edges_i, edges_j, noise, 0.3)


@functools.lru_cache(maxsize=None)
def _chunked(seed, noise=0.03, P=4, L=6):
    """`test_pose_graph.py::make_chunked_graph`'s graph, drawn with numpy:
    K = P * L poses, the odometry chain, an in-chunk closure per chunk and
    a loop closure between the first and the last pose."""
    rng = np.random.default_rng(seed)
    K = P * L
    gt = _chain(rng, K, 0.3)
    edges_i = list(range(K - 1)) + [p * L + 1 for p in range(P)] + [0]
    edges_j = list(range(1, K)) + [p * L + L - 2 for p in range(P)] + [K - 1]
    return _graph(rng, gt, edges_i, edges_j, noise, 0.25)


def _port(graph) -> slam.PoseGraph:
    return slam.PoseGraph(*(torch.from_numpy(np.array(a)).to(
        torch.int64 if i in (1, 2) else torch.float32) for i, a in enumerate(graph)))


def _padded(graph, multiple):
    """`graph` with zero-weight identity edges up to a multiple of edges."""
    pad = (-len(graph.weights)) % multiple
    return jslam.PoseGraph(
        graph.poses,
        jnp.concatenate([graph.edges_i, jnp.zeros(pad, jnp.int32)]),
        jnp.concatenate([graph.edges_j, jnp.zeros(pad, jnp.int32)]),
        jnp.concatenate([graph.measurements, jnp.broadcast_to(jnp.eye(4), (pad, 4, 4))]),
        jnp.concatenate([graph.weights, jnp.zeros(pad)]))


def _with_garbage(graph):
    """`graph` with 4 zero-weight edges that carry nonsense measurements."""
    return jslam.PoseGraph(
        graph.poses,
        jnp.concatenate([graph.edges_i, jnp.zeros(4, jnp.int32)]),
        jnp.concatenate([graph.edges_j, jnp.full(4, 3, jnp.int32)]),
        jnp.concatenate([graph.measurements, jnp.broadcast_to(jse3.exp(jnp.ones(6)), (4, 4, 4))]),
        jnp.concatenate([graph.weights, jnp.zeros(4)]))


GRAPHS = {
    'zero_noise': lambda: _ring(0, noise=0.0)[0],
    'noisy': lambda: _ring(1, noise=0.05)[0],
    'zero_weight_edges': lambda: _with_garbage(
        _ring(2, noise=0.0)[0]),
}


@pytest.fixture(scope='module', params=sorted(GRAPHS))
def graph(request):
    return GRAPHS[request.param]()


class TestPoseGraph:
    def test_residuals_and_chi2(self, graph):
        pg = _port(graph)
        np.testing.assert_allclose(slam.residuals(pg.poses, pg).numpy(),
                                   np.asarray(jslam.residuals(graph.poses, graph)), atol=1e-5)
        assert float(slam.chi2(pg.poses, pg)) == pytest.approx(
            float(jslam.chi2(graph.poses, graph)), rel=1e-4)

    def test_optimize_matches_jax(self, graph):
        want = np.asarray(jslam.optimize(graph, iters=15))
        got = slam.optimize(_port(graph), iters=15)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
        pg = _port(graph)
        assert float(slam.chi2(got, pg)) <= float(slam.chi2(pg.poses, pg))

    def test_zero_noise_recovers_the_ground_truth(self):
        graph, gt = _ring(0, noise=0.0)
        out = slam.optimize(_port(graph), iters=15)
        assert float(slam.residuals(out, _port(graph)).abs().max()) < 1e-4
        err = se3.inverse(out) @ torch.from_numpy(np.array(gt))
        ang = so3.geodesic_distance(err[:, :3, :3], torch.eye(3).expand(len(gt), 3, 3))
        assert float(torch.rad2deg(ang).max()) < 0.1
        assert float(err[:, :3, 3].norm(dim=-1).max()) < 1e-3

    def test_partition_graph_matches_jax(self):
        graph, _ = _chunked(5)
        want = jslam.partition_graph(graph, 4)
        got = slam.partition_graph(_port(graph), 4)
        for name, a, b in zip(want._fields, want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)

    def test_partition_graph_refusals(self):
        graph, _ = _chunked(7)
        bad = jslam.PoseGraph(graph.poses,
                              jnp.concatenate([graph.edges_i, jnp.array([2], jnp.int32)]),
                              jnp.concatenate([graph.edges_j, jnp.array([14], jnp.int32)]),
                              jnp.concatenate([graph.measurements, jnp.eye(4)[None]]),
                              jnp.concatenate([graph.weights, jnp.ones(1)]))
        with pytest.raises(ValueError, match='interior'):
            slam.partition_graph(_port(bad), 4)
        with pytest.raises(ValueError, match='not divisible'):
            slam.partition_graph(_port(graph), 5)
        with pytest.raises(ValueError, match='chunk length'):
            slam.partition_graph(_port(graph), 12)

    def test_one_process_solves_without_a_group(self):
        """Without a process group the sharded solve is the dense one and a
        one-partition Schur solve runs alone."""
        graph, _ = _chunked(5)
        pg = _port(graph)
        dense = slam.optimize(pg, iters=10)
        np.testing.assert_allclose(slam.distributed_optimize(pg, iters=10).numpy(),
                                   dense.numpy(), atol=1e-4)
        np.testing.assert_allclose(
            slam.schur_optimize(slam.partition_graph(pg, 1), iters=10).numpy(),
            dense.numpy(), atol=1e-3)


# --- the collective solves, one spawn of 4 gloo ranks ----------------------------

_RANK_BODY = r'''
from pcd_reg_hregnet_torch import slam
from pcd_reg_hregnet_torch.parallel import mesh


def run(rank, world, inputs):
    out = {'distributed': slam.distributed_optimize(inputs['ring'], iters=8),
           'distributed_mesh': slam.distributed_optimize(inputs['ring'], mesh.make_mesh(4),
                                                         iters=8),
           'schur': slam.schur_optimize(inputs['chunked'], iters=10),
           'schur_zero_noise': slam.schur_optimize(inputs['chunked_exact'], iters=15)}
    try:
        slam.schur_optimize(slam.partition_graph(inputs['chunked_graph'], 2), iters=1)
    except ValueError as e:
        out['refusal'] = str(e)
    return out
'''


@pytest.fixture(scope='module')
def solves():
    ring, _ = _ring(3, K=12, noise=0.03, loop_closures=9)
    ring = _padded(ring, 4)
    chunked, _ = _chunked(5)
    exact, gt = _chunked(6, noise=0.0)

    def here():
        m = make_mesh(4)
        return dict(jax_distributed=np.asarray(jslam.distributed_optimize(ring, m, iters=8)),
                    jax_schur=np.asarray(jslam.schur_optimize(
                        jslam.partition_graph(chunked, 4), m, iters=10)))
    ranks, jax_solves = spawn_ranks(4, _RANK_BODY, {
        'ring': _port(ring), 'chunked': slam.partition_graph(_port(chunked), 4),
        'chunked_exact': slam.partition_graph(_port(exact), 4),
        'chunked_graph': _port(chunked)}, here)
    return dict(ranks=ranks, ring=ring, chunked=chunked, gt=np.asarray(gt), **jax_solves)


class TestCollectiveSolves:
    def test_distributed_optimize(self, solves):
        dense = slam.optimize(_port(solves['ring']), iters=8).numpy()
        for r in solves['ranks']:
            for key in ('distributed', 'distributed_mesh'):
                got = r[key].numpy()
                np.testing.assert_allclose(got, solves['jax_distributed'], atol=1e-3)
                np.testing.assert_allclose(got, dense, atol=1e-4)
        assert all(torch.equal(r['distributed'], solves['ranks'][0]['distributed'])
                   for r in solves['ranks'])

    def test_schur_optimize(self, solves):
        pg = _port(solves['chunked'])
        dense = slam.optimize(pg, iters=10).numpy()
        for r in solves['ranks']:
            got = r['schur'].numpy()
            np.testing.assert_allclose(got, solves['jax_schur'], atol=1e-3)
            np.testing.assert_allclose(got, dense, atol=1e-3)
            assert float(slam.chi2(r['schur'], pg)) <= 0.1 * float(slam.chi2(pg.poses, pg))

    def test_schur_zero_noise_recovers_the_ground_truth(self, solves):
        for r in solves['ranks']:
            err = se3.inverse(r['schur_zero_noise']) @ torch.from_numpy(solves['gt'])
            assert float(err[:, :3, 3].norm(dim=-1).max()) < 1e-3

    def test_schur_refuses_a_partition_count_other_than_the_ranks(self, solves):
        for r in solves['ranks']:
            assert 'one rank per partition' in r['refusal']


# --- sequences -------------------------------------------------------------------

def _drifting_sequence(K=6, n=256, seed=9):
    """A world scene seen from K drifting poses, each keyframe cloud in its
    own sensor frame (the JAX test's construction, numpy seeds)."""
    rng = np.random.default_rng(seed)
    scene = torch.from_numpy(rng.uniform(-10, 10, (1, n, 3)).astype(np.float32))
    tw = torch.from_numpy((rng.standard_normal((K - 1, 6)) * 0.1).astype(np.float32))
    gt = [torch.eye(4)]
    for k in range(K - 1):
        gt.append(gt[-1] @ se3.exp(tw[k]))
    gt = torch.stack(gt)
    clouds = torch.cat([se3.transform(se3.inverse(gt[k])[None], scene) for k in range(K)])
    return clouds, gt


class TestSequence:
    def test_icp_sequence_recovers_the_trajectory(self):
        clouds, gt = _drifting_sequence()
        K = len(gt)
        edges = [(k, k + 1) for k in range(K - 1)] + [(0, K - 1)]
        graph = slam.build_pose_graph(clouds, edges,
                                      slam.icp_register_fn('point_to_point', max_iters=25))
        out = slam.optimize(graph, iters=10)
        err = se3.inverse(out) @ gt
        ang = so3.geodesic_distance(err[:, :3, :3], torch.eye(3).expand(K, 3, 3))
        assert float(torch.rad2deg(ang).max()) < 0.5
        assert float(err[:, :3, 3].norm(dim=-1).max()) < 0.05
        assert torch.equal(graph.weights, torch.ones(len(edges)))

    def test_the_odometry_chain_is_required(self):
        clouds, _ = _drifting_sequence(K=4, n=64)
        register = slam.icp_register_fn('point_to_point', max_iters=2)
        with pytest.raises(ValueError, match='odometry chain'):
            slam.build_pose_graph(clouds, [(0, 1), (2, 3), (0, 3)], register)
        init = torch.eye(4).expand(4, 4, 4)
        graph = slam.build_pose_graph(clouds, [(0, 1), (2, 3)], register, init_poses=init)
        assert torch.equal(graph.poses, init)

    def test_model_register_fn_matches_jax(self):
        """The JAX test's small `hregnet` (64-point clouds) on 10 edges: the
        port's batches of 8 and 2 against JAX's one batch of 10."""
        from pcd_reg_hregnet_tpu import models as jmodels
        from pcd_reg_hregnet_tpu.core.config import LevelConfig as JLevelConfig
        from pcd_reg_hregnet_torch.core.config import LevelConfig
        from pcd_reg_hregnet_torch.models import zoo
        from pcd_reg_hregnet_torch.utils.convert import from_flax
        from test_torch_model import _variables
        j_levels = (JLevelConfig(32, 8, (8, 8, 16), 16), JLevelConfig(16, 8, (16, 16, 32), 32),
                    JLevelConfig(8, 4, (32, 32, 64), 64))
        levels = tuple(LevelConfig(l.nsample, l.k, l.conv_channels, l.desc_dim)
                       for l in j_levels)
        clouds, _ = _drifting_sequence(K=11, n=64, seed=4)
        edges = [(k, k + 1) for k in range(10)]
        jm = jmodels.build('hregnet', levels=j_levels)
        c = clouds.numpy()
        v = _variables(jm, c[:1], c[:1], seed=2, train=False)
        want = jslam.build_pose_graph(jnp.asarray(c), edges, jslam.model_register_fn(jm, v))
        tm = zoo.build('hregnet', device='cpu', levels=levels)
        tm.load_state_dict(from_flax(v), strict=True)
        got = slam.build_pose_graph(clouds, edges, slam.model_register_fn(tm))
        Z, Zj = got.measurements.numpy(), np.asarray(want.measurements)
        np.testing.assert_allclose(Z[:, :3, :3], Zj[:, :3, :3], atol=1e-4)
        np.testing.assert_allclose(Z[:, :3, 3], Zj[:, :3, 3], atol=1e-4)
        np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights), atol=1e-5)
        np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), atol=1e-4)
