"""Port kernels' plain versions against the JAX package (CPU).

FPS/WFPS (kernel K1/K2) must give the JAX indices exactly, against both
`ops/sampling._fps_impl` and the Pallas kernel in interpret mode.  Patch
attention (K3) must match `_dense_reference` and the Pallas kernel in
interpret mode within 1e-5 in f32 (same math, other summation order) and
2e-2 in bf16 (one bf16 rounding of the output).  On the CPU the wrappers
take the plain versions and count no launch.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pcd_reg_hregnet_tpu.ops.pallas import attention as jattn
from pcd_reg_hregnet_tpu.ops.pallas.fps import fps_pallas, weighted_fps_pallas
from pcd_reg_hregnet_tpu.ops.sampling import _fps_impl
from pcd_reg_hregnet_torch.ops import sampling
from pcd_reg_hregnet_torch.ops.kernels import attention as kattn
from pcd_reg_hregnet_torch.ops.kernels import build as kbuild
from pcd_reg_hregnet_torch.ops.kernels import fps as kfps

torch.set_num_threads(1)


def _cloud(seed, b, n):
    return np.random.default_rng(seed).uniform(-40, 40, (b, n, 3)).astype(np.float32)


def _weights(seed, b, n):
    return (np.random.default_rng(seed).uniform(0.1, 1.1, (b, n))).astype(np.float32)


def _tied_cloud(kind, seed, b, n):
    """Rows with exact distance ties: `resampled` pads a raw cloud of
    3000/8096 n points to n by duplicating random points, as the serving
    path's `resample` does; `grid` snaps a cloud to a 0.5 m grid."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-40, 40, (b, n, 3)).astype(np.float32)
    if kind == 'resampled':
        raw = n * 3000 // 8096
        pad = rng.integers(0, raw, (b, n - raw))
        idx = np.concatenate([np.broadcast_to(np.arange(raw), (b, raw)), pad], axis=1)
        return np.take_along_axis(xyz, idx[..., None], axis=1)
    return (np.round(xyz / 0.5) * 0.5).astype(np.float32)


def _model_weights(seed, b, n):
    """1/(sigma + 1e-5), mean-normalised, sigma = softplus(.) + 0.001, as
    the model weights its L2/L3 sampling."""
    sigma = np.log1p(np.exp(np.random.default_rng(seed).normal(0, 2, (b, n)))) + 0.001
    w = 1.0 / (sigma + 1e-5)
    return (w / w.mean(axis=1, keepdims=True)).astype(np.float32)


class TestFPSReference:
    @pytest.mark.parametrize('b,n,m', [(3, 256, 128), (3, 300, 64), (5, 256, 128)])
    def test_matches_jax_fps_impl(self, b, n, m):
        xyz = _cloud(0, b, n)
        ref = np.asarray(_fps_impl(jnp.asarray(xyz), None, m))
        got = kfps.fps_reference(torch.from_numpy(xyz), None, m)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)

    def test_weighted_matches_jax_fps_impl(self):
        xyz, w = _cloud(1, 2, 384), _weights(2, 2, 384)
        ref = np.asarray(_fps_impl(jnp.asarray(xyz), jnp.asarray(w), 128))
        got = kfps.fps_reference(torch.from_numpy(xyz), torch.from_numpy(w), 128)
        np.testing.assert_array_equal(got.numpy(), ref)

    @pytest.mark.parametrize('b,n,m', [(2, 256, 128), (5, 200, 64)])
    def test_matches_pallas_interpret(self, b, n, m):
        xyz = _cloud(3, b, n)
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(fps_pallas(jnp.asarray(xyz), m))
        got = kfps.fps_reference(torch.from_numpy(xyz), None, m)
        np.testing.assert_array_equal(got.numpy(), ref)

    def test_weighted_matches_pallas_interpret(self):
        xyz, w = _cloud(4, 2, 256), _weights(5, 2, 256)
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(weighted_fps_pallas(jnp.asarray(xyz), jnp.asarray(w), 128))
        got = kfps.fps_reference(torch.from_numpy(xyz), torch.from_numpy(w), 128)
        np.testing.assert_array_equal(got.numpy(), ref)

    def test_ties_take_first_index(self):
        # duplicated points tie exactly; argmax keeps the smallest index
        xyz = np.repeat(_cloud(6, 1, 32), 2, axis=1)
        ref = np.asarray(_fps_impl(jnp.asarray(xyz), None, 16))
        got = kfps.fps_reference(torch.from_numpy(xyz), None, 16)
        np.testing.assert_array_equal(got.numpy(), ref)


class TestFPSTies:
    @pytest.mark.parametrize('kind', ['resampled', 'grid'])
    @pytest.mark.parametrize('weighted', [False, True])
    def test_matches_jax_fps_impl(self, kind, weighted):
        xyz = _tied_cloud(kind, 11, 2, 512)
        w = _model_weights(12, 2, 512) if weighted else None
        ref = np.asarray(_fps_impl(jnp.asarray(xyz), None if w is None else jnp.asarray(w), 128))
        got = kfps.fps_reference(torch.from_numpy(xyz),
                                 None if w is None else torch.from_numpy(w), 128)
        np.testing.assert_array_equal(got.numpy(), ref)

    @pytest.mark.parametrize('kind', ['resampled', 'grid'])
    @pytest.mark.parametrize('weighted', [False, True])
    def test_matches_pallas_interpret(self, kind, weighted):
        xyz = _tied_cloud(kind, 13, 2, 256)
        w = _model_weights(14, 2, 256) if weighted else None
        with pltpu.force_tpu_interpret_mode():
            if weighted:
                ref = np.asarray(weighted_fps_pallas(jnp.asarray(xyz), jnp.asarray(w), 128))
            else:
                ref = np.asarray(fps_pallas(jnp.asarray(xyz), 128))
        got = kfps.fps_reference(torch.from_numpy(xyz),
                                 None if w is None else torch.from_numpy(w), 128)
        np.testing.assert_array_equal(got.numpy(), ref)


class TestFPSConfigs:
    def test_table_matches_cuda_source(self):
        src = (Path(kfps.__file__).resolve().parents[2] / 'csrc' / 'fps.cu').read_text()
        body = src[src.index('kConfigs[] = {'):]
        body = body[:body.index('};')]
        rows = tuple(tuple(map(int, r)) for r in
                     re.findall(r'\{(\d+), (\d+), (\d+)\}', body))
        assert rows == kfps.CONFIGS

    def test_every_n_maps_to_a_configuration_that_holds_it(self):
        top = kfps.BANDS[-1][0]
        assert top >= 65536
        caps = np.array([kfps.capacity(c) for c in range(len(kfps.CONFIGS) + 1)])
        chosen = np.array([kfps.choose_config(n) for n in range(1, top + 1)])
        assert (chosen < len(kfps.CONFIGS)).all()
        assert (caps[chosen] >= np.arange(1, top + 1)).all()
        for threads, ppt, cluster in kfps.CONFIGS:
            assert threads % 32 == 0 and threads <= 1024
            assert cluster in (1, 2, 4, 8)
        # N above the bands maps to the global-memory variant, which holds any N
        for n in (top + 1, 131072, 1 << 20, kfps.MAX_INT32):
            assert kfps.choose_config(n) == kfps.GLOBAL_MEMORY
            assert kfps.capacity(kfps.choose_config(n)) >= n


class TestFPSWrappers:
    def test_cpu_takes_plain_version_without_counting(self):
        xyz, w = torch.from_numpy(_cloud(7, 2, 128)), torch.from_numpy(_weights(8, 2, 128))
        n1 = kfps.farthest_point_sample.launches
        n2 = kfps.weighted_farthest_point_sample.launches
        assert torch.equal(sampling.fps(xyz, 32), kfps.fps_reference(xyz, None, 32))
        assert torch.equal(sampling.weighted_fps(xyz, w, 32),
                           kfps.fps_reference(xyz, w, 32))
        assert kfps.farthest_point_sample.launches == n1
        assert kfps.weighted_farthest_point_sample.launches == n2

    @pytest.mark.parametrize('bad', ['dtype', 'shape', 'nsample', 'weights', 'cap',
                                     'config'])
    def test_launch_validates_before_building(self, bad, monkeypatch):
        def no_build():
            raise AssertionError('built before validating')
        monkeypatch.setattr(kbuild, 'library', no_build)
        xyz = torch.zeros(2, 64, 3)
        w = None
        m = 8
        config = None
        match = None
        if bad == 'dtype':
            xyz = xyz.double()
        elif bad == 'shape':
            xyz = torch.zeros(2, 64, 4)
        elif bad == 'nsample':
            m = 65
        elif bad == 'weights':
            w = torch.ones(2, 63)
        elif bad == 'cap':   # past the table and the global-memory variant
            config = kfps.GLOBAL_MEMORY + 1
            match = 'configuration'
        else:
            config = kfps.CONFIGS.index((32, 16, 1))   # holds 512 points
            xyz = torch.zeros(1, 513, 3)
        with pytest.raises(ValueError, match=match):
            kfps._launch(xyz, w, m, config)


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


# [R, H, K, d] the kernel once refused: K=1024 d=32, d=128 at K=256, d=24,
# d=256 (split over blocks), a ragged K
OPENED_SHAPES = [(1, 1, 1024, 32), (1, 2, 256, 128), (2, 3, 64, 24),
                 (1, 1, 64, 256), (2, 2, 100, 16)]
# the forward's nine (K, d) per tower, R = 4B at B = 1 and 8
PRODUCTION_SHAPES = [(4 * b, h, kk, c // h) for b in (1, 8)
                     for kk, c in ((256, 64), (128, 128), (64, 256)) for h in (2, 4, 8)]


class TestAttentionReference:
    @pytest.mark.parametrize('shape', [(3, 2, 16, 8), (2, 4, 32, 16), (2, 2, 64, 32),
                                       *OPENED_SHAPES])
    def test_matches_jax_dense_reference_f32(self, shape):
        q, k, v = _qkv(0, shape)
        scale = shape[-1] ** -0.5
        ref = np.asarray(jattn._dense_reference(*map(jnp.asarray, (q, k, v)), scale))
        got = kattn.patch_attention_reference(*map(torch.from_numpy, (q, k, v)), scale)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)

    def test_matches_pallas_interpret_f32(self):
        q, k, v = _qkv(1, (2, 2, 32, 16))
        scale = 16 ** -0.5
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(jattn.patch_attention(*map(jnp.asarray, (q, k, v)), scale))
        got = kattn.patch_attention_reference(*map(torch.from_numpy, (q, k, v)), scale)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)

    def test_matches_pallas_interpret_f32_where_jax_takes_pallas(self):
        # K = 512 (_PALLAS_MIN_PATCH): the JAX model's Pallas route
        q, k, v = _qkv(4, (1, 1, 512, 32))
        scale = 32 ** -0.5
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(jattn.patch_attention(*map(jnp.asarray, (q, k, v)), scale))
        got = kattn.patch_attention_reference(*map(torch.from_numpy, (q, k, v)), scale)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)

    def test_matches_pallas_interpret_bf16(self):
        q, k, v = _qkv(2, (2, 2, 32, 16))
        scale = 16 ** -0.5
        jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(jattn.patch_attention(jq, jk, jv, scale).astype(jnp.float32))
        tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
        got = kattn.patch_attention_reference(tq, tk, tv, scale)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), ref, atol=2e-2, rtol=0)

    def test_cpu_wrapper_takes_plain_version_without_counting(self):
        q, k, v = map(torch.from_numpy, _qkv(3, (2, 2, 16, 8)))
        n = kattn.patch_attention.launches
        assert torch.equal(kattn.patch_attention(q, k, v, 0.5),
                           kattn.patch_attention_reference(q, k, v, 0.5))
        buf = torch.empty(2, 16, 2, 8)   # an [R, K, H, d] buffer, written through a view
        got = kattn.patch_attention(q, k, v, 0.5, out=buf.transpose(1, 2))
        assert got.data_ptr() == buf.data_ptr()
        assert torch.equal(buf.transpose(1, 2), kattn.patch_attention_reference(q, k, v, 0.5))
        assert kattn.patch_attention.launches == n

    @pytest.mark.parametrize('bad', ['rank', 'dtype', 'mismatch', 'last_dim'])
    def test_launch_validates_before_building(self, bad, monkeypatch):
        def no_build():
            raise AssertionError('built before validating')
        monkeypatch.setattr(kbuild, 'library', no_build)
        q = torch.zeros(1, 1, 16, 8)
        k = v = q
        if bad == 'rank':
            q = k = v = torch.zeros(1, 16, 8)
        elif bad == 'dtype':
            q = k = v = q.half()
        elif bad == 'mismatch':
            k = torch.zeros(1, 1, 16, 16)
        else:   # every other element of the last dim
            k = torch.zeros(1, 1, 16, 16)[..., ::2]
        with pytest.raises(ValueError):
            kattn._launch(q, k, v, 1.0)


class TestAttentionPlan:
    @pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize('shape', OPENED_SHAPES + PRODUCTION_SHAPES
                             + [(1, 1, 1, 1), (3, 1, 17, 129), (32, 8, 128, 128)])
    def test_tiles_cover_k_and_d(self, shape, dtype):
        R, H, K, d = shape
        p = kattn.plan(R, H, K, d, dtype)
        tiles = p.grid[0] // (R * H)
        assert p.grid[0] == R * H * tiles and p.bm * (tiles - 1) < K <= p.bm * tiles
        assert p.bm in kattn.BLOCK_ROWS and p.threads == 2 * p.bm * p.split <= 256
        widths = (8, 16, 32, 64, 128) if dtype == torch.float32 else (16, 32, 64, 128)
        assert (p.slices > 1) == (d > kattn.WIDE)   # the d-split exactly when d > 128
        assert p.grid[1] == p.slices and p.slices * p.dp >= d
        assert (p.slices - 1) * p.dp < d
        assert p.dp == min(w for w in widths if w >= min(d, kattn.WIDE))   # the least padding
        assert p.bn % 16 == 0 and p.smem <= 232448

    def test_small_batch_spreads_over_warps_and_large_batch_does_not_over_split(self):
        for R, H, K, d in PRODUCTION_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                p = kattn.plan(R, H, K, d, dtype)
                if R == 4 and dtype == torch.float32:   # one pair: keys split over warps
                    assert p.grid[0] >= 64 or p.split == kattn.SPLIT
                else:                                   # B = 8, bf16: whole rows per warp
                    assert p.split == 1 and p.bm >= 64
                assert p.bm <= max(64, K)

    def test_blocks_of_128_rows_follow_the_sm_count(self):
        # B=8, K=256, H=2: 128 blocks of 128 rows fill 3 of every 4 of the
        # H100's 132 SMs, not of 200; the sweep reads (128, 1) faster there
        shape = (32, 2, 256, 32, torch.float32)
        assert (kattn.plan(*shape).bm, kattn.plan(*shape).split) == (128, 1)
        assert kattn.plan(*shape, sms=kattn.SMS) == kattn.plan(*shape)
        assert (kattn.plan(*shape, sms=200).bm, kattn.plan(*shape, sms=200).split) == (64, 1)



# every ATTN_OPENED shape of chip_smoke.py, for the backward's tiling
BWD_OPENED = [(2, 2, 1024, 32), (4, 2, 256, 128), (4, 3, 64, 24), (2, 2, 64, 256),
              (4, 2, 100, 16), (2, 3, 100, 5), (1, 1, 1, 1), (2, 1, 33, 300)]


class TestAttentionBackwardPlan:
    """`plan_backward`, K3b's tiling (the kernel reports the same through
    `pcdreg_attention_bwd_plan`, checked on the card by chip_smoke.py)."""

    def test_tilings_match_cuda_source(self):
        src = (Path(kattn.__file__).resolve().parents[2] / 'csrc' / 'attention_bwd.cu').read_text()
        body = src[src.index('kTilings[] = {'):]
        body = body[:body.index('};')]
        rows = tuple(tuple(map(int, r)) for r in re.findall(r'\{(\d+), (\d+)\}', body))
        assert rows == kattn.BWD_TILES

    @pytest.mark.parametrize('shape', PRODUCTION_SHAPES + BWD_OPENED
                             + [(3, 1, 17, 129), (1, 1, 513, 8), (2, 2, 512, 64)])
    def test_tiles_cover_k_and_d(self, shape):
        R, H, K, d = shape
        for tile in [None, *kattn.BWD_TILES]:
            p = kattn.plan_backward(R, H, K, d, tile)
            assert (p.bn, p.qs) in kattn.BWD_TILES and (tile is None or tile == (p.bn, p.qs))
            ntk = p.grid[0] // (R * H)
            assert p.grid[0] == R * H * ntk and p.bn * (ntk - 1) < K <= p.bn * ntk
            assert p.cluster in (0, ntk) and p.cluster <= kattn.MAX_CLUSTER
            assert p.threads == 32 * p.bn // 16 * p.qs <= 256
            assert p.slices == (-(-d // kattn.WIDE) if d > kattn.WIDE else 1) == p.grid[1]
            assert p.slices * p.dp >= d and (p.slices - 1) * p.dp < d
            assert p.dp == min(w for w in (8, 16, 32, 64, 128) if w >= min(d, kattn.WIDE))
            assert p.bm * p.stages <= 256 and p.smem <= 232448
            # the dQ partials meet in a cluster wherever they can
            assert (p.cluster > 0) == (d <= kattn.WIDE and ntk <= kattn.MAX_CLUSTER
                                       and p.smem <= 232448 and p.smem > 0
                                       and p.cluster == ntk)

    def test_production_shapes_take_a_cluster(self):
        for R, H, K, d in PRODUCTION_SHAPES:
            p = kattn.plan_backward(R, H, K, d)
            assert 1 <= p.cluster <= kattn.MAX_CLUSTER

    def test_small_batches_get_more_blocks(self):
        for R, H, K, d in PRODUCTION_SHAPES:
            p = kattn.plan_backward(R, H, K, d)
            fits = [kattn.plan_backward(R, H, K, d, t) for t in kattn.BWD_TILES]
            most = max(f.grid[0] for f in fits if f.cluster)
            if R == 4:   # one pair: the most blocks a cluster allows, or enough of them
                assert p.grid[0] == most or p.grid[0] >= kattn.MIN_BWD_BLOCKS
                assert p.grid[0] >= 32
            else:        # B = 8: the largest key tile that gives enough blocks
                assert p.grid[0] >= kattn.MIN_BWD_BLOCKS and p.bn == 64 or (
                    K == 64 and d == 128 and p.bn == 32)

    def test_eight_warps_where_two_blocks_of_four_do_not_fit(self):
        for R, H, K, d in PRODUCTION_SHAPES:
            p = kattn.plan_backward(R, H, K, d)
            four = next(t for t in kattn.BWD_TILES if t[0] == p.bn and t[0] // 16 * t[1] == 4)
            crowded = 2 * (kattn.plan_backward(R, H, K, d, four).smem + 1024) > kattn.SM_SMEM
            assert p.threads == (256 if crowded and p.bn > 16 else 128)

    def test_follows_the_sm_count(self):
        shape = (4, 4, 128, 32)   # one pair: 128 blocks of 16 keys on 132 SMs, 64 on 66
        assert kattn.plan_backward(*shape).bn == 16
        assert kattn.plan_backward(*shape, sms=66).bn == 32

    @pytest.mark.parametrize('bad', ['tile', 'lse_shape', 'lse_dtype'])
    def test_launch_validates_before_building(self, bad, monkeypatch):
        def no_build():
            raise AssertionError('built before validating')
        monkeypatch.setattr(kbuild, 'library', no_build)
        q = torch.zeros(1, 1, 16, 8)
        lse, tile = torch.zeros(1, 1, 16), None
        if bad == 'tile':
            tile = (64, 4)
        elif bad == 'lse_shape':
            lse = torch.zeros(1, 16)
        else:
            lse = lse.double()
        with pytest.raises(ValueError):
            kattn._launch_backward(q, q, q, q, q, 1.0, None, lse, tile)


# plan_backward's f32 plans at the train step's shapes, frozen: the bf16
# route leaves the f32 tiling as it was
# (dp, bn, qs, bm, stages, cluster, slices, smem, grid, threads)
F32_BWD_PLANS = {
    (32, 2, 256, 32): (32, 64, 1, 64, 2, 4, 1, 111616, (256, 1), 128),
    (32, 4, 256, 16): (16, 64, 1, 64, 2, 4, 1, 70656, (512, 1), 128),
    (32, 8, 256, 8): (8, 64, 1, 64, 2, 4, 1, 50176, (1024, 1), 128),
    (32, 2, 128, 64): (64, 64, 2, 64, 2, 2, 1, 157696, (128, 1), 256),
    (32, 4, 128, 32): (32, 64, 1, 64, 2, 2, 1, 92160, (256, 1), 128),
    (32, 8, 128, 16): (16, 64, 1, 64, 2, 2, 1, 59392, (512, 1), 128),
    (32, 2, 64, 128): (128, 32, 4, 32, 2, 2, 1, 207872, (128, 1), 256),
    (32, 4, 64, 64): (64, 64, 2, 64, 2, 1, 1, 139776, (128, 1), 256),
    (32, 8, 64, 32): (32, 64, 1, 64, 2, 1, 1, 82432, (256, 1), 128),
    (4, 2, 256, 32): (32, 32, 2, 64, 2, 8, 1, 93696, (64, 1), 128),
    (4, 4, 256, 16): (16, 32, 2, 64, 2, 8, 1, 56832, (128, 1), 128),
    (4, 8, 256, 8): (8, 64, 1, 64, 2, 4, 1, 50176, (128, 1), 128),
    (4, 2, 128, 64): (64, 16, 4, 64, 2, 8, 1, 118528, (64, 1), 128),
    (4, 4, 128, 32): (32, 16, 4, 64, 2, 8, 1, 65280, (128, 1), 128),
    (4, 8, 128, 16): (16, 32, 2, 64, 2, 4, 1, 45568, (128, 1), 128),
    (4, 2, 64, 128): (128, 16, 4, 32, 2, 4, 1, 121088, (32, 1), 128),
    (4, 4, 64, 64): (64, 16, 4, 64, 2, 4, 1, 100608, (64, 1), 128),
    (4, 8, 64, 32): (32, 16, 4, 64, 2, 4, 1, 55552, (128, 1), 128),
}
BWD_KS = (1, 33, 64, 100, 128, 256, 512, 513, 1024)
BWD_DS = (1, 5, 8, 16, 32, 64, 128, 129, 300)


class TestAttentionBackwardRoutes:
    """K3b's two kernels: f32 and the bf16 shapes it cannot take on
    `csrc/attention_bwd.cu` ("mma"), the bf16 train step's shapes on
    `csrc/attention_bwd_bf16.cu` ("wgmma"); the route follows the shape
    alone (the card checks `pcdreg_attention_bwd_bf16_plan` against
    `plan_backward` in chip_smoke.py)."""

    @pytest.mark.parametrize('shape', sorted(F32_BWD_PLANS))
    def test_f32_plans_unchanged(self, shape):
        p = kattn.plan_backward(*shape)
        assert p.route == 'mma'
        assert (p.dp, p.bn, p.qs, p.bm, p.stages, p.cluster, p.slices, p.smem, p.grid,
                p.threads) == F32_BWD_PLANS[shape]

    def test_wgmma_constants_match_cuda_source(self):
        src = (Path(kattn.__file__).resolve().parents[2] / 'csrc'
               / 'attention_bwd_bf16.cu').read_text()
        consts = dict(re.findall(r'constexpr int (k\w+) = (\d+);', src))
        assert int(consts['kKeys']) == kattn.WGMMA_KEYS
        assert int(consts['kRows']) == kattn.WGMMA_ROWS
        assert int(consts['kStages']) == kattn.WGMMA_STAGES
        assert int(consts['kMaxCluster']) == kattn.MAX_CLUSTER
        assert int(consts['kConsumers']) + 32 == kattn.WGMMA_THREADS

    @pytest.mark.parametrize('K', BWD_KS)
    def test_bf16_routes_cover_k_and_d(self, K):
        for d in BWD_DS:
            p = kattn.plan_backward(3, 2, K, d, dtype=torch.bfloat16)
            assert p.route == kattn.backward_route(K, d, torch.bfloat16)
            ntk = p.grid[0] // 6
            assert p.grid[0] == 6 * ntk and p.bn * (ntk - 1) < K <= p.bn * ntk
            assert p.slices * p.dp >= d and (p.slices - 1) * p.dp < d
            assert 0 < p.smem <= 232448 and p.stages >= 1
            if p.route == 'wgmma':
                assert d % 8 == 0 and d <= kattn.WIDE and p.dp >= d and p.slices == 1
                assert p.cluster == ntk <= kattn.MAX_CLUSTER and p.bm == kattn.WGMMA_ROWS
                assert p.stages == min(kattn.WGMMA_STAGES if p.dp <= 64 else 2, -(-K // p.bm))
                assert p.threads == kattn.WGMMA_THREADS
                assert kattn.backward_tilings(K, d, torch.bfloat16) == ()
            else:   # every tiling of the mma route covers the shape
                assert d % 8 or d > kattn.WIDE or K > kattn.MAX_CLUSTER * kattn.WGMMA_KEYS \
                    or kattn._wgmma_plan(K, d) is None
                for tile in kattn.backward_tilings(K, d, torch.bfloat16):
                    q = kattn.plan_backward(3, 2, K, d, tile, dtype=torch.bfloat16)
                    assert (q.bn, q.qs) == tile and q.route == 'mma'
                    assert q.bn * (q.grid[0] // 6) >= K and q.smem <= 232448

    def test_production_shapes_take_wgmma(self):
        for R, H, K, d in PRODUCTION_SHAPES:
            p = kattn.plan_backward(R, H, K, d, dtype=torch.bfloat16)
            assert p.route == 'wgmma' and 1 <= p.cluster <= kattn.MAX_CLUSTER
            assert p.grid == (R * H * -(-K // kattn.WGMMA_KEYS), 1)

    @pytest.mark.parametrize('shape,cluster,stages', [((1, 1, 1, 8), 1, 1),
                                                      ((2, 2, 33, 32), 1, 1),
                                                      ((2, 2, 512, 32), 8, 3),
                                                      ((2, 2, 300, 64), 5, 3)])
    def test_opened_wgmma_shapes_reach_their_cases(self, shape, cluster, stages):
        # chip_smoke.py holds these on the card to the wgmma kernel's K = 1
        # case, a ragged lone key tile and clusters of 8 and 5 key tiles
        import chip_smoke
        assert shape in chip_smoke.ATTN_OPENED_WGMMA
        p = kattn.plan_backward(*shape, dtype=torch.bfloat16)
        assert (p.route, p.cluster, p.stages) == ('wgmma', cluster, stages)

    def test_route_depends_on_shape_alone(self):
        for K in BWD_KS:
            for d in BWD_DS:
                routes = {kattn.plan_backward(R, H, K, d, sms=sms, dtype=dtype).route
                          for R, H in ((1, 1), (32, 8)) for sms in (66, 132)
                          for dtype in (torch.bfloat16,)}
                assert routes == {kattn.backward_route(K, d, torch.bfloat16)}
                assert kattn.plan_backward(2, 2, K, d).route == 'mma'   # f32

    def test_wgmma_route_refuses_a_tiling_before_building(self, monkeypatch):
        def no_build():
            raise AssertionError('built before validating')
        monkeypatch.setattr(kbuild, 'library', no_build)
        with pytest.raises(ValueError):
            kattn.plan_backward(2, 2, 64, 32, (64, 1), dtype=torch.bfloat16)
        q = torch.zeros(1, 1, 64, 32, dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            kattn._launch_backward(q, q, q, q, q, 1.0, None, torch.zeros(1, 1, 64), (64, 1))

    def test_model_views_meet_tma_rules_and_odd_views_do_not(self):
        # the views PatchAttentionFunction hands K3b at every production
        # shape need no copy; a view whose rows break 16 bytes does
        for R, H, K, d in PRODUCTION_SHAPES:
            qkv = torch.empty((R, K, 3, H, d), dtype=torch.bfloat16)
            grad = torch.empty((R, K, H, d), dtype=torch.bfloat16).transpose(1, 2)
            for t in (*kattn.unpack_qkv(qkv), grad):
                assert kattn._tma_strides(t.stride(), t.shape)
        odd = torch.empty((2, 3, 64, 9), dtype=torch.bfloat16)[..., :8]
        assert not kattn._tma_strides(odd.stride(), odd.shape)
        expanded = torch.zeros((1, 1, 64, 8), dtype=torch.bfloat16).expand(2, 3, 64, 8)
        assert not kattn._tma_strides(expanded.stride(), expanded.shape)
        one = torch.empty((1, 1, 64, 8), dtype=torch.bfloat16)   # dims of size 1 are never stepped
        assert kattn._tma_strides(one.stride(), one.shape)
