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
        assert kfps.MAX_POINTS >= 65536
        caps = np.array([kfps.capacity(c) for c in range(len(kfps.CONFIGS))])
        chosen = np.array([kfps.choose_config(n) for n in range(1, kfps.MAX_POINTS + 1)])
        assert (caps[chosen] >= np.arange(1, kfps.MAX_POINTS + 1)).all()
        for threads, ppt, cluster in kfps.CONFIGS:
            assert threads % 32 == 0 and threads <= 1024
            assert cluster in (1, 2, 4, 8)
        with pytest.raises(ValueError, match=str(kfps.MAX_POINTS)):
            kfps.choose_config(kfps.MAX_POINTS + 1)


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
        elif bad == 'cap':
            xyz = torch.zeros(1, kfps.MAX_POINTS + 1, 3)
            match = str(kfps.MAX_POINTS)
        else:
            config = kfps.CONFIGS.index((32, 16, 1))   # holds 512 points
            xyz = torch.zeros(1, 513, 3)
        with pytest.raises(ValueError, match=match):
            kfps._launch(xyz, w, m, config)


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


class TestAttentionReference:
    @pytest.mark.parametrize('shape', [(3, 2, 16, 8), (2, 4, 32, 16), (2, 2, 64, 32)])
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
        assert kattn.patch_attention.launches == n

    @pytest.mark.parametrize('bad', ['head_dim', 'dtype', 'mismatch', 'smem'])
    def test_launch_validates_before_building(self, bad):
        shape = {'head_dim': (1, 1, 16, 12), 'smem': (1, 1, 512, 128)}.get(bad, (1, 1, 16, 8))
        q = torch.zeros(shape)
        k = v = q
        if bad == 'dtype':
            q = k = v = q.half()
        elif bad == 'mismatch':
            k = torch.zeros(1, 1, 16, 16)
        with pytest.raises(ValueError):
            kattn._launch(q, k, v, 1.0)
