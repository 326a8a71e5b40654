"""The whole `model_v6` forward of the port against the JAX package (CPU),
and the serving entry points.

Small pyramid (64/32/16 keypoints from 256 points), PTv3 depths (1, 1),
patch 16.  Random flax variables go through `utils.convert.from_flax`; all
three levels' R and t, and every level's keypoints, sigmas and
descriptors, are compared.  Tolerances: f32 round-off of different
summation orders carried through three levels of attention-weighted
keypoints at a 40 m scale (observed ~2e-6 on R, ~4e-5 m on t).
"""
import jax
import numpy as np
import pytest
import torch

from pcd_reg_hregnet_tpu.models import build as jbuild
from pcd_reg_hregnet_torch import serve
from pcd_reg_hregnet_torch.models import zoo
from pcd_reg_hregnet_torch.utils.convert import from_flax
from test_torch_model import J_LEVELS, LEVELS, SMALL, _rand, _variables

torch.set_num_threads(1)


def _pair(seed, b, n):
    """A target cloud and the same cloud moved by a small rigid motion."""
    dst = _rand(seed, (b, n, 3), -40, 40)
    a = 0.1
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
                 np.float32)
    src = (dst @ R.T + np.array([0.3, -0.2, 0.1], np.float32)).astype(np.float32)
    return src, dst


class TestModelV6:
    def test_forward_all_levels(self):
        src, dst = _pair(1, 2, 256)
        jm = jbuild('model_v6', levels=J_LEVELS, **SMALL)
        v = _variables(jm, src, dst, seed=1, train=False)
        jout = jax.jit(lambda v, a, b: jm.apply(v, a, b, train=False))(v, src, dst)
        tm = zoo.build('model_v6', device='cpu', levels=LEVELS, **SMALL)
        tm.load_state_dict(from_flax(v), strict=True)
        with torch.no_grad():
            tout = tm(torch.from_numpy(src), torch.from_numpy(dst))
        for lvl in range(3):
            np.testing.assert_allclose(tout['rotation'][lvl].numpy(),
                                       np.asarray(jout['rotation'][lvl]), atol=5e-5, rtol=0)
            np.testing.assert_allclose(tout['translation'][lvl].numpy(),
                                       np.asarray(jout['translation'][lvl]), atol=5e-4, rtol=0)
        # every other output: correspondences, weights, circle/MI tensors,
        # and each tower's keypoints, sigmas and descriptors
        assert set(tout) == set(jout)
        for key in jout:
            for ref, got in zip(jax.tree.leaves(jout[key]), jax.tree.leaves(tout[key])):
                np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-4,
                                           rtol=1e-4, err_msg=key)
        served = serve.register(tm, src, dst, device='cpu')
        assert torch.equal(served['rotation'], tout['rotation'][-1])
        assert torch.equal(served['translation'], tout['translation'][-1])


class TestEntryPoints:
    def test_cuda_default_raises_without_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            zoo.build('model_v6', levels=LEVELS, **SMALL)
        tm = zoo.build('model_v6', device='cpu', levels=LEVELS, **SMALL)
        src, dst = _pair(2, 1, 128)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.register(tm, src, dst)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.infer_pair(tm, src[0], dst[0], num_points=128)

    def test_infer_pair_on_cpu(self):
        tm = zoo.build('model_v6', device='cpu', levels=LEVELS, **SMALL)
        src, dst = _pair(3, 1, 300)
        out = serve.infer_pair(tm, src[0], dst[0], device='cpu', num_points=128)
        T = np.asarray(out['transform'])
        assert T.shape == (4, 4) and np.all(np.isfinite(T))
        np.testing.assert_allclose(T[:3, :3], np.asarray(out['rotation']))
        np.testing.assert_allclose(T[3], [0, 0, 0, 1])

    def test_forward_turns_tf32_off_only_inside(self):
        """The forward runs with TF32 off and leaves the caller's settings."""
        backends = torch.backends
        prev = (backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32)
        seen = []
        try:
            backends.cuda.matmul.allow_tf32 = backends.cudnn.allow_tf32 = True
            tm = zoo.build('model_v6', device='cpu', levels=LEVELS, **SMALL)
            assert backends.cuda.matmul.allow_tf32 and backends.cudnn.allow_tf32
            tm.pose_head.register_forward_hook(lambda *_: seen.append(
                (backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32)))
            src, dst = _pair(4, 1, 256)
            serve.register(tm, src, dst, device='cpu')
            assert seen and all(flags == (False, False) for flags in seen)
            assert backends.cuda.matmul.allow_tf32 and backends.cudnn.allow_tf32
        finally:
            backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32 = prev

    def test_unknown_model(self):
        with pytest.raises(KeyError, match='model_v6'):
            zoo.model_config('hregnet_x')
