"""The port's last public helpers against the JAX package's:
`data/native.py` (`available`, `load_bin`, `transform_inplace`, on the
inputs of `tests/test_native.py`), `geometry/so3.py::transform` (within
1e-6) and `models/zoo.py::available`.

Both packages bind the same `cc/libpcd_native.so` (the port compiles
`cc/pointcloud.cc` where it does not load), so their outputs are compared
bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcd_reg_hregnet_tpu.data import native as jnative
from pcd_reg_hregnet_tpu.geometry import so3 as jso3
from pcd_reg_hregnet_tpu.models import zoo as jzoo
from pcd_reg_hregnet_torch.data import native
from pcd_reg_hregnet_torch.geometry import so3
from pcd_reg_hregnet_torch.models import zoo


def test_native_available_as_jax():
    assert native.available() is True
    assert native.available() == jnative.available()


# the library reads a file as 5 floats a record where its length allows,
# else 4, else 6: 301 rows of 4 are 1204 floats, which 5 does not divide
@pytest.mark.parametrize('rows,cols', [(300, 5), (301, 4)])
def test_load_bin_matches_jax(tmp_path, rows, cols):
    pts = np.random.default_rng(5).uniform(-60, 60, (rows, cols)).astype(np.float32)
    path = str(tmp_path / 'cloud.pcd.bin')
    pts.tofile(path)
    for seed, n_out in ((0, 256), (3, 512)):
        xyz, inten = native.load_bin(path, 80.0, n_out, seed=seed)
        jxyz, jinten = jnative.load_bin(path, 80.0, n_out, seed=seed)
        assert xyz.shape == (n_out, 3) and inten.shape == (n_out,)
        np.testing.assert_array_equal(xyz, jxyz)
        np.testing.assert_array_equal(inten, jinten)
    sample = {tuple(np.round(r, 4)) for r in pts[:, :3]}
    assert all(tuple(np.round(r, 4)) in sample for r in xyz[:10])


def test_load_bin_refusals(tmp_path):
    with pytest.raises(IOError):
        native.load_bin('/nonexistent/file.bin', 80.0, 16)
    odd = str(tmp_path / 'odd.pcd.bin')
    np.zeros(7, np.float32).tofile(odd)   # 28 bytes: neither 4 nor 5 floats a record
    with pytest.raises(ValueError, match='record width'):
        jnative.load_bin(odd, 80.0, 16)
    with pytest.raises(ValueError, match='record width'):
        native.load_bin(odd, 80.0, 16)


def test_transform_inplace_matches_jax():
    pts = np.random.default_rng(6).uniform(-5, 5, (100, 3)).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [1, 2, 3]
    T[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    expected = pts @ T[:3, :3].T + T[:3, 3]
    work = pts.copy()
    got = native.transform_inplace(work, T)
    assert got is work
    np.testing.assert_array_equal(got, jnative.transform_inplace(pts.copy(), T))
    np.testing.assert_allclose(got, expected, atol=1e-5)
    with pytest.raises(ValueError, match='float32'):
        native.transform_inplace(pts.astype(np.float64), T)


@pytest.mark.parametrize('scale', [1.0, 40.0])
def test_so3_transform_matches_jax(scale):
    """Within 1e-6 of the coordinates' scale, of JAX and of an f64 product."""
    rng = np.random.default_rng(7)
    w = rng.uniform(-np.pi / 2, np.pi / 2, (2, 3, 3)).astype(np.float32)
    R = so3.exp(torch.from_numpy(w))
    pts = rng.uniform(-scale, scale, (2, 3, 500, 3)).astype(np.float32)
    got = so3.transform(R, torch.from_numpy(pts))
    want = jso3.transform(jnp.asarray(R.numpy()), jnp.asarray(pts))
    assert got.shape == (2, 3, 500, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6 * scale)
    exact = np.einsum('...ij,...nj->...ni', R.double().numpy(), pts.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=1e-6 * scale)


def test_zoo_available_as_jax():
    assert zoo.available() == jzoo.available()
    assert zoo.available() == sorted(zoo.available()) and 'model_v6' in zoo.available()
