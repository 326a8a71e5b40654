"""The port's data layer and geometry against the JAX package (CPU).

Synthetic clouds and the native filter/resample must be bit-identical.
Test-split items: points and intensities bit-identical, `igt` within 1e-6
(the port's f32 `se3.exp` differs from JAX's in the last bits) and
`uncalibed_pcd` within 1e-5 m (those bits times a 60 m lever arm; observed
~4e-6).  The committed twist tables must equal the JAX package's
`perturbation_table` exactly.  Geometry: so3/se3 within 1e-6 on twists of
0, 1e-8, ordinary and near-pi angles, Euler angles within 1e-5 deg.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcd_reg_hregnet_tpu.core.config import DataConfig as JDataConfig
from pcd_reg_hregnet_tpu.data import load_dataset as jload_dataset
from pcd_reg_hregnet_tpu.data import native as jnative
from pcd_reg_hregnet_tpu.data import pipeline as jpipeline
from pcd_reg_hregnet_tpu.data.synthetic import SyntheticPairSource as JSource
from pcd_reg_hregnet_tpu.geometry import rotations as jrot
from pcd_reg_hregnet_tpu.geometry import se3 as jse3
from pcd_reg_hregnet_tpu.geometry import so3 as jso3
from pcd_reg_hregnet_torch.core.config import ASSETS_DIR, DataConfig
from pcd_reg_hregnet_torch.data import load_dataset, native, pipeline
from pcd_reg_hregnet_torch.data.synthetic import SyntheticPairSource
from pcd_reg_hregnet_torch.geometry import rotations, se3, so3

torch.set_num_threads(1)

SMALL_POINTS = 1024     # pcd_min_samples of the item tests: 2048-point raw clouds


def _twists():
    """[n, 6] f32 twists: zero, 1e-8, small, ordinary and near-pi rotations."""
    rng = np.random.default_rng(0)
    axes = rng.normal(size=(7, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.array([0.0, 1e-8, 5e-3, 0.3, 1.2, 2.5, 3.1])
    w = axes * angles[:, None]
    v = rng.uniform(-0.5, 0.5, (7, 3))
    return np.concatenate([w, v], axis=1).astype(np.float32)


class TestGeometry:
    def test_so3_exp_log(self):
        w = _twists()[:, :3]
        R = so3.exp(torch.from_numpy(w))
        np.testing.assert_allclose(R.numpy(), np.asarray(jso3.exp(jnp.asarray(w))),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(so3.log(R).numpy(), np.asarray(jso3.log(jnp.asarray(R.numpy()))),
                                   atol=1e-6, rtol=0)

    def test_se3_exp_log_transform(self):
        x = _twists()
        T = se3.exp(torch.from_numpy(x))
        jT = np.asarray(jse3.exp(jnp.asarray(x)))
        np.testing.assert_allclose(T.numpy(), jT, atol=1e-6, rtol=0)
        np.testing.assert_allclose(se3.log(T).numpy(), np.asarray(jse3.log(jnp.asarray(T.numpy()))),
                                   atol=1e-6, rtol=0)
        pts = np.random.default_rng(1).uniform(-1, 1, (7, 50, 3)).astype(np.float32)
        np.testing.assert_allclose(se3.transform(T, torch.from_numpy(pts)).numpy(),
                                   np.asarray(jse3.transform(jnp.asarray(T.numpy()), jnp.asarray(pts))),
                                   atol=1e-6, rtol=0)

    def test_euler(self):
        ang = np.random.default_rng(2).uniform(-1.4, 1.4, (64, 3)).astype(np.float32)
        ang[0] = 0.0
        ang[1] = [1e-7, -1e-7, 1e-7]
        R = rotations.euler_xyz_to_matrix(torch.from_numpy(ang))
        np.testing.assert_allclose(R.numpy(), np.asarray(jrot.euler_xyz_to_matrix(jnp.asarray(ang))),
                                   atol=1e-6, rtol=0)
        got = np.rad2deg(rotations.matrix_to_euler_xyz(R).numpy())
        want = np.rad2deg(np.asarray(jrot.matrix_to_euler_xyz(jnp.asarray(R.numpy()))))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got, np.rad2deg(ang), atol=1e-3, rtol=0)


class TestSources:
    @pytest.mark.parametrize('seed,index', [(0, 0), (101, 3), (202, 7), (202, 255)])
    def test_synthetic_pairs_bit_identical(self, seed, index):
        got = SyntheticPairSource(length=256, points_per_cloud=1500, seed=seed).load_pair(index)
        want = JSource(length=256, points_per_cloud=1500, seed=seed).load_pair(index)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    @pytest.mark.parametrize('n_in,stride,n_out,seed', [
        (5000, 4, 1024, 7), (5000, 3, 1024, 8), (50, 4, 128, 0), (3000, 4, 3000, 2 ** 61 + 5)])
    def test_native_filter_resample_bit_identical(self, n_in, stride, n_out, seed):
        pts = np.random.default_rng(seed % 1000).uniform(-120, 120, (n_in, stride)).astype(np.float32)
        got = native.filter_resample(pts, 80.0, n_out, seed)
        want = jnative.filter_resample(pts, 80.0, n_out, seed)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


    def test_native_library_built_from_source(self, monkeypatch):
        """Where the committed library does not load, the port compiles
        cc/pointcloud.cc and gets the same points."""
        pts = np.random.default_rng(9).uniform(-120, 120, (4000, 4)).astype(np.float32)
        want = native.filter_resample(pts, 80.0, 2048, 11)
        real_cdll = native.ctypes.CDLL

        def cdll(path):
            if str(path).endswith('cc/libpcd_native.so'):
                raise OSError('cannot load')
            return real_cdll(path)
        monkeypatch.setattr(native.ctypes, 'CDLL', cdll)
        native.library.cache_clear()
        try:
            got = native.filter_resample(pts, 80.0, 2048, 11)
        finally:
            native.library.cache_clear()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert not list(native.BUILD_DIR.glob('libpcd_native.*.so'))


class TestPairDataset:
    @pytest.fixture(scope='class')
    def datasets(self):
        cfg = dict(pcd_min_samples=SMALL_POINTS, batch_size=2)
        return (load_dataset(DataConfig(**cfg), 'test'),
                jload_dataset(JDataConfig(**cfg), 'test'))

    @pytest.mark.parametrize('split,seed', [('val', 1), ('test', 2)])
    def test_committed_tables_equal_jax(self, split, seed):
        got = pipeline.read_perturbation_table(
            str(ASSETS_DIR / f'perturbations_synthetic_{split}.txt'), 256)
        want = jpipeline.perturbation_table('', 256, JDataConfig(), seed=seed)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize('index', [0, 5, 255])
    def test_test_split_items(self, datasets, index):
        port, ref = datasets
        got, want = port[index], ref[index]
        assert set(got) == set(want)
        for k in ('pcd_left', 'pcd_right', 'intensity_left', 'intensity_right', 'extrinsic'):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got['igt'], want['igt'], atol=1e-6, rtol=0)
        np.testing.assert_allclose(got['uncalibed_pcd'], want['uncalibed_pcd'], atol=1e-5, rtol=0)
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k

    def test_apply_decalibration(self):
        twist = _twists()[4]
        pts = np.random.default_rng(3).uniform(-60, 60, (100, 3)).astype(np.float32)
        got, igt = pipeline.apply_decalibration(pts, twist)
        want, jigt = jpipeline.apply_decalibration(pts, twist)
        np.testing.assert_allclose(igt, jigt, atol=1e-6, rtol=0)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    def test_minmax_scale(self):
        x = np.random.default_rng(4).uniform(0, 3, 100).astype(np.float32)
        np.testing.assert_array_equal(pipeline.minmax_scale(x), jpipeline.minmax_scale(x))

    def test_refusals(self, tmp_path):
        # a real source needs its files' root
        with pytest.raises(ValueError, match='data-path'):
            load_dataset(DataConfig(dataset='man'), 'test')
        # the train split is no longer refused: its twists are drawn per epoch
        item = load_dataset(DataConfig(pcd_min_samples=64), 'train', length=2)[0]
        assert item['igt'].shape == (4, 4) and np.all(np.isfinite(item['igt']))
        # a table under cfg.path that is missing is drawn by the port and
        # written; an exported one that is missing is refused
        ds = load_dataset(DataConfig(pcd_min_samples=64, path=str(tmp_path)), 'test', length=2)
        assert ds[0]['igt'].shape == (4, 4)
        assert (tmp_path / 'perturbations_file_test.txt').exists()
        ds = pipeline.PairDataset(ds.source, DataConfig(pcd_min_samples=64), 'test')
        ds._perturb_path = str(tmp_path / 'missing.txt')
        with pytest.raises(FileNotFoundError, match='export_torch_weights'):
            ds[0]

    @pytest.mark.parametrize('field,value', [('max_rot_error', 10.0), ('max_trans_error', 1.0),
                                             ('distribution', 'gaussian'),
                                             ('mag_randomly', False)])
    def test_committed_tables_refuse_other_perturbations(self, field, value, tmp_path):
        """The committed val/test tables hold only for the perturbation
        fields they were drawn with (`DataConfig()`'s): another value with an
        empty `cfg.path` raises and names the field; the train split (twists
        drawn per epoch) and a `cfg.path` of the caller's own still load."""
        cfg = dataclasses.replace(DataConfig(pcd_min_samples=64), **{field: value})
        for split in ('val', 'test'):
            with pytest.raises(ValueError, match=f'{field}=') as err:
                load_dataset(cfg, split, length=2)
            assert f'{field}={value!r}' in str(err.value)
        assert load_dataset(cfg, 'train', length=2)[0]['igt'].shape == (4, 4)
        own = load_dataset(dataclasses.replace(cfg, path=str(tmp_path)), 'test', length=2)
        assert own._perturb_path == str(tmp_path / 'perturbations_file_test.txt')
        default = load_dataset(DataConfig(pcd_min_samples=64), 'test', length=2)
        np.testing.assert_array_equal(default.table, pipeline.read_perturbation_table(
            str(ASSETS_DIR / 'perturbations_synthetic_test.txt'), 2))


class TestBatchIterator:
    @pytest.mark.parametrize('batch,shuffle,drop_last', [
        (3, False, False), (3, True, False), (3, False, True), (7, True, True), (8, False, False)])
    def test_same_order_and_shapes(self, batch, shuffle, drop_last):
        items = [{'x': np.full((4, 3), i, np.float32), 'i': np.int64(i)} for i in range(7)]
        got = list(pipeline.batch_iterator(items, batch, shuffle=shuffle, seed=3,
                                           drop_last=drop_last, epoch=1))
        want = list(jpipeline.batch_iterator(items, batch, shuffle=shuffle, seed=3,
                                             drop_last=drop_last, epoch=1))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
        if not drop_last and 7 % batch:
            assert len(got[-1]['i']) == 7 % batch

    def test_dataset_batches_with_ragged_tail(self):
        cfg = DataConfig(pcd_min_samples=64, batch_size=2)
        ds = load_dataset(cfg, 'test', length=3)
        jds = jload_dataset(JDataConfig(**dataclasses.asdict(cfg)), 'test', length=3)
        jds._table = jpipeline.perturbation_table('', 256, JDataConfig(), seed=2)[:3]
        got = list(pipeline.batch_iterator(ds, 2, drop_last=False))
        want = list(jpipeline.batch_iterator(jds, 2, drop_last=False))
        assert [b['igt'].shape[0] for b in got] == [b['igt'].shape[0] for b in want] == [2, 1]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g['pcd_left'], w['pcd_left'])
            np.testing.assert_allclose(g['uncalibed_pcd'], w['uncalibed_pcd'], atol=1e-5, rtol=0)
