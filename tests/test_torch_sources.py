"""The port's real-data sources and host pipeline against the JAX package (CPU).

MAN TruckScenes (the devkit-format mini tree of
`tests/test_e2e_truckscenes.py::build_mini_truckscenes`, read by both
packages: split membership, extrinsics, pairs and dataset items), A2D2 (a
small tree written here), camera projection and depth images, voxel
downsampling, the threaded batch iterator, the twist tables each package
writes and the other reads, and `--dataset` / `--data-path` on the port's
`evaluate` and `train` commands.  Items of a given twist table are
bit-identical in points and intensities; `igt` within 1e-6 (the port's
f32 `se3.exp`) and `uncalibed_pcd` within 1e-5 m, as in
`test_torch_data.py`.
"""
import dataclasses
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcd_reg_hregnet_tpu.core.config import DataConfig as JDataConfig
from pcd_reg_hregnet_tpu.data import a2d2 as ja2d2
from pcd_reg_hregnet_tpu.data import batch_iterator as jbatch_iterator
from pcd_reg_hregnet_tpu.data import load_dataset as jload_dataset
from pcd_reg_hregnet_tpu.data import pipeline as jpipeline
from pcd_reg_hregnet_tpu.data import projection as jprojection
from pcd_reg_hregnet_tpu.data import truckscenes as jtruckscenes
from pcd_reg_hregnet_torch.core.config import DataConfig
from pcd_reg_hregnet_torch.data import a2d2, batch_iterator, load_dataset, pipeline, projection
from pcd_reg_hregnet_torch.data import truckscenes
from test_e2e_truckscenes import SPLITS, build_mini_truckscenes

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def mini_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('truckscenes_mini')
    build_mini_truckscenes(str(root))
    return str(root)


def _cfgs(root, **over):
    kw = dict(dataset='man', path=root, version='v1.0-mini', pcd_min_samples=256, **over)
    return DataConfig(**kw), JDataConfig(**kw)


def _assert_items_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        if k == 'igt':
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0)
        elif k == 'uncalibed_pcd':
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


class TestTruckScenes:
    @pytest.mark.parametrize('split', ['train', 'val', 'test'])
    def test_split_membership(self, mini_root, split):
        cfg, jcfg = _cfgs(mini_root)
        got = truckscenes.TruckScenesPairSource(cfg, split)
        want = jtruckscenes.TruckScenesPairSource(jcfg, split)
        assert got.scene_names == want.scene_names == sorted(SPLITS[split])
        assert [s['token'] for s in got.samples] == [s['token'] for s in want.samples]

    def test_hash_fallback_and_missing_splits_file(self, mini_root, tmp_path):
        root = str(tmp_path / 'nosplits')
        shutil.copytree(mini_root, root)
        os.remove(os.path.join(root, 'v1.0-mini', 'splits.json'))
        cfg, jcfg = _cfgs(root, split_ratios=(0.5, 0.3, 0.2))
        names = {}
        for split in ('train', 'val', 'test'):
            names[split] = truckscenes.TruckScenesPairSource(cfg, split).scene_names
            assert names[split] == jtruckscenes.TruckScenesPairSource(jcfg, split).scene_names
        assert sorted(sum(names.values(), [])) == sorted(sum(SPLITS.values(), []))
        cfg = dataclasses.replace(cfg, splits_file=str(tmp_path / 'missing.json'))
        with pytest.raises(FileNotFoundError):
            truckscenes.TruckScenesPairSource(cfg, 'train')

    def test_extrinsic_and_pairs(self, mini_root):
        cfg, jcfg = _cfgs(mini_root)
        for split in ('train', 'test'):
            got = truckscenes.TruckScenesPairSource(cfg, split)
            want = jtruckscenes.TruckScenesPairSource(jcfg, split)
            assert len(got) == len(want) > 0
            for i in range(len(got)):
                a, b = got.load_pair(i), want.load_pair(i)
                assert set(a) == set(b)
                for k in b:
                    assert a[k].dtype == b[k].dtype, k
                    np.testing.assert_allclose(a[k], b[k], atol=1e-6, rtol=1e-6, err_msg=k)
                s = got.samples[i]['data']
                np.testing.assert_allclose(got.extrinsic(s['LIDAR_LEFT'], s['LIDAR_RIGHT']),
                                           want.extrinsic(s['LIDAR_LEFT'], s['LIDAR_RIGHT']),
                                           atol=1e-6, rtol=0)
        x, _ = truckscenes.load_lidar_bin(os.path.join(mini_root, 'sweeps', 's0_0_LEFT.pcd.bin'))
        np.testing.assert_array_equal(x, jtruckscenes.load_lidar_bin(
            os.path.join(mini_root, 'sweeps', 's0_0_LEFT.pcd.bin'))[0])

    def test_dataset_items_with_one_twist_table(self, mini_root, tmp_path):
        # the JAX package writes the test table; both read it
        root = str(tmp_path / 'tree')
        shutil.copytree(mini_root, root)
        cfg, jcfg = _cfgs(root)
        jds = jload_dataset(jcfg, 'test')
        table = jds.table
        assert os.path.exists(os.path.join(root, 'perturbations_file_test.txt'))
        ds = load_dataset(cfg, 'test')
        np.testing.assert_array_equal(ds.table, table)
        for i in range(len(ds)):
            _assert_items_equal(ds[i], jds[i])

    def test_camera_lidar(self, tmp_path):
        # the C2L tables of `tests/test_data.py::test_c2l_loader_contract`
        root = tmp_path
        (root / 'v1.0-mini').mkdir()
        (root / 'sweeps').mkdir()
        np.random.RandomState(0).rand(32, 5).astype('f').tofile(root / 'sweeps' / 'lidar.pcd.bin')
        pose = dict(rotation=[0.9, 0.1, -0.3, 0.2], translation=[1.0, -2.0, 0.5])
        eye = dict(rotation=[1., 0., 0., 0.], translation=[0., 0., 0.])
        tables = {
            'scene': [dict(token='sc', name='scene-1', first_sample_token='sa')],
            'sample': [dict(token='sa', next='',
                            data=dict(CAMERA_LEFT='sd_cam', LIDAR_LEFT='sd_lid'))],
            'sample_data': [
                dict(token='sd_cam', sample_token='sa', channel='CAMERA_LEFT',
                     calibrated_sensor_token='cs_cam', ego_pose_token='ep',
                     filename='img.jpg', height=48, width=64),
                dict(token='sd_lid', sample_token='sa', channel='LIDAR_LEFT',
                     calibrated_sensor_token='cs_lid', ego_pose_token='ep',
                     filename='sweeps/lidar.pcd.bin')],
            'calibrated_sensor': [
                dict(token='cs_cam', camera_intrinsic=np.eye(3).tolist(), **eye),
                dict(token='cs_lid', **pose)],
            'ego_pose': [dict(token='ep', **eye)],
            'sensor': []}
        for name, rows in tables.items():
            json.dump(rows, open(root / 'v1.0-mini' / f'{name}.json', 'w'))
        kw = dict(dataset='man', path=str(root), version='v1.0-mini', mode='C2L',
                  lidar_tokens=('CAMERA_LEFT', 'LIDAR_LEFT'), split_ratios=(1.0, 0.0, 0.0))
        got = truckscenes.TruckScenesPairSource(DataConfig(**kw), 'train').load_camera_lidar(0)
        want = jtruckscenes.TruckScenesPairSource(JDataConfig(**kw),
                                                  'train').load_camera_lidar(0)
        assert set(got) == set(want) and got['image_path'] == want['image_path']
        for k in ('pcd', 'intensity', 'extrinsic', 'intrinsic', 'img_shape'):
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=1e-6, err_msg=k)
        assert got['pcd'].shape == (32, 3) and got['img_shape'].tolist() == [48, 64]


def _write_a2d2(root, n=10):
    """An A2D2 tree: cams_lidars.json with three views, npz sweeps of two
    camera directions."""
    views = {'front_left': {'x-axis': [1.0, 0.1, 0.0], 'y-axis': [-0.1, 1.0, 0.05],
                            'origin': [1.7, 0.5, 0.9]},
             'front_center': {'x-axis': [0.99, -0.05, 0.02], 'y-axis': [0.05, 1.0, 0.0],
                              'origin': [1.9, 0.0, 0.95]}}
    calib = {'cameras': {k: {'view': v} for k, v in views.items()},
             'vehicle': {'view': {'x-axis': [1.0, 0.0, 0.0], 'y-axis': [0.0, 1.0, 0.0],
                                  'origin': [0.0, 0.0, 0.0]}}}
    json.dump(calib, open(os.path.join(root, 'cams_lidars.json'), 'w'))
    rng = np.random.default_rng(0)
    for cam in views:
        d = os.path.join(root, '20180807_145028', 'lidar', f'cam_{cam}')
        os.makedirs(d)
        for i in range(n):
            np.savez(os.path.join(d, f'{i:04d}_lidar_{cam}.npz'),
                     pcloud_points=rng.uniform(-40, 40, (300, 3)).astype(np.float32),
                     **{'pcloud_attr.reflectance': rng.uniform(0, 255, 300).astype(np.float32)})
    return views


class TestA2D2:
    def test_views_pairs_and_split(self, tmp_path):
        views = _write_a2d2(str(tmp_path))
        for a in views.values():
            for b in views.values():
                np.testing.assert_allclose(a2d2.transform_from_to(a, b),
                                           ja2d2.transform_from_to(a, b), atol=1e-12)
        np.testing.assert_array_equal(a2d2.view_to_global(views['front_left']),
                                      ja2d2.view_to_global(views['front_left']))
        with pytest.raises(ValueError, match='too small'):
            a2d2.view_to_global({'x-axis': [0, 0, 0], 'y-axis': [0, 1, 0], 'origin': [0, 0, 0]})
        kw = dict(dataset='audi', path=str(tmp_path), pcd_min_samples=128)
        sizes = []
        for split in ('train', 'val', 'test'):
            got = a2d2.A2D2PairSource(DataConfig(**kw), split)
            want = ja2d2.A2D2PairSource(JDataConfig(**kw), split)
            assert got.pairs == want.pairs
            np.testing.assert_array_equal(got.extrinsic, want.extrinsic)
            for i in range(len(got)):
                a, b = got.load_pair(i), want.load_pair(i)
                for k in b:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            sizes.append(len(got))
        assert sizes == [6, 3, 1]


class TestProjection:
    K = np.array([[100., 0., 32.], [0., 100., 24.], [0., 0., 1.]])

    def test_project_to_image_and_binary_projection(self):
        pts = np.array([[0., 0., 10.], [1., 0., 10.], [0., 0., -5.], [50., 0., 1.],
                        [-0.3, 0.2, 2.]])
        r = np.linalg.norm(pts, axis=1)
        got = projection.project_to_image((48, 64), self.K, pts, r)
        want = jprojection.project_to_image((48, 64), self.K, pts, r)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert got[3].tolist() == [True, True, False, False, True]
        assert got[0].tolist() == [32, 42, 17] and got[1].tolist() == [24, 24, 34]
        for a, b in zip(projection.binary_projection((48, 64), self.K, pts),
                        jprojection.binary_projection((48, 64), self.K, pts)):
            np.testing.assert_array_equal(a[np.isfinite(pts[:, 2] / pts[:, 2])],
                                          b[np.isfinite(pts[:, 2] / pts[:, 2])])

    def test_azimuth_filter(self):
        pts = np.random.default_rng(1).uniform(-5, 5, (200, 3))
        pts[:4] = [[1., 0., 0.], [0., 1., 0.], [-1., -1., 0.], [0., -1., 0.]]
        got = projection.azimuth_filter(pts)
        np.testing.assert_array_equal(got, jprojection.azimuth_filter(pts))
        np.testing.assert_array_equal(got[:2], pts[[0, 3]])

    @pytest.mark.parametrize('n,collide', [(64, False), (400, True)])
    def test_render_depth_images(self, n, collide):
        rng = np.random.RandomState(0)
        pts = rng.uniform(-5, 5, size=(2, n, 3)).astype('f')
        pts[..., 2] = np.abs(pts[..., 2]) + 1.0
        pts[:, :8, 2] = -2.0                                 # behind the camera
        K = np.array([[40., 0., 32.], [0., 40., 24.], [0., 0., 1.]], 'f')
        rng_arr = np.linalg.norm(pts, axis=-1).astype('f')
        inten, dens = rng.rand(2, n).astype('f'), rng.rand(2, n).astype('f')
        ext = np.broadcast_to(np.eye(4, dtype='f'), (2, 4, 4)).copy()
        ext[1, :3, 3] = [0.2, -0.1, 0.3]
        gen = projection.DepthImageRenderer((48, 64), K, *map(torch.from_numpy,
                                                               (rng_arr, inten, dens)))
        img, p = gen(torch.from_numpy(ext), torch.from_numpy(pts))
        jimg, jp = jprojection.DepthImageRenderer((48, 64), K, *map(jnp.asarray, (
            rng_arr, inten, dens)))(jnp.asarray(ext), jnp.asarray(pts))
        assert img.shape == (2, 3, 48, 64)
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-6)
        img, jimg = img.numpy(), np.asarray(jimg)
        for b in range(2):
            u, v, _, valid = projection.project_to_image((48, 64), K, p[b].numpy(), rng_arr[b])
            pix = v * 64 + u
            idx = np.flatnonzero(valid)
            hits = np.bincount(pix, minlength=48 * 64)
            # a pixel one point falls on: the JAX image's values; several:
            # the nearest point's (smallest depth)
            for j, q in zip(idx, pix):
                if hits[q] == 1:
                    np.testing.assert_array_equal(img[b, :, v[pix == q][0], u[pix == q][0]],
                                                  jimg[b, :, v[pix == q][0], u[pix == q][0]])
            for q in np.flatnonzero(hits > 1):
                on = idx[pix == q]
                near = on[np.argmin(p[b].numpy()[on, 2])]
                np.testing.assert_array_equal(img[b, :, q // 64, q % 64],
                                              [rng_arr[b, near], inten[b, near], dens[b, near]])
            assert (img[b].reshape(3, -1)[:, hits == 0] == 0).all()
            assert (hits > 1).any() == collide


class TestPipeline:
    @pytest.mark.parametrize('voxel', [0.5, 2.0])
    def test_voxel_downsample(self, voxel):
        pts = np.random.default_rng(2).uniform(-10, 10, (2000, 3)).astype(np.float32)
        inten = np.random.default_rng(3).uniform(0, 1, 2000).astype(np.float32)
        for args in ((pts, voxel), (pts, voxel, inten)):
            got, want = pipeline.voxel_downsample(*args), jpipeline.voxel_downsample(*args)
            for a, b in zip(got, want):
                if b is None:
                    assert a is None
                else:
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
        assert len(got[0]) < len(pts)
        empty = np.zeros((0, 3), np.float32)
        assert pipeline.voxel_downsample(empty, voxel)[0].shape == (0, 3)

    @pytest.mark.parametrize('workers,prefetch,local', [(4, 2, None), (2, 0, None),
                                                        (3, 1, slice(1, 3))])
    def test_threaded_batch_iterator(self, workers, prefetch, local):
        ds = load_dataset(DataConfig(pcd_min_samples=64), 'train', length=14,
                          points_per_cloud=128)
        kw = dict(shuffle=True, seed=3, epoch=1, local_slice=local)
        sync = list(batch_iterator(ds, 4, **kw))
        par = list(batch_iterator(ds, 4, num_workers=workers, prefetch=prefetch, **kw))
        assert len(sync) == len(par) == 3
        for a, b in zip(sync, par):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        items = [{'x': np.full(2, i, np.float32)} for i in range(9)]
        want = [b['x'] for b in jbatch_iterator(items, 3, drop_last=False, num_workers=2,
                                                local_slice=local)]
        got = [b['x'] for b in batch_iterator(items, 3, drop_last=False, num_workers=2,
                                              local_slice=local)]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        resumed = [b['x'] for b in batch_iterator(items, 4, skip=1, num_workers=2)]
        assert len(resumed) == 1 and resumed[0][0, 0] == 4 and len(got) == 3


class TestTwistTables:
    @pytest.mark.parametrize('distribution', ['uniform', 'gaussian', 'inverse_gaussian'])
    def test_port_writes_jax_reads(self, tmp_path, caplog, distribution):
        cfg = DataConfig(pcd_min_samples=64, path=str(tmp_path), distribution=distribution)
        ds = load_dataset(cfg, 'val', length=6)
        with caplog.at_level('WARNING'):
            table = ds.table
        assert 'drawn by the port itself' in caplog.text
        path = tmp_path / 'perturbations_file_val.txt'
        assert path.exists() and table.shape == (6, 6) and table.dtype == np.float32
        np.testing.assert_array_equal(table, pipeline.draw_twist_table(cfg, 'val', 6))
        jtable = jpipeline.perturbation_table(str(path), 6, JDataConfig(), seed=999)
        np.testing.assert_array_equal(jtable, table)
        # read, not drawn, by the port the next time
        caplog.clear()
        with caplog.at_level('WARNING'):
            again = load_dataset(cfg, 'val', length=6).table
        assert caplog.text == ''
        np.testing.assert_array_equal(again, table)
        igt = ds[2]['igt']
        np.testing.assert_allclose(igt, pipeline.twists_to_igts(table)[2], atol=0)
        assert np.abs(igt[:3, 3]).max() <= cfg.max_trans_error + 1e-6

    def test_jax_writes_port_reads(self, tmp_path):
        path = str(tmp_path / 'perturbations_file_test.txt')
        want = jpipeline.perturbation_table(path, 8, JDataConfig(), seed=2)
        got = load_dataset(DataConfig(pcd_min_samples=64, path=str(tmp_path)), 'test',
                           length=8).table
        np.testing.assert_array_equal(got, want)
        # a file too short for the split is drawn again, as JAX's is
        assert load_dataset(DataConfig(pcd_min_samples=64, path=str(tmp_path)), 'test',
                            length=10).table.shape == (10, 6)


class TestEntryPoints:
    def test_load_dataset_builds_man_and_audi(self, mini_root, tmp_path):
        ds = load_dataset(_cfgs(mini_root)[0], 'val')
        assert isinstance(ds.source, truckscenes.TruckScenesPairSource) and len(ds) == 2
        _write_a2d2(str(tmp_path))
        ds = load_dataset(DataConfig(dataset='audi', path=str(tmp_path)), 'train')
        assert isinstance(ds.source, a2d2.A2D2PairSource) and len(ds) == 6
        for name in ('man', 'audi'):
            with pytest.raises(ValueError, match='data-path'):
                load_dataset(DataConfig(dataset=name), 'test')

    def test_cli_flags_reach_the_data_config(self, monkeypatch, mini_root):
        from pcd_reg_hregnet_torch import evaluate
        from pcd_reg_hregnet_torch.train import __main__ as train_main
        seen = {}

        def fake_evaluate(cfg, weights, **kw):
            seen['eval'] = cfg
            return {'layer_0': {'rre': [0.0]}, 'summary': {}}

        class State:
            step = epoch = 0
            best = {}

        def fake_fit(cfg, **kw):
            seen['train'] = cfg
            return State(), {}

        monkeypatch.setattr(evaluate, 'evaluate', fake_evaluate)
        monkeypatch.setattr(train_main, 'fit', fake_fit)
        assert evaluate.main(['--dataset', 'man', '--data-path', mini_root,
                              '--device', 'cpu']) == 0
        assert train_main.main(['--dataset', 'audi', '--data-path', '/data/a2d2',
                                '--device', 'cpu', '--log-dir', '/tmp/unused']) == 0
        assert (seen['eval'].data.dataset, seen['eval'].data.path) == ('man', mini_root)
        assert seen['eval'].data.pcd_min_samples == 8096          # the checkpoint's own
        assert (seen['train'].data.dataset, seen['train'].data.path) == ('audi', '/data/a2d2')
        evaluate.main(['--device', 'cpu'])
        assert (seen['eval'].data.dataset, seen['eval'].data.path) == ('synthetic', '')
