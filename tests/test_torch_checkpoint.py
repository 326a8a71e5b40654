"""The flagship checkpoint on the port against the JAX package (CPU).

`port_assets/r5_v11_knn_best_rre.npz` must equal the orbax restore of
`ckpts/r5_v11_knn_best_rre.tar.gz.part.*` leaf for leaf, exactly; its
`meta.json` must give the same `Config` in both packages; the port must
load it with `strict=True`.  The trained forward runs at full width
(levels 1024/512/256, PTv3 depths (2, 2, 2)) on one 2048-point synthetic
test pair: all three levels' poses within 5e-5 (R) and 5e-4 m (t), the
tolerances of `test_torch_forward.py`.
"""
import dataclasses
import glob
import json
import subprocess

import jax
import numpy as np
import pytest
import torch

from pcd_reg_hregnet_tpu.core.config import Config as JConfig
from pcd_reg_hregnet_tpu.data import load_dataset as jload_dataset
from pcd_reg_hregnet_tpu.models.registration import RegistrationModel as JModel
from pcd_reg_hregnet_torch.core.config import Config
from pcd_reg_hregnet_torch.models import zoo
from pcd_reg_hregnet_torch.utils import checkpoint

torch.set_num_threads(1)

FORWARD_POINTS = 2048


def _flagship_variables() -> dict:
    """The committed export as the JAX model's variables."""
    return checkpoint.load_variables(checkpoint.FLAGSHIP)


@pytest.fixture(scope='module')
def orbax_restore(tmp_path_factory):
    """`params`/`batch_stats` of the orbax checkpoint, as
    `train/loop.py::restore_params` restores them."""
    import orbax.checkpoint as ocp
    tmp = tmp_path_factory.mktemp('ckpt')
    parts = sorted(glob.glob(str(checkpoint.ASSETS_DIR.parent / 'ckpts' /
                                 'r5_v11_knn_best_rre.tar.gz.part.*')))
    assert len(parts) == 2
    cat = subprocess.Popen(['cat', *parts], stdout=subprocess.PIPE)
    subprocess.run(['tar', 'xz', '-C', str(tmp)], stdin=cat.stdout, check=True)
    assert cat.wait() == 0
    (meta,) = glob.glob(str(tmp / '*' / 'meta.json'))
    restored = ocp.StandardCheckpointer().restore(meta.rsplit('/', 1)[0])
    with open(meta) as f:
        return restored, json.load(f)


class TestConfig:
    def test_flagship_meta_gives_equal_configs(self, orbax_restore):
        _, meta = orbax_restore
        with open(checkpoint.meta_path(checkpoint.FLAGSHIP)) as f:
            assert json.load(f) == meta
        got, want = Config.from_json(meta['config']), JConfig.from_json(meta['config'])
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert checkpoint.load_config(checkpoint.FLAGSHIP) == got
        assert got.model.name == 'model_v6' and got.data.batch_size == 8

    def test_defaults_equal(self):
        assert dataclasses.asdict(Config()) == dataclasses.asdict(JConfig())
        assert Config.from_json(Config().to_json()) == Config()


class TestWeights:
    def test_npz_equals_orbax_restore(self, orbax_restore):
        restored, _ = orbax_restore
        want = {}
        for coll in ('params', 'batch_stats'):
            for path, leaf in jax.tree_util.tree_leaves_with_path(restored[coll]['model']):
                want['/'.join([coll, *(p.key for p in path)])] = np.asarray(leaf)
        with np.load(checkpoint.FLAGSHIP) as npz:
            assert sorted(npz.files) == sorted(want)
            for k, v in want.items():
                assert npz[k].dtype == np.float32 and v.dtype == np.float32, k
                np.testing.assert_array_equal(npz[k], v, err_msg=k)

    def test_strict_load(self):
        model = zoo.build('model_v6', device='cpu', weights=checkpoint.FLAGSHIP)
        _, state = checkpoint.load(checkpoint.FLAGSHIP)
        assert set(model.state_dict()) == set(state)
        for k, v in model.state_dict().items():
            assert torch.equal(v, state[k]), k
        assert model.data_cfg == checkpoint.load_config(checkpoint.FLAGSHIP).data
        with pytest.raises(ValueError, match='model_v6'):
            zoo.build('model_v1', device='cpu', weights=checkpoint.FLAGSHIP)


class TestTrainedForward:
    def test_all_levels_match_jax(self):
        with open(checkpoint.meta_path(checkpoint.FLAGSHIP)) as f:
            jcfg = JConfig.from_json(json.load(f)['config'])
        ds = jload_dataset(dataclasses.replace(jcfg.data, pcd_min_samples=FORWARD_POINTS), 'test')
        item = ds[0]
        src, dst = item['uncalibed_pcd'][None], item['pcd_left'][None]
        jm = JModel(jcfg.model)
        jout = jax.jit(lambda v, a, b: jm.apply(v, a, b, train=False))(
            _flagship_variables(), src, dst)
        tm = zoo.build('model_v6', device='cpu', weights=checkpoint.FLAGSHIP)
        with torch.no_grad():
            tout = tm(torch.from_numpy(src), torch.from_numpy(dst))
        for lvl in range(3):
            np.testing.assert_allclose(tout['rotation'][lvl].numpy(),
                                       np.asarray(jout['rotation'][lvl]), atol=5e-5, rtol=0)
            np.testing.assert_allclose(tout['translation'][lvl].numpy(),
                                       np.asarray(jout['translation'][lvl]), atol=5e-4, rtol=0)
        # trained weights register the pair: the finest pose undoes igt
        err = np.asarray(jout['rotation'][2])[0] @ item['igt'][:3, :3]
        assert np.degrees(np.arccos(np.clip((np.trace(err) - 1) / 2, -1, 1))) < 2.0
