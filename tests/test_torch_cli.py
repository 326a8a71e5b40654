"""The port's reference-checkpoint import, logging, profiling, plots and
command line against the JAX package's (CPU).

* `utils.torch_import`: a reference-layout `state_dict` (the fake one of
  `test_pretrain_import.py`, random values) through the port's
  `convert_backbone` + `merge_into` into a small `hregnet`'s `state_dict`
  is bit-identical to the JAX package's `convert_backbone` + `merge_into`
  followed by `utils/convert.py::from_flax`; the result loads strictly;
  `load_state_dict` reads a `.pth` (wrapped or bare) back bit for bit.
* `MetricLogger`: the same calls (append, a header union, a resume trim)
  write a byte-identical `metrics.csv` and the same stdout lines.
* `StepTimer.summary` has the JAX keys; `time_fn` keeps warm-up/iters;
  `trace` writes a trace file.
* `VisualizeResults` / `InferenceVisualizer` write the JAX file names from
  one results dict; `FeatureMapVisualizer.capture` names activations by
  module path.
* Every subcommand parses the same argv to the same Config as the JAX CLI
  (`dataclasses.asdict` compared; the port's runs add `--device cpu`).
* `infer` on a seeded-weights checkpoint writes the pose JSON of
  `serve.infer_pair` on the same clouds (equal: the same CPU forward).
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from pcd_reg_hregnet_tpu import cli as jcli
from pcd_reg_hregnet_tpu.utils import logging as jlogging
from pcd_reg_hregnet_tpu.utils import profiling as jprofiling
from pcd_reg_hregnet_tpu.utils import torch_import as jtorch_import
from pcd_reg_hregnet_tpu.utils import visualize as jvisualize
from pcd_reg_hregnet_torch import cli, serve
from pcd_reg_hregnet_torch.utils import logging, profiling, torch_import, visualize
from pcd_reg_hregnet_torch.utils.convert import from_flax

torch.set_num_threads(1)


# --- reference checkpoint import -----------------------------------------------

def _small_hregnet():
    from pcd_reg_hregnet_tpu import models as jmodels
    from pcd_reg_hregnet_torch.models import zoo
    from test_pretrain_import import SMALL_LEVELS
    from test_torch_model import _variables
    from pcd_reg_hregnet_torch.core.config import LevelConfig
    pts = np.random.default_rng(0).uniform(-20, 20, (1, 128, 3)).astype(np.float32)
    jm = jmodels.build('hregnet', levels=SMALL_LEVELS)
    variables = _variables(jm, pts, pts, seed=4, train=False)
    levels = tuple(LevelConfig(l.nsample, l.k, l.conv_channels, l.desc_dim)
                   for l in SMALL_LEVELS)
    return variables, zoo.build('hregnet', device='cpu', levels=levels)


class TestTorchImport:
    def test_bit_identical_to_jax_and_loads_strictly(self):
        from test_pretrain_import import _fake_torch_sd_from_flax
        variables, model = _small_hregnet()
        sd = _fake_torch_sd_from_flax(variables['params']['feature_extraction'],
                                      variables['batch_stats']['feature_extraction'])
        want = from_flax(jtorch_import.merge_into(variables,
                                                  *jtorch_import.convert_backbone(sd)))
        got = torch_import.merge_into(from_flax(variables), *torch_import.convert_backbone(sd))
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
        imported = [k for k in got if k.startswith('feature_extraction.')]
        assert imported and not torch.equal(got[imported[0]], from_flax(variables)[imported[0]])
        model.load_state_dict(got, strict=True)

    def test_load_state_dict_and_refusals(self, tmp_path):
        from test_pretrain_import import _fake_torch_sd_from_flax
        variables, _ = _small_hregnet()
        sd = _fake_torch_sd_from_flax(variables['params']['feature_extraction'],
                                      variables['batch_stats']['feature_extraction'])
        tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
        torch.save({'net_state_dict': tensors, 'epoch': 3}, tmp_path / 'wrapped.pth')
        torch.save(tensors, tmp_path / 'bare.pth')
        for name in ('wrapped.pth', 'bare.pth'):
            back = torch_import.load_state_dict(str(tmp_path / name))
            assert set(back) == set(sd)
            assert all(np.array_equal(back[k], sd[k]) for k in sd)
        target = from_flax(variables)
        bad = dict(sd, **{'detector_1.convs.0.weight': np.zeros((7, 7, 1, 1), 'f')})
        with pytest.raises(ValueError, match='shape mismatch'):
            torch_import.merge_into(target, *torch_import.convert_backbone(bad))
        with pytest.raises(KeyError, match='no target'):
            torch_import.merge_into(target, *torch_import.convert_backbone(sd),
                                    prefix=('elsewhere',))


# --- logging, profiling, plots ---------------------------------------------------

def _log_calls(make, d):
    lg = make(d, use_wandb=False)
    lg.log_epoch(0, {'loss': 1.0, 'rre': 0.5}, {}, seconds=1.234)
    lg.close()
    lg = make(d, use_wandb=False)
    lg.log_epoch(1, {'loss': 0.5, 'rre': 0.25}, {'loss': 0.75, 'rre': 0.3, 'rte': 0.1},
                 seconds=2.5)
    lg.log_epoch(2, {'loss': 0.4, 'rre': 0.2}, {'loss': 0.7, 'rre': 0.28, 'rte': 0.09},
                 seconds=2.0)
    lg.close()
    lg = make(d, use_wandb=False, trim_from_epoch=2)
    lg.log_epoch(2, {'loss': 0.45, 'rre': 0.21}, {'loss': 0.71, 'rre': 0.27, 'rte': 0.08},
                 seconds=3.0)
    lg.close()
    with open(os.path.join(d, 'metrics.csv'), 'rb') as f:
        return f.read()


class TestUtilities:
    def test_metric_logger_csv_and_stdout_byte_identical(self, tmp_path, capsys):
        want = _log_calls(jlogging.MetricLogger, str(tmp_path / 'jax'))
        want_out = capsys.readouterr().out
        got = _log_calls(logging.MetricLogger, str(tmp_path / 'port'))
        assert got == want and got.count(b'\n') == 4
        assert capsys.readouterr().out == want_out

    def test_metric_logger_writes_the_config(self, tmp_path):
        from pcd_reg_hregnet_torch.train.experiments import experiment
        cfg = experiment('reg_v11')
        logging.MetricLogger(str(tmp_path), cfg).close()
        assert json.loads((tmp_path / 'config.json').read_text()) == json.loads(cfg.to_json())

    def test_step_timer_and_time_fn(self, tmp_path):
        jt, t = jprofiling.StepTimer(), profiling.StepTimer()
        for timer in (jt, t):
            for s in (0.5, 0.01, 0.02, 0.03):
                timer.record(s)
        assert t.summary() == jt.summary()
        with t.step(torch.zeros(3)):
            torch.ones(3).sum()
        assert len(t.samples) == 5 and t.samples[-1] > 0
        calls = []
        assert profiling.time_fn(lambda: calls.append(1) or torch.ones(2), iters=4,
                                 warmup=2) > 0
        assert len(calls) == 6
        with profiling.trace(str(tmp_path / 'trace')):
            torch.ones(64).cumsum(0)
        assert os.path.getsize(tmp_path / 'trace' / 'trace.json') > 0

    def test_step_timer_waits_for_the_card_without_outputs(self, monkeypatch):
        # the block makes its outputs itself, so `step()` gets none: the
        # timer must still wait for the card before it reads the clock
        synced = []
        monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: True)
        monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
        monkeypatch.setattr(torch.cuda, 'synchronize', synced.append)
        t = profiling.StepTimer()
        with t.step():
            synced.append('block')
        assert synced == ['block', torch.device('cuda', 0)] and len(t.samples) == 1

    def test_plot_file_names(self, tmp_path):
        rng = np.random.default_rng(0)
        res = {'error_calib': rng.normal(0, 0.1, (40, 6)).tolist(),
               'rre': rng.uniform(0, 1, 40).tolist(), 'rte': rng.uniform(0, 0.2, 40).tolist()}
        layers = {'layer_0': res, 'layer_1': res}
        names = []
        for mod, d in ((jvisualize, tmp_path / 'jax'), (visualize, tmp_path / 'port')):
            viz, inf = mod.VisualizeResults(str(d)), mod.InferenceVisualizer(str(d))
            cloud = rng.normal(0, 10, (200, 3))
            paths = [viz.error_distributions(res, 'finest'), viz.rre_histogram(res, 'finest'),
                     viz.box_plots(layers), viz.recall_curve(res),
                     inf.bev(cloud, cloud + 1, cloud), inf.sequence_video(
                         [(cloud, cloud + 1, cloud)] * 2, name='seq')]
            assert all(os.path.getsize(p) > 0 for p in paths)
            names.append(sorted(os.listdir(d)))
        assert names[0] == names[1]

    def test_feature_maps_by_module_path(self, tmp_path):
        _, model = _small_hregnet()
        model.eval()
        src = torch.from_numpy(np.random.default_rng(1).uniform(-20, 20, (1, 128, 3))
                               .astype(np.float32))
        fmv = visualize.FeatureMapVisualizer(str(tmp_path))
        captured = fmv.capture(model, src, src + 0.1,
                               filter_fn=lambda path, m: path.startswith('feature_extraction'))
        assert len(captured['feature_extraction']) == 2      # one call per tower
        flat = fmv.flatten(captured)
        key = 'feature_extraction[0]/desc_1'
        assert flat[key].shape == (1, 64, 32)
        assert 'feature_extraction.detector_1.ConvBNReLU_0' in captured
        path = fmv.plot(key, flat[key], xyz=flat['feature_extraction[0]/xyz_1'])
        assert os.path.basename(path) == 'featmap_feature_extraction_0_desc_1.png'
        assert os.path.getsize(path) > 0


# --- the command line --------------------------------------------------------------

class _Stop(Exception):
    pass


def _jax_config(monkeypatch, argv):
    import pcd_reg_hregnet_tpu.data as jdata
    import pcd_reg_hregnet_tpu.eval.runner as jrunner
    import pcd_reg_hregnet_tpu.train as jtrain
    import pcd_reg_hregnet_tpu.train.feats_loop as jfeats_loop
    import pcd_reg_hregnet_tpu.train.objective as jobjective
    seen = []

    def record(*args, **kw):
        seen.append(args[0])
        raise _Stop
    for target, attr in ((jtrain, 'fit'), (jrunner, 'evaluate_icp_only'),
                         (jobjective, 'RegistrationObjective'), (jfeats_loop, 'fit_feats')):
        monkeypatch.setattr(target, attr, record)
    monkeypatch.setattr(jdata, 'load_dataset', lambda *a, **k: None)
    monkeypatch.setattr(jdata, 'batch_iterator', lambda *a, **k: iter([{}]))
    with pytest.raises(_Stop):
        jcli.main(argv)
    return seen[-1]


def _port_config(monkeypatch, argv):
    import pcd_reg_hregnet_torch.eval.runner as runner
    import pcd_reg_hregnet_torch.train.__main__ as train_main
    import pcd_reg_hregnet_torch.train.feats_loop as feats_loop
    seen = []

    def record(*args, **kw):
        seen.append(args[0])
        raise _Stop
    for target, attr in ((train_main, 'fit'), (runner, 'evaluate'),
                         (runner, 'evaluate_icp_only'), (runner, 'load_model'),
                         (feats_loop, 'fit_feats')):
        monkeypatch.setattr(target, attr, record)
    with pytest.raises(_Stop):
        cli.main(argv + ['--device', 'cpu'])
    return seen[-1]


@pytest.fixture(scope='module')
def ckpt_dir(tmp_path_factory):
    """A checkpoint directory whose meta records reg_v6 (model_v2, MI loss)."""
    from pcd_reg_hregnet_tpu.train.experiments import experiment
    d = tmp_path_factory.mktemp('ck')
    (d / 'meta.json').write_text(json.dumps({'config': experiment('reg_v6').to_json()}))
    for name in ('a.npy', 'b.npy'):
        np.save(d / name, np.zeros((10, 3), np.float32))
    return str(d)


ARGVS = {
    'train': ['train', '--experiment', 'reg_v11', '--dataset', 'synthetic', '--batch-size',
              '4', '--epochs', '3', '--lr', '3e-4', '--seed', '7', '--npoints', '512',
              '--ptv3-cpe', 'curve', '--ptv3-grid-size', '0.2', '--compute-dtype', 'bfloat16',
              '--watch', '--use-wandb', '--max-steps', '2'],
    'train_debug_conv': ['train', '--experiment', 'reg_v0', '--debug-scale'],
    'train_debug_ptv3': ['train', '--debug-scale', '--ptv3-cpe', 'none'],
    'eval_icp_only': ['eval', '--icp-only', '--icp', 'point_to_plane', '--experiment',
                      'reg_v6', '--batch-size', '8', '--icp-iters', '5'],
    'eval_ckpt': ['eval', '--ckpt', 'CKPT', '--compute-dtype', 'bfloat16', '--batch-size',
                  '2', '--seq-parallel', '1'],
    'infer': ['infer', '--ckpt', 'CKPT', '--src', 'CKPT/a.npy', '--dst', 'CKPT/b.npy', '--npoints',
              '256', '--icp', 'point_to_point'],
    'pretrain_feats': ['pretrain-feats', '--stage', 'descriptor', '--lr', '5e-4',
                       '--batch-size', '8', '--epochs', '2'],
}


class TestCommandLine:
    @pytest.mark.parametrize('name', sorted(ARGVS))
    def test_same_config_as_the_jax_cli(self, name, monkeypatch, ckpt_dir):
        argv = [a.replace('CKPT', ckpt_dir) for a in ARGVS[name]]
        want = _jax_config(monkeypatch, argv)
        got = _port_config(monkeypatch, argv)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        if 'CKPT' in ARGVS[name]:
            assert got.model.name == 'model_v2' and got.loss.mi

    def test_infer_writes_the_pose_of_infer_pair(self, tmp_path):
        from pcd_reg_hregnet_torch.models import zoo
        from pcd_reg_hregnet_torch.train import loop
        from pcd_reg_hregnet_torch.train.experiments import experiment
        from pcd_reg_hregnet_torch.utils import checkpoint
        from test_torch_model import LEVELS, SMALL
        cfg = experiment('reg_v11')
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, levels=LEVELS,
                                                                 **SMALL))
        checkpoint.save_train(tmp_path / 'ck', loop.create_state(cfg, 1, device='cpu'), cfg)
        rng = np.random.default_rng(3)
        dst = rng.uniform(-30, 30, (700, 3)).astype(np.float32)
        src = dst @ np.array([[1, -0.05, 0], [0.05, 1, 0], [0, 0, 1]], np.float32).T + 0.3
        np.savez(tmp_path / 'src.npz', points=src)
        np.column_stack([dst, np.ones((700, 2), np.float32)]).astype(np.float32).tofile(
            tmp_path / 'dst.bin')
        out = tmp_path / 'pose.json'
        assert cli.main(['infer', '--ckpt', str(tmp_path / 'ck'), '--src',
                         str(tmp_path / 'src.npz'), '--dst', str(tmp_path / 'dst.bin'),
                         '--npoints', '256', '--icp', 'point_to_plane', '--out', str(out),
                         '--device', 'cpu']) == 0
        model = zoo.build('model_v6', device='cpu', weights=tmp_path / 'ck')
        want = serve.infer_pair(model, src, dst, device='cpu', num_points=256,
                                icp='point_to_plane')
        assert json.loads(out.read_text()) == json.loads(json.dumps(want))
        assert set(want) == {'transform', 'rotation', 'translation', 'transform_icp'}

    def test_eval_refuses_without_a_checkpoint(self, capsys):
        assert cli.main(['eval', '--device', 'cpu']) == 2
        assert '--ckpt is required' in capsys.readouterr().err
