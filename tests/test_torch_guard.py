"""The port and `chip_smoke.py` stand without JAX.

The port must run where only PyTorch is installed, so no module of
`pcd_reg_hregnet_torch` and nothing `chip_smoke.py` imports may import
JAX, flax, orbax or the JAX package.  A fresh interpreter with those imports blocked
imports every module (`train/` and `losses/` among them), runs the CPU
serving path once and takes one CPU train step; another runs
`python -m pcd_reg_hregnet_torch --help` and every subcommand (`train`,
`eval --icp-only`, `infer`, `pretrain-feats`, `visualize`) at a small size
on the CPU; a third imports `utils.visualize` and the command line with
matplotlib blocked, as on the card's machine.  The CUDA sources must not
include PyTorch's headers (one plain nvcc call builds them in seconds).
"""
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

_GUARDED = r'''
import sys
for name in ('jax', 'jaxlib', 'flax', 'orbax', 'optax', 'pcd_reg_hregnet_tpu'):
    sys.modules[name] = None          # any import of these now fails
import importlib, pkgutil
import numpy as np
import torch
torch.set_num_threads(1)
import pcd_reg_hregnet_torch
mods = [m.name for m in pkgutil.walk_packages(pcd_reg_hregnet_torch.__path__,
                                              'pcd_reg_hregnet_torch.')]
for m in mods:
    importlib.import_module(m)
import chip_smoke
from pcd_reg_hregnet_torch import serve
from pcd_reg_hregnet_torch.core.config import LevelConfig
from pcd_reg_hregnet_torch.models import zoo
levels = (LevelConfig(64, 16, (16, 16, 32), 32), LevelConfig(32, 8, (32, 32, 64), 64),
          LevelConfig(16, 8, (64, 64, 128), 128))
model = zoo.build('model_v6', device='cpu', levels=levels, ptv3_depths=(1, 1),
                  ptv3_num_heads=(2, 4), ptv3_patch_sizes=(16, 16, 16))
rng = np.random.default_rng(0)
dst = rng.uniform(-40, 40, (400, 3)).astype(np.float32)
src = dst + np.float32(0.2)
out = serve.infer_pair(model, src, dst, device='cpu', num_points=256)
assert np.all(np.isfinite(out['transform'])), out
assert {'pcd_reg_hregnet_torch.train.loop', 'pcd_reg_hregnet_torch.train.objective',
        'pcd_reg_hregnet_torch.train.optimizer', 'pcd_reg_hregnet_torch.train.experiments',
        'pcd_reg_hregnet_torch.losses.losses'} <= set(mods), mods
import dataclasses
from pcd_reg_hregnet_torch.train import experiments, loop
cfg = experiments.experiment('reg_v11')
cfg = dataclasses.replace(cfg, model=model.cfg)
state = loop.create_state(cfg, 10, device='cpu')
igt = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
igt[:, :3, 3] = 0.2
batch = {'uncalibed_pcd': np.stack([src[:256]] * 2), 'pcd_left': np.stack([dst[:256]] * 2),
         'igt': igt}
metrics = loop.make_train_step()(state, loop.to_device(batch, torch.device('cpu')))
assert np.isfinite(float(metrics['loss'])) and state.step == 1, metrics
bad = sorted(k for k, v in sys.modules.items() if v is not None and
             k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'orbax', 'optax',
                                 'pcd_reg_hregnet_tpu'))
assert not bad, bad
print('GUARD_OK', len(mods))
'''


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, '-c', _GUARDED], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'GUARD_OK' in proc.stdout


_CLI = r'''
import sys
for name in ('jax', 'jaxlib', 'flax', 'orbax', 'optax', 'pcd_reg_hregnet_tpu'):
    sys.modules[name] = None
import contextlib, io, json, os, runpy, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
argv = sys.argv
sys.argv = ['pcd_reg_hregnet_torch', '--help']
try:
    runpy.run_module('pcd_reg_hregnet_torch', run_name='__main__')
except SystemExit as e:
    assert e.code == 0, e.code
from pcd_reg_hregnet_torch import cli
from pcd_reg_hregnet_torch.data import load_dataset
from pcd_reg_hregnet_torch.eval import runner
from pcd_reg_hregnet_torch.train import feats_loop, loop


def small(cfg, split, **kw):
    return load_dataset(cfg, split, length=4)
for mod in (loop, runner, feats_loop):
    mod.load_dataset = small
d = tempfile.mkdtemp()
tiny = ['--device', 'cpu', '--debug-scale', '--npoints', '256', '--batch-size', '2']
assert cli.main(['train', *tiny, '--max-steps', '1', '--lr', '1e-4', '--log-dir', d]) == 0
meta = json.load(open(os.path.join(d, 'ckpt', 'last', 'meta.json')))
assert json.loads(meta['config'])['train']['lr'] == 1e-4, meta
assert os.path.exists(os.path.join(d, 'metrics.csv'))
results = os.path.join(d, 'results.json')
assert cli.main(['eval', '--icp-only', *tiny, '--icp-iters', '2', '--results', results]) == 0
np.save(os.path.join(d, 'a.npy'), np.random.default_rng(0).uniform(-20, 20, (300, 3)))
assert cli.main(['infer', '--ckpt', os.path.join(d, 'ckpt', 'last'), '--device', 'cpu',
                 '--npoints', '256', '--src', os.path.join(d, 'a.npy'),
                 '--dst', os.path.join(d, 'a.npy'), '--out', os.path.join(d, 'pose.json')]) == 0
assert cli.main(['pretrain-feats', *tiny, '--max-steps', '1', '--log-dir', d]) == 0
assert cli.main(['visualize', '--results', results, '--out', os.path.join(d, 'plots')]) == 0
bad = sorted(k for k, v in sys.modules.items() if v is not None and
             k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'orbax', 'optax',
                                 'pcd_reg_hregnet_tpu'))
assert not bad, bad
print('CLI_OK', sorted(os.listdir(os.path.join(d, 'plots'))))
'''

_NO_MATPLOTLIB = r'''
import sys
for name in ('matplotlib', 'jax', 'pcd_reg_hregnet_tpu'):
    sys.modules[name] = None
import pcd_reg_hregnet_torch.utils.visualize as v
import pcd_reg_hregnet_torch.cli
viz = v.VisualizeResults(sys.argv[1])
try:
    viz.recall_curve({'error_calib': [[0.0] * 6]})
except ImportError:
    print('NO_MATPLOTLIB_OK')
'''


def _run_fresh(script, *args, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    return subprocess.run([sys.executable, '-c', script, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_cli_runs_every_subcommand_without_jax():
    proc = _run_fresh(_CLI)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert 'CLI_OK' in proc.stdout and 'finest_dist.png' in proc.stdout


def test_visualize_imports_without_matplotlib(tmp_path):
    proc = _run_fresh(_NO_MATPLOTLIB, str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'NO_MATPLOTLIB_OK' in proc.stdout


def test_cuda_sources_include_no_torch_headers():
    sources = sorted((REPO / 'pcd_reg_hregnet_torch' / 'csrc').glob('*.cu*'))
    assert sources
    for src in sources:
        for line in src.read_text().splitlines():
            if line.lstrip().startswith('#include'):
                assert 'torch' not in line and 'ATen' not in line \
                    and 'c10' not in line, f'{src.name}: {line}'


def test_port_imports_and_calls_no_library_kernels():
    roots = ('jax', 'jaxlib', 'flax', 'orbax', 'optax', 'triton', 'pcd_reg_hregnet_tpu')
    calls = ('scaled_dot_product_attention', 'cpp_extension', 'torch.compile(')
    files = [REPO / 'chip_smoke.py', *(REPO / 'pcd_reg_hregnet_torch').rglob('*.py')]
    for path in files:
        for line in path.read_text().splitlines():
            code = line.strip()
            if code.startswith(('import ', 'from ')):
                mod = code.split()[1].split('.')[0]
                assert mod not in roots, f'{path.name}: {code}'
            elif path.name != 'chip_smoke.py':   # it times SDPA as a yardstick only
                assert not any(c in code for c in calls), f'{path.name}: {code}'
