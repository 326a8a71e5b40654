"""The port's data parallelism on `torch.distributed` against the JAX
package's sharded step (CPU, gloo ranks).

* `parallel.distributed.initialize` is a no-op in one process; `make_mesh`
  refuses more ranks than the group has (JAX's silently takes fewer
  devices) and needs a group.
* One spawn of 4 gloo ranks: `make_hybrid_mesh(2, 2)` lays the ranks out
  ('dcn', 'ici') row-major and refuses a bad factorisation; `make_mesh`
  refuses 5 ranks and takes a sub-mesh of 2; `shard_batch` and
  `shard_global_batch` give each rank its rows, `replicated` rank 0's
  values.  Then ranks 0-1 form a
  2-rank group for one `reg_v0` train step (small levels, B=4, each rank
  half the batch) and a validation pass with a ragged last batch.
* Held against the port's one-process step on the whole batch (loss,
  every gradient leaf, the BatchNorm running statistics): the same f32
  arithmetic but the order of the all-reduced sums, so 1e-5 relative on
  the loss, each gradient leaf within 1e-4 of its largest value (plus 4x
  the port's own f32-vs-f64 difference of that leaf, for the conv towers'
  kinks), statistics within 1e-5.
* Held against the JAX step compiled over a 2-device mesh (GSPMD, global
  BatchNorm statistics) in `TestPresetTrainStep`'s L2 rule (the conv
  family's loss has kinks within f32 rounding at random weights).
* The val mean over 7 pairs at a global batch of 4 on 2 ranks (the last
  batch's 3 pairs split 2 / 1) counts each real pair once: the mean of the
  pairs' own eval metrics within 1e-5 relative; the JAX package's padded
  tail counts a repeated pair, and the test states that it moves the mean
  by more than 1e-3 relative.

Ranks run `_RANK_BODY` in fresh interpreters that import only torch and
the port (`spawn_ranks`, also used by `test_torch_slam.py`): one spawn for
the whole file, every check's inputs and outputs through files.
"""
import dataclasses
import math
import os
import pathlib
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

from pcd_reg_hregnet_torch.parallel import distributed, mesh

REPO = pathlib.Path(__file__).resolve().parents[1]
torch.set_num_threads(1)

_WORKER = r'''
import sys, traceback
import torch
torch.set_num_threads(1)
rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
try:
    from pcd_reg_hregnet_torch.parallel import distributed
    distributed.initialize(f'file://{d}/store', world, rank, device='cpu')
    inputs = torch.load(f'{d}/inputs.pt', weights_only=False)
    scope = {}
    exec(open(f'{d}/body.py').read(), scope)
    out = scope['run'](rank, world, inputs)
    torch.save(out, f'{d}/out{rank}.pt')
    distributed.shutdown()
except BaseException:
    traceback.print_exc()
    sys.exit(1)
'''


def spawn_ranks(world: int, body: str, inputs: dict, meanwhile, timeout: float = 240):
    """Run `body`'s `run(rank, world, inputs) -> dict` on `world` gloo ranks,
    each a fresh interpreter that imports only torch and the port, and
    `meanwhile()` in this process while they run; returns the ranks'
    results in rank order and what `meanwhile` returned."""
    with tempfile.TemporaryDirectory() as d:
        torch.save(inputs, f'{d}/inputs.pt')
        pathlib.Path(d, 'body.py').write_text(body)
        env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
        env.update(OMP_NUM_THREADS='1', PYTHONPATH=str(REPO))
        procs = [subprocess.Popen([sys.executable, '-c', _WORKER, str(r), str(world), d],
                                  cwd=REPO, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(world)]
        logs = []
        try:
            extra = meanwhile()
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [(r, log) for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
        assert not failed, '\n'.join(f'rank {r}:\n{log}' for r, log in failed)
        return [torch.load(f'{d}/out{r}.pt', weights_only=False) for r in range(world)], extra


# --- one process --------------------------------------------------------------

class TestOneProcess:
    def test_initialize_is_a_noop_alone(self, monkeypatch):
        for k in ('MASTER_ADDR', 'WORLD_SIZE', 'RANK', 'COORDINATOR_ADDRESS',
                  'PROCESS_COUNT', 'PROCESS_INDEX'):
            monkeypatch.delenv(k, raising=False)
        assert distributed.initialize() is False
        assert not distributed.active()
        assert (distributed.world_size(), distributed.rank()) == (1, 0)
        assert distributed.process_local_batch_slice(8) == slice(0, 8)

    def test_initialize_refuses_an_incomplete_description(self, monkeypatch):
        monkeypatch.delenv('MASTER_ADDR', raising=False)
        monkeypatch.setenv('COORDINATOR_ADDRESS', 'localhost:1')
        monkeypatch.delenv('PROCESS_COUNT', raising=False)
        monkeypatch.delenv('PROCESS_INDEX', raising=False)
        with pytest.raises(ValueError, match='incomplete'):
            distributed.initialize()

    def test_make_mesh_refuses_more_ranks_than_exist(self):
        with pytest.raises(ValueError, match='more ranks'):
            mesh.make_mesh(2)
        with pytest.raises(RuntimeError, match='process group'):
            mesh.make_mesh(1)

    def test_pad_to_multiple_repeats_the_first_rows(self):
        out = mesh.pad_to_multiple({'x': np.arange(5)}, 4)
        assert out['x'].tolist() == [0, 1, 2, 3, 4, 0, 1, 2]


# --- the spawned group ----------------------------------------------------------

_RANK_BODY = r'''
import dataclasses
import numpy as np
import torch
import torch.distributed as dist
from pcd_reg_hregnet_torch.parallel import distributed, mesh
from pcd_reg_hregnet_torch.train import loop
from pcd_reg_hregnet_torch.train.objective import RegistrationObjective
from pcd_reg_hregnet_torch.train.optimizer import Optimizer

VAL_BATCH = 4


def meshes(rank, world):
    out = {}
    h = distributed.make_hybrid_mesh(2, 2)
    out['hybrid'] = (tuple(h.mesh_dim_names), tuple(h.shape),
                     h['dcn'].get_local_rank(), h['ici'].get_local_rank())
    for args in ((3, 2), (4, 2)):
        try:
            distributed.make_hybrid_mesh(*args)
            out[f'hybrid{args}'] = 'built'
        except ValueError as e:
            out[f'hybrid{args}'] = str(e)
    try:
        mesh.make_mesh(5)
        out['mesh5'] = 'built'
    except ValueError as e:
        out['mesh5'] = str(e)
    sub = mesh.make_mesh(2)
    out['sub'] = (sub.size(), sub.get_coordinate())
    rows = {'x': np.arange(8)}
    out['shard'] = (mesh.shard_batch(rows, mesh.make_mesh(4))['x'].tolist(),
                    mesh.shard_batch(rows, h)['x'].tolist(),
                    distributed.shard_global_batch(rows)['x'].tolist(),
                    rows['x'][distributed.data_sharding(h, 8)].tolist())
    t, u = torch.full((2,), float(rank)), torch.full((1,), rank + 1.0)
    mesh.replicated([t])
    distributed.replicated_sharding([u])
    out['replicated'] = t.tolist() + u.tolist()
    return out


class Listed:
    """A dataset of fixed pairs."""
    def __init__(self, items):
        self.items = items
    def __len__(self):
        return len(self.items)
    def __getitem__(self, i):
        return self.items[i]


def step(rank, inputs):
    cfg = inputs['cfg']
    obj = RegistrationObjective(cfg)
    obj.load_state_dict(inputs['state'], strict=True)
    state = loop.TrainState(obj, Optimizer(cfg.train, obj.named_parameters(), 100))
    batch = inputs['batch']
    sl = distributed.process_local_batch_slice(len(batch['igt']))
    metrics = loop.make_train_step()(state, {k: torch.from_numpy(batch[k][sl])
                                             for k in loop.USED})
    grads = {n: p.grad.clone() for n, p in obj.named_parameters() if p.grad is not None}
    stats = {k: v.clone() for k, v in obj.state_dict().items()
             if k.endswith(('running_mean', 'running_var'))}
    val = loop.run_epoch(Listed(inputs['val']), loop.make_eval_step(), state, VAL_BATCH,
                         train=False, shuffle=False, seed=0, epoch=0)
    return {'rows': (sl.start, sl.stop), 'metrics': {k: float(v) for k, v in metrics.items()},
            'grads': grads, 'stats': stats, 'val': val}


def run(rank, world, inputs):
    out = {'meshes': meshes(rank, world)}
    # the train step runs on the default group: ranks 0-1 form one of their own
    distributed.shutdown()
    if rank < 2:
        distributed.initialize(inputs['store2'], 2, rank, device='cpu')
        out['step'] = step(rank, inputs)
    return out
'''

VAL_PAIRS, VAL_BATCH = 7, 4   # a last val batch of 3 pairs over 2 ranks: 2 and 1


def _configs():
    from pcd_reg_hregnet_tpu.core.config import LevelConfig as JLevelConfig
    from pcd_reg_hregnet_tpu.train import experiments as jexperiments
    from pcd_reg_hregnet_torch.core.config import LevelConfig
    from pcd_reg_hregnet_torch.train import experiments
    j_levels = (JLevelConfig(32, 8, (16, 16, 32), 32), JLevelConfig(16, 8, (16, 16, 32), 32),
                JLevelConfig(8, 4, (32, 32, 64), 64))
    levels = tuple(LevelConfig(l.nsample, l.k, l.conv_channels, l.desc_dim) for l in j_levels)
    over = dict(pcd_min_samples=128, batch_size=4)
    jcfg = jexperiments.experiment('reg_v0')
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, levels=j_levels),
                               data=dataclasses.replace(jcfg.data, **over))
    cfg = experiments.experiment('reg_v0')
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, levels=levels),
                              data=dataclasses.replace(cfg.data, **over))
    return jcfg, cfg


def _batch(seed, b, n=128):
    """Random target clouds and decalibrated, noisy sources."""
    from pcd_reg_hregnet_torch.geometry import se3
    rng = np.random.default_rng(seed)
    dst = rng.uniform(-20, 20, (b, n, 3)).astype(np.float32)
    tw = np.concatenate([rng.uniform(-0.2, 0.2, (b, 3)),
                         rng.uniform(-0.5, 0.5, (b, 3))], 1).astype(np.float32)
    igt = se3.exp(torch.from_numpy(tw)).numpy()
    src = (np.einsum('bij,bnj->bni', igt[:, :3, :3], dst) + igt[:, None, :3, 3]
           + rng.normal(0, 0.01, dst.shape)).astype(np.float32)
    return {'uncalibed_pcd': src, 'pcd_left': dst, 'igt': igt}


def _port_step(cfg, state_dict, batch, dtype=torch.float32):
    from pcd_reg_hregnet_torch.train import loop
    from pcd_reg_hregnet_torch.train.objective import RegistrationObjective
    from pcd_reg_hregnet_torch.train.optimizer import Optimizer
    obj = RegistrationObjective(cfg)
    obj.load_state_dict(state_dict, strict=True)
    obj.to(dtype)
    state = loop.TrainState(obj, Optimizer(cfg.train, obj.named_parameters(), 100))
    metrics = loop.make_train_step()(state, {k: torch.from_numpy(batch[k]).to(dtype)
                                             for k in loop.USED})
    grads = {n: p.grad.clone() for n, p in obj.named_parameters() if p.grad is not None}
    stats = {k: v.clone() for k, v in obj.state_dict().items()
             if k.endswith(('running_mean', 'running_var'))}
    return {'metrics': {k: float(v) for k, v in metrics.items()}, 'grads': grads,
            'stats': stats, 'state': state}


def _jax_step(jcfg, variables, batch):
    """The JAX package's train-step gradient, loss and BatchNorm statistics,
    compiled over a 2-device mesh with the batch sharded (GSPMD)."""
    from pcd_reg_hregnet_tpu.parallel.mesh import batch_sharding, make_mesh, replicated
    from pcd_reg_hregnet_tpu.train.objective import RegistrationObjective as JObjective
    from pcd_reg_hregnet_torch.utils.convert import from_flax
    jobj = JObjective(jcfg)
    m = make_mesh(2)

    def grad_fn(params, batch_stats, batch):
        def loss_fn(p):
            (loss, metrics, _), mut = jobj.apply({'params': p, 'batch_stats': batch_stats},
                                                 batch, train=True, mutable=['batch_stats'])
            return loss, (metrics, mut['batch_stats'])
        return jax.grad(loss_fn, has_aux=True)(params)

    fn = jax.jit(grad_fn, in_shardings=(replicated(m), replicated(m), batch_sharding(m)),
                 out_shardings=replicated(m))
    sharded = {k: jax.device_put(batch[k], batch_sharding(m)) for k in batch}
    grads, (metrics, stats) = fn(variables['params'], variables['batch_stats'], sharded)
    sd = from_flax({'params': jax.tree.map(np.asarray, grads),
                    'batch_stats': jax.tree.map(np.asarray, stats)})
    return ({k: v for k, v in sd.items() if not k.endswith(('running_mean', 'running_var'))},
            {k: v for k, v in sd.items() if k.endswith(('running_mean', 'running_var'))},
            jax.tree.map(float, metrics))


@pytest.fixture(scope='module')
def group_run(tmp_path_factory):
    """One spawn of 4 gloo ranks (see `_RANK_BODY`); the one-process port
    step and the JAX mesh step on the same variables and batch."""
    from pcd_reg_hregnet_tpu.train.objective import RegistrationObjective as JObjective
    from pcd_reg_hregnet_torch.utils.convert import from_flax
    from test_torch_model import _variables
    jcfg, cfg = _configs()
    batch = _batch(0, 4)
    jobj = JObjective(jcfg)
    variables = _variables(jobj, batch, seed=5, train=False)
    state = from_flax(variables)
    val_batch = _batch(1, VAL_PAIRS)
    val = [{k: v[i] for k, v in val_batch.items()} for i in range(VAL_PAIRS)]
    store2 = f'file://{tmp_path_factory.mktemp("store2")}/store'

    def here():
        from pcd_reg_hregnet_torch.train import loop
        one = _port_step(cfg, state, batch)
        eval_step = loop.make_eval_step()
        per_pair = [{k: float(v) for k, v in eval_step(one['state'], {
            k: torch.from_numpy(p[k][None]) for k in loop.USED})[0].items()} for p in val]
        return dict(one=one, one64=_port_step(cfg, state, batch, torch.float64),
                    per_pair=per_pair, jax=_jax_step(jcfg, variables, batch))
    ranks, out = spawn_ranks(4, _RANK_BODY, {'cfg': cfg, 'state': state, 'batch': batch,
                                             'val': val, 'store2': store2}, here)
    return dict(ranks=ranks, **out)


def _rounding(a: torch.Tensor, b64: torch.Tensor) -> float:
    return float((a.double() - b64.double()).abs().max())


class TestGroup:
    def test_meshes_shards_and_refusals(self, group_run):
        for rank, out in enumerate(group_run['ranks']):
            m = out['meshes']
            assert m['hybrid'] == (('dcn', 'ici'), (2, 2), rank // 2, rank % 2)
            assert 'dcn(2) x ici(3) != 4' in m['hybrid(3, 2)']
            assert 'dcn(2) x ici(4) != 4' in m['hybrid(4, 2)']
            assert 'more ranks' in m['mesh5']
            assert m['sub'] == (2, (rank,) if rank < 2 else None)
            assert m['shard'] == ([2 * rank, 2 * rank + 1],) * 4
            assert m['replicated'] == [0.0, 0.0, 1.0]   # rank 0's values everywhere

    def test_each_rank_takes_its_half(self, group_run):
        assert [r['step']['rows'] for r in group_run['ranks'][:2]] == [(0, 2), (2, 4)]
        assert all('step' not in r for r in group_run['ranks'][2:])

    def test_two_ranks_equal_one_process(self, group_run):
        """Loss, every gradient leaf and the BatchNorm running statistics of
        the 2-rank step against the one-process step on the whole batch."""
        one, one64 = group_run['one'], group_run['one64']
        for r in group_run['ranks'][:2]:
            got = r['step']
            assert got['metrics']['loss'] == pytest.approx(one['metrics']['loss'], rel=1e-5)
            for k, v in one['metrics'].items():
                assert got['metrics'][k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
            assert set(got['grads']) == set(one['grads'])
            for name, want in one['grads'].items():
                tol = 1e-4 * float(want.abs().max()) + 4 * _rounding(want, one64['grads'][name])
                assert float((got['grads'][name] - want).abs().max()) <= tol + 1e-7, name
            assert set(got['stats']) == set(one['stats']) and got['stats']
            for name, want in one['stats'].items():
                np.testing.assert_allclose(got['stats'][name].numpy(), want.numpy(),
                                           rtol=0, atol=1e-5, err_msg=name)
        g0, g1 = (group_run['ranks'][i]['step']['grads'] for i in (0, 1))
        assert all(torch.equal(g0[n], g1[n]) for n in g0)   # one averaged gradient

    def test_two_ranks_against_the_jax_mesh_step(self, group_run):
        """The JAX step over a 2-device mesh: loss within 1e-4 relative, the
        BatchNorm statistics within 1e-4, the gradient in the L2 rule of
        `test_torch_train.py::TestPresetTrainStep` (whole gradient within
        1e-2, each leaf within 5e-2 of its norm or of 1e-3 of the largest)."""
        jgrads, jstats, jmetrics = group_run['jax']
        got = group_run['ranks'][0]['step']
        assert got['metrics']['loss'] == pytest.approx(jmetrics['loss'], rel=1e-4)
        for name, want in jstats.items():
            np.testing.assert_allclose(got['stats'][name].numpy(), want.numpy(), rtol=0,
                                       atol=1e-4, err_msg=name)
        assert set(got['grads']) <= set(jgrads)
        norms = {n: float(jgrads[n].double().norm()) for n in got['grads']}
        diffs = {n: float((got['grads'][n].double() - jgrads[n].double()).norm())
                 for n in got['grads']}
        total = math.sqrt(sum(v * v for v in norms.values()))
        assert math.sqrt(sum(v * v for v in diffs.values())) <= 1e-2 * total
        floor = 1e-3 * max(norms.values())
        for n in norms:
            assert diffs[n] <= 5e-2 * max(norms[n], floor), (n, diffs[n], norms[n])

    def test_val_mean_counts_real_pairs_only(self, group_run):
        """7 val pairs at a global batch of 4 on 2 ranks: the last batch's 3
        pairs split 2 / 1.  Each rank's mean is the mean over the 7 pairs;
        the JAX package pads that batch to 4 with its first pair, which then
        counts in its mean (the documented bias, stated here)."""
        per_pair = group_run['per_pair']
        for key in ('loss', 'rre', 'rte'):
            vals = np.array([p[key] for p in per_pair], np.float64)
            exact = vals.mean()
            padded = (vals[:4].mean() * 4 + vals[[4, 5, 6, 4]].mean() * 3) / 7
            for r in group_run['ranks'][:2]:
                assert r['step']['val'][key] == pytest.approx(exact, rel=1e-5), key
            assert abs(padded - exact) > 1e-3 * abs(exact), (key, padded, exact)
