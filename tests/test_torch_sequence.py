"""The port's sequence parallelism (`pcd_reg_hregnet_torch/parallel/sequence.py`)
against the JAX package's (`tests/test_sequence_parallel.py`'s cases), on
gloo CPU ranks.

* `check_patch_alignment`: the JAX cases and the flagship's levels
  (1024/512/256 points, patches 256/128/64) at 1, 2, 4 shards (accepted)
  and 3, 8 (refused), the same outcome and message in both packages.
* One spawn of 4 ranks (`test_torch_parallel.py::spawn_ranks`): the halo
  of `arange(16)` equal to the JAX `shard_map` output; the sharded
  depthwise conv against JAX `shardmap_depthwise_conv` and the dense conv
  within 1e-6, on the 4 ranks and on two replicas of 2 ranks
  (`sequence_group(2)`, and the 'seq' dimension of a 2 x 2 `DeviceMesh`);
  a `PTv3Block` (B=2, N=512, C=32, K=64, curve
  CPE) through `sequence_apply` against JAX `gspmd_sequence_apply` within
  2e-5, a misaligned patch refused; the encoder at L1's shape (N=1024,
  C=64, K=256, kNN CPE) with `seq_axis` under `sequence_mesh` against JAX
  `PointTransformerEncoder(seq_axis='seq')` under its `sequence_mesh`
  within 2e-5, train mode refused.
* One spawn of 2 ranks: the sharded conv on 2 ranks; `evaluate(
  seq_parallel=2)` of a small `reg_v11` (the config of JAX's
  `test_evaluate_seq_parallel_matches`) against JAX's `evaluate(
  seq_parallel=2)` and the port's unsharded one, each summary within rtol
  1e-4 / atol 1e-5; only rank 0 writes the results file; 4 shards over 2
  ranks refused; `python -m pcd_reg_hregnet_torch eval --seq-parallel 2`
  (`cli.main`) on the same pairs.
* In one process: a conv backbone and a missing process group refused;
  `seq_axis` without an active group changes nothing.

The JAX references run on the 8 CPU devices `tests/conftest.py` forces,
while the ranks run (`spawn_ranks`' `meanwhile`).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from pcd_reg_hregnet_tpu.parallel import sequence as jseq
from pcd_reg_hregnet_torch.parallel import sequence
from test_torch_model import _port, _variables
from test_torch_parallel import spawn_ranks


def seq_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ('seq',))


# --- patch alignment ----------------------------------------------------------

FLAGSHIP_LEVELS = ((1024, 256), (512, 128), (256, 64))
ALIGNMENT = [(1024, 64, 4), (1024, 48, 4), (1000, 64, 3)] + [
    (n, k, shards) for shards in (1, 2, 4, 3, 8) for n, k in FLAGSHIP_LEVELS]


def _outcome(check, *args):
    try:
        check(*args)
    except ValueError as e:
        return str(e)
    return 'accepted'


@pytest.mark.parametrize('n,k,shards', ALIGNMENT)
def test_check_patch_alignment_as_jax(n, k, shards):
    got = _outcome(sequence.check_patch_alignment, n, k, shards)
    assert got == _outcome(jseq.check_patch_alignment, n, k, shards)
    if (n, k) in FLAGSHIP_LEVELS:
        assert (got == 'accepted') == (shards in (1, 2, 4)), got
    if shards == 3:
        assert 'divide' in got
    if shards == 8 or k == 48:
        assert 'multiple of patch_size' in got


# --- small module configs ---------------------------------------------------------

CONV = dict(B=2, N=256, C=8, w=3)
BLOCK = dict(B=2, N=512, C=32, K=64, heads=4)
ENCODER = dict(N=1024, C=64, K=256)


def _conv_inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(CONV['B'], CONV['N'], CONV['C'])).astype(np.float32)
    kernel = rng.normal(size=(CONV['w'], 1, CONV['C'])).astype(np.float32)   # flax layout
    return x, kernel


def _jax_conv(x, kernel, n_dev=None):
    if n_dev is None:
        return np.asarray(jax.lax.conv_general_dilated(
            x, kernel, window_strides=(1,), padding='SAME',
            dimension_numbers=('NHC', 'HIO', 'NHC'), feature_group_count=x.shape[-1]))
    return np.asarray(jseq.shardmap_depthwise_conv(jnp.asarray(x), jnp.asarray(kernel),
                                                   seq_mesh(n_dev)))


def _block_parts():
    from pcd_reg_hregnet_tpu.models.ptv3 import PTv3Block as JBlock
    rng = np.random.default_rng(2)
    x = rng.normal(size=(BLOCK['B'], BLOCK['N'], BLOCK['C'])).astype(np.float32)
    jblock = JBlock(channels=BLOCK['C'], num_heads=BLOCK['heads'], patch_size=BLOCK['K'])
    return x, jblock, _variables(jblock, x, seed=3)


def _encoder_parts():
    from pcd_reg_hregnet_tpu.models.ptv3 import PointTransformerEncoder as JEncoder
    rng = np.random.default_rng(4)
    xyz = rng.uniform(-40, 40, (1, ENCODER['N'], 3)).astype(np.float32)
    feat = rng.normal(size=(1, ENCODER['N'], ENCODER['C'])).astype(np.float32)
    kw = dict(channels=ENCODER['C'], depths=(2,), num_heads=(2,), patch_size=ENCODER['K'],
              cpe='knn')
    return xyz, feat, JEncoder(**kw), JEncoder(**kw, seq_axis='seq')


def _port_block(variables):
    from pcd_reg_hregnet_torch.models.ptv3 import PTv3Block
    return _port(PTv3Block(BLOCK['C'], BLOCK['heads'], BLOCK['K']), variables)


def _port_encoder(variables, **kw):
    from pcd_reg_hregnet_torch.models.ptv3 import PointTransformerEncoder
    return _port(PointTransformerEncoder(ENCODER['C'], ENCODER['C'], (2,), (2,), ENCODER['K'],
                                         cpe='knn', **kw), variables)


# --- 4 ranks --------------------------------------------------------------------

_BODY = r'''
import torch
from pcd_reg_hregnet_torch.parallel import sequence


def conv(inputs, group=None):
    x, w = inputs['conv']
    share = sequence.sequence_sharding(x.shape[1], group)
    return sequence.gather_rows(sequence.sharded_depthwise_conv(x[:, share], w, None, group),
                                group)


def four(rank, inputs):
    import torch.distributed as dist
    out = {}
    x = torch.arange(16, dtype=torch.float32).reshape(1, 16, 1)
    out['halo'] = sequence.halo_exchange(x[:, 4 * rank:4 * rank + 4], 1)
    out['conv4'] = conv(inputs)
    out['conv2'] = conv(inputs, sequence.sequence_group(2))
    from torch.distributed.device_mesh import init_device_mesh
    out['conv_mesh'] = conv(inputs, init_device_mesh('cpu', (2, 2),
                                                     mesh_dim_names=('replica', 'seq')))
    block = inputs['block']
    out['block'] = sequence.sequence_apply(block, inputs['block_x'], patch_size=block_k(block))
    try:
        misaligned = inputs['misaligned']
        sequence.sequence_apply(misaligned, torch.zeros(1, 256, 32), patch_size=128)
        out['misaligned'] = 'accepted'
    except ValueError as e:
        out['misaligned'] = str(e)
    enc = inputs['encoder']
    with sequence.sequence_mesh(dist.group.WORLD):
        out['encoder'] = enc(*inputs['encoder_x'])
        enc.train()
        try:
            enc(*inputs['encoder_x'])
            out['train'] = 'accepted'
        except ValueError as e:
            out['train'] = str(e)
    return out


def block_k(block):
    return block.PatchAttention_0.patch_size


def two(rank, inputs, d):
    import dataclasses
    from pcd_reg_hregnet_torch.eval.runner import evaluate
    out = {'conv2': conv(inputs)}
    cfg, weights, pairs = inputs['eval']
    out['eval'] = evaluate(cfg, weights, dataset=pairs, seq_parallel=2, device='cpu',
                           results_path=f'{d}/results{rank}.json')
    # patches that 4 shares of every level hold whole, on 2 ranks
    narrow = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                ptv3_patch_sizes=(8, 8, 4)))
    try:
        evaluate(narrow, weights, dataset=pairs, seq_parallel=4, device='cpu')
        out['more'] = 'accepted'
    except ValueError as e:
        out['more'] = str(e)
    # the command line on the same pairs
    import contextlib, io, os
    from pcd_reg_hregnet_torch import cli
    from pcd_reg_hregnet_torch.eval import runner
    runner.load_dataset = lambda data, split: pairs
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(['eval', '--ckpt', weights, '--seq-parallel', '2', '--device', 'cpu',
                       '--results', f'{d}/cli{rank}.json'])
    out['cli'] = (rc, os.path.exists(f'{d}/cli{rank}.json'))
    return out


def run(rank, world, inputs):
    with torch.no_grad():
        return four(rank, inputs) if world == 4 else two(rank, inputs, inputs['dir'])
'''


@pytest.fixture(scope='module')
def four_ranks():
    from pcd_reg_hregnet_tpu.models.ptv3 import PTv3Block as JBlock
    from pcd_reg_hregnet_torch.models.ptv3 import PTv3Block
    x, kernel = _conv_inputs()
    bx, jblock, bvars = _block_parts()
    xyz, feat, jenc, jenc_sp = _encoder_parts()
    evars = _variables(jenc, xyz, feat, seed=1)
    mis = JBlock(channels=32, num_heads=4, patch_size=128)
    mvars = _variables(mis, np.zeros((1, 256, 32), np.float32))
    inputs = {'conv': (torch.from_numpy(x), torch.from_numpy(kernel.transpose(2, 1, 0).copy())),
              'block': _port_block(bvars), 'block_x': torch.from_numpy(bx),
              'misaligned': _port(PTv3Block(32, 4, 128), mvars),
              'encoder': _port_encoder(evars, seq_axis='seq'),
              'encoder_x': (torch.from_numpy(xyz), torch.from_numpy(feat))}

    def jax_side():
        f = jax.jit(shard_map(lambda xl: jseq.halo_exchange(xl, 1), mesh=seq_mesh(4),
                                  in_specs=(P(None, 'seq', None),),
                                  out_specs=P(None, 'seq', None)))
        halo = np.asarray(f(jnp.arange(16, dtype=jnp.float32).reshape(1, 16, 1))).reshape(4, 6)
        block = np.asarray(jseq.gspmd_sequence_apply(jblock, bvars, jnp.asarray(bx),
                                                     seq_mesh(4), patch_size=BLOCK['K']))
        with jseq.sequence_mesh(seq_mesh(4)):
            enc = np.asarray(jax.jit(jenc_sp.apply)(evars, xyz, feat))
        try:
            jseq.gspmd_sequence_apply(mis, mvars, jnp.zeros((1, 256, 32)), seq_mesh(4),
                                      patch_size=128)
            jmis = 'accepted'
        except ValueError as e:
            jmis = str(e)
        unsharded = _port_encoder(evars)(torch.from_numpy(xyz), torch.from_numpy(feat))
        return {'halo': halo, 'conv4': _jax_conv(x, kernel, 4), 'conv2': _jax_conv(x, kernel, 2),
                'dense': _jax_conv(x, kernel), 'block': block, 'encoder': enc,
                'misaligned': jmis, 'port_unsharded': unsharded.detach().numpy()}

    ranks, ref = spawn_ranks(4, _BODY, inputs, jax_side)
    return ranks, ref


class TestFourRanks:
    def test_halo_exchange_contents(self, four_ranks):
        ranks, ref = four_ranks
        got = np.stack([r['halo'].numpy().reshape(6) for r in ranks])
        np.testing.assert_array_equal(got, ref['halo'])
        np.testing.assert_array_equal(got[0], [0, 0, 1, 2, 3, 4])
        np.testing.assert_array_equal(got[3], [11, 12, 13, 14, 15, 0])

    @pytest.mark.parametrize('shards', ['conv4', 'conv2', 'conv_mesh'])
    def test_sharded_conv_matches_jax_and_dense(self, four_ranks, shards):
        ranks, ref = four_ranks
        for r in ranks:
            got = r[shards].numpy()
            np.testing.assert_allclose(got, ref[shards.replace('_mesh', '2')], rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(got, ref['dense'], rtol=1e-6, atol=1e-6)

    def test_block_matches_gspmd_apply(self, four_ranks):
        ranks, ref = four_ranks
        for r in ranks:
            np.testing.assert_allclose(r['block'].numpy(), ref['block'], rtol=2e-5, atol=2e-5)

    def test_misaligned_patch_rejected(self, four_ranks):
        ranks, ref = four_ranks
        assert 'patch_size' in ref['misaligned']
        assert all(r['misaligned'] == ref['misaligned'] for r in ranks)

    def test_encoder_matches_jax_seq_axis(self, four_ranks):
        ranks, ref = four_ranks
        for r in ranks:
            got = r['encoder'].numpy()
            np.testing.assert_allclose(got, ref['encoder'], rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(got, ref['port_unsharded'], rtol=2e-5, atol=2e-5)
            assert 'eval only' in r['train']


# --- 2 ranks: evaluate ----------------------------------------------------------------

def _eval_configs():
    from pcd_reg_hregnet_tpu.core.config import LevelConfig as JLevelConfig
    from pcd_reg_hregnet_tpu.train import experiment as jexperiment
    from pcd_reg_hregnet_torch.core.config import LevelConfig
    from pcd_reg_hregnet_torch.train.experiments import experiment
    jlevels = (JLevelConfig(64, 16, (16, 16, 32), 32), JLevelConfig(32, 8, (32, 32, 64), 64),
               JLevelConfig(16, 8, (64, 64, 128), 128))
    model = dict(ptv3_patch_sizes=(16, 16, 8), ptv3_depths=(1,), ptv3_num_heads=(2,))
    data = dict(dataset='synthetic', pcd_min_samples=128, batch_size=2)
    out = []
    for exp, levels in ((jexperiment, jlevels),
                        (experiment, tuple(LevelConfig(l.nsample, l.k, l.conv_channels,
                                                       l.desc_dim) for l in jlevels))):
        cfg = exp('reg_v11')
        out.append(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, levels=levels, **model),
            data=dataclasses.replace(cfg.data, **data)))
    return out


def _pairs(n=2, points=256):
    from test_torch_parallel import _batch
    b = _batch(6, n, points)
    return [{k: v[i] for k, v in b.items()} for i in range(n)]


def _write_weights(path, variables, cfg):
    """The model's flax variables as an exported `.npz` with its meta."""
    leaves = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if hasattr(v, 'items'):
                walk(v, prefix + (k,))
            else:
                leaves['/'.join(prefix + (k,))] = np.asarray(v, np.float32)
    for coll in ('params', 'batch_stats'):
        walk(variables[coll], (coll,))
    np.savez(path, **leaves)
    with open(str(path).removesuffix('.npz') + '.meta.json', 'w') as f:
        json.dump({'config': cfg.to_json()}, f)


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    from pcd_reg_hregnet_tpu.eval.runner import evaluate as jevaluate
    from pcd_reg_hregnet_tpu.models.registration import RegistrationModel as JModel
    from pcd_reg_hregnet_tpu.train.loop import TrainState
    from pcd_reg_hregnet_torch.eval.runner import evaluate
    d = tmp_path_factory.mktemp('seq2')
    jcfg, cfg = _eval_configs()
    pairs = _pairs()
    src = np.stack([p['uncalibed_pcd'] for p in pairs])
    dst = np.stack([p['pcd_left'] for p in pairs])
    variables = _variables(JModel(jcfg.model), src, dst, seed=7, train=False)
    weights = d / 'tiny.npz'
    _write_weights(weights, variables, cfg)
    x, kernel = _conv_inputs()
    inputs = {'conv': (torch.from_numpy(x), torch.from_numpy(kernel.transpose(2, 1, 0).copy())),
              'eval': (cfg, str(weights), pairs), 'dir': str(d)}

    def here():
        state = TrainState(step=jnp.zeros((), jnp.int32), params={'model': variables['params']},
                           batch_stats={'model': variables['batch_stats']}, opt_state=None)
        return {'jax': jevaluate(jcfg, state, dataset=pairs, seq_parallel=2),
                'port': evaluate(cfg, weights, dataset=pairs, device='cpu'),
                'conv2': _jax_conv(x, kernel, 2), 'dense': _jax_conv(x, kernel)}

    ranks, ref = spawn_ranks(2, _BODY, inputs, here)
    return ranks, ref, d


class TestTwoRanks:
    def test_sharded_conv_matches_jax_and_dense(self, two_ranks):
        ranks, ref, _ = two_ranks
        for r in ranks:
            np.testing.assert_allclose(r['conv2'].numpy(), ref['conv2'], rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(r['conv2'].numpy(), ref['dense'], rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize('against', ['jax', 'port'])
    def test_evaluate_seq_parallel_matches(self, two_ranks, against):
        ranks, ref, _ = two_ranks
        want = ref[against]['summary']
        for r in ranks:
            got = r['eval']['summary']
            assert set(got) == set(want)
            for k, v in want.items():
                assert np.isclose(got[k], v, rtol=1e-4, atol=1e-5), (k, got[k], v)

    def test_rank_zero_alone_writes_results(self, two_ranks):
        ranks, _, d = two_ranks
        assert os.path.exists(d / 'results0.json') and not os.path.exists(d / 'results1.json')
        with open(d / 'results0.json') as f:
            assert json.load(f)['summary'] == ranks[0]['eval']['summary']
        assert ranks[0]['eval']['summary'] == ranks[1]['eval']['summary']

    def test_command_line_seq_parallel(self, two_ranks):
        ranks, _, d = two_ranks
        assert [r['cli'] for r in ranks] == [(0, True), (0, False)]
        with open(d / 'cli0.json') as f:
            got = json.load(f)['summary']
        for k, v in ranks[0]['eval']['summary'].items():
            assert np.isclose(got[k], v, rtol=1e-4, atol=1e-5), (k, got[k], v)

    def test_more_shards_than_ranks_refused(self, two_ranks):
        ranks, _, _ = two_ranks
        assert all('more ranks' in r['more'] for r in ranks)


# --- one process ------------------------------------------------------------------------

class TestOneProcess:
    def test_evaluate_refuses_a_conv_backbone(self):
        from pcd_reg_hregnet_torch.eval.runner import evaluate
        from pcd_reg_hregnet_torch.train.experiments import experiment
        with pytest.raises(ValueError, match='ptv3'):
            evaluate(experiment('reg_v0'), None, dataset=[], seq_parallel=2, device='cpu')

    def test_evaluate_refuses_without_a_group(self):
        from pcd_reg_hregnet_torch.eval.runner import evaluate
        _, cfg = _eval_configs()
        with pytest.raises(RuntimeError, match='process group'):
            evaluate(cfg, None, dataset=[], seq_parallel=2, device='cpu')
        with pytest.raises(RuntimeError, match='process group'):
            sequence.sequence_group(1)

    def test_seq_axis_without_a_group_changes_nothing(self):
        xyz, feat, jenc, _ = _encoder_parts()
        evars = _variables(jenc, xyz, feat, seed=1)
        args = (torch.from_numpy(xyz), torch.from_numpy(feat))
        with torch.no_grad():
            want = _port_encoder(evars)(*args)
            got = _port_encoder(evars, seq_axis='seq')(*args)
        assert sequence.active_sequence_mesh() is None
        assert torch.equal(got, want)
