"""Export a trained checkpoint and its eval yardstick for the PyTorch port.

The card's machine has no JAX, orbax or tensorstore, so the port never
reads the orbax directory.  This tool (JAX and orbax required) reads
`ckpts/NAME.tar.gz` or its split parts `ckpts/NAME.tar.gz.part.*` and
writes, into `port_assets/`:

* `NAME.npz`: `params` and `batch_stats` of the checkpoint, one
  uncompressed f32 array per flax leaf under its `/`-joined path.  The
  model's leaves drop the objective's `model/` prefix
  (`params/feature_extraction/...`); the objective's other submodules, the
  MI discriminators, keep theirs under `objective/`
  (`objective/params/mi_loss/global_d/Dense_0/kernel`), which no model leaf
  can start with.  A feats pretrain checkpoint (`train/feats.py`'s
  `FeatsObjective`) has `feature_extraction` alone at its top and no
  `model/`: its leaves are written as they are
  (`params/feature_extraction/...`, `batch_stats/feature_extraction/...`).
  `opt_state` is left out;
* `NAME.meta.json`: the checkpoint's `meta.json` as it is;
* `perturbations_synthetic_{val,test}.txt`: the JAX package's eval twist
  tables (`data/pipeline.py::perturbation_table`, seeds 1 and 2), which the
  port cannot regenerate without JAX's PRNG.  Every checkpoint here shares
  one `DataConfig`, so the tables are shared: an existing table that the
  checkpoint's config would make differently is an error, never replaced;
* with `--eval`: `<tag>_<rY>_eval_jax_cpu.json` (for `rY_<tag>_<dir>`, `dir`
  the checkpoint's own directory, e.g. `r4_v11_warm_best_rre` ->
  `v11_warm_r4_eval_jax_cpu.json`; the flagship's and A1's, written before
  the name carried the variant, keep theirs: `EVAL_NAMES`), the JAX
  package's own `eval.runner.evaluate(cfg, state, split='test',
  icp='point_to_plane')` of the checkpoint on the CPU (exact kNN there),
  the port's yardstick; with `--compute-dtype bfloat16` the same eval with
  the model config's `compute_dtype` overridden, as the JAX CLI's `eval
  --compute-dtype` runs it, named with the dtype
  (`v11_r5_eval_bf16_jax_cpu.json`);
* with `--feats` (a descriptor-stage feats checkpoint):
  `<tag>_<rY>_feats_jax_cpu.json`, the JAX package's
  `FeatsObjective(train_desc=True)` at `train=False` on the first
  `--feats-pairs` synthetic test pairs at the checkpoint's batch size: each
  pair's `chamfer_l{1,2,3}` and `matching_l{1,2,3}` (the losses on that
  pair alone), each batch's metrics, and each pair's level-3 keypoints
  `xyz_3` of both clouds.

    JAX_PLATFORMS=cpu python tools/export_torch_weights.py [--ckpt NAME] [--eval] [--pairs N]
    JAX_PLATFORMS=cpu python tools/export_torch_weights.py --eval --compute-dtype bfloat16
    JAX_PLATFORMS=cpu python tools/export_torch_weights.py --ckpt r5_feats_desc_feats_descriptor --feats
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FLAGSHIP = 'r5_v11_knn_best_rre'
SPLIT_SEEDS = {'val': 1, 'test': 2}
SPLIT_LENGTHS = {'val': 256, 'test': 256}
# yardsticks named before the name carried the run's variant
EVAL_NAMES = {'r5_v11_knn_best_rre': 'v11_r5_eval_jax_cpu.json',
              'r4_v6_50_best_rre': 'v6_r4_eval_jax_cpu.json'}
FEATS_PAIRS = 16


def tarball(name: str) -> list:
    """`ckpts/<name>.tar.gz`, or its split parts in order."""
    whole = os.path.join(REPO, 'ckpts', f'{name}.tar.gz')
    parts = [whole] if os.path.exists(whole) else sorted(glob.glob(whole + '.part.*'))
    if not parts:
        raise FileNotFoundError(f'no ckpts/{name}.tar.gz or ckpts/{name}.tar.gz.part.*')
    return parts


def extract(name: str, tmp: str) -> str:
    """Unpack the checkpoint's tarball into `tmp`; returns the orbax dir."""
    parts = tarball(name)
    cat = subprocess.Popen(['cat', *parts], stdout=subprocess.PIPE)
    subprocess.run(['tar', 'xz', '-C', tmp], stdin=cat.stdout, check=True)
    cat.wait()
    (meta,) = glob.glob(os.path.join(tmp, '*', 'meta.json'))
    return os.path.dirname(meta)


def restore(path: str) -> dict:
    """`params` and `batch_stats` as `train/loop.py::restore_params` reads them."""
    import orbax.checkpoint as ocp
    restored = ocp.StandardCheckpointer().restore(os.path.abspath(path))
    return {'params': restored['params'], 'batch_stats': restored.get('batch_stats', {})}


def flat_leaves(variables: dict) -> dict:
    """{'params/feature_extraction/.../kernel': f32 array} without `model/`;
    the objective's other submodules under `objective/<coll>/<module>/...`."""
    import numpy as np
    from pcd_reg_hregnet_torch.utils.checkpoint import OBJECTIVE
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if hasattr(v, 'items'):
                walk(v, prefix + (k,))
            else:
                out['/'.join(prefix + (k,))] = np.asarray(v, np.float32)

    for coll in ('params', 'batch_stats'):
        tree = variables[coll]
        if tree and set(tree) == {'feature_extraction'}:   # a feats pretrain checkpoint
            walk(tree, (coll,))
            continue
        if tree and 'model' not in tree:
            raise KeyError(f'{coll}: no top-level key model in {sorted(tree)}')
        for top, sub in tree.items():
            walk(sub, (coll,) if top == 'model' else (OBJECTIVE, coll, top))
    return out


def write_tables(out_dir: str, data_cfg) -> None:
    """Make each table from its seed; an existing table must come out the
    same, byte for byte, since other checkpoints' exports share it."""
    from pcd_reg_hregnet_tpu.data.pipeline import perturbation_table
    for split, seed in SPLIT_SEEDS.items():
        path = os.path.join(out_dir, f'perturbations_synthetic_{split}.txt')
        fresh = path + '.new'
        if os.path.exists(fresh):
            os.remove(fresh)
        perturbation_table(fresh, SPLIT_LENGTHS[split], data_cfg, seed=seed)
        if os.path.exists(path):
            with open(path, 'rb') as a, open(fresh, 'rb') as b:
                same = a.read() == b.read()
            os.remove(fresh)
            if not same:
                raise RuntimeError(f'{path} differs from the table this checkpoint\'s '
                                   'DataConfig makes; it is left as it was')
        else:
            os.replace(fresh, path)


def yardstick_name(name: str, ckpt_dir: str, kind: str, compute_dtype=None) -> str:
    """`r4_v11_warm_best_rre` (directory `best_rre`), 'eval' ->
    `v11_warm_r4_eval_jax_cpu.json`; `EVAL_NAMES` for the older two.  An
    eval in another compute dtype than the checkpoint's carries it:
    'bfloat16' -> `v11_r5_eval_bf16_jax_cpu.json`."""
    if kind == 'eval' and name in EVAL_NAMES:
        base = EVAL_NAMES[name]
    else:
        run = name.split('_')[0]
        tag = name[len(run) + 1:].removesuffix('_' + os.path.basename(ckpt_dir))
        base = f'{tag}_{run}_{kind}_jax_cpu.json'
    if compute_dtype is None:
        return base
    short = {'bfloat16': 'bf16', 'float32': 'f32'}[compute_dtype]
    return base.replace(f'_{kind}_', f'_{kind}_{short}_')


def test_pairs(cfg, pairs: int):
    """The JAX package's synthetic test split cut to its first `pairs`
    (the twist table made for the whole split first)."""
    from pcd_reg_hregnet_tpu.data import load_dataset
    ds = load_dataset(cfg.data, 'test')
    ds.table                       # the whole split's table, before any cut
    if pairs < len(ds):
        ds.source.length = pairs
    return ds


def reference_meta(name: str, ds, batch_size: int, seconds: float) -> dict:
    import jax
    import numpy as np
    return {'checkpoint': f'ckpts/{name}.tar.gz' + ('.part.*' if '.part.' in tarball(name)[0]
                                                    else ''),
            'platform': jax.devices()[0].platform, 'jax': jax.__version__,
            'split': 'test', 'pairs': len(ds), 'batch_size': batch_size,
            'seconds': seconds, 'numpy': np.__version__}


def run_eval(name: str, ckpt_dir: str, out_dir: str, pairs: int,
             compute_dtype=None) -> None:
    """The JAX package's own eval of the checkpoint, on the CPU; with
    `compute_dtype`, its model config's `compute_dtype` overridden as the
    JAX CLI's `eval --compute-dtype` does."""
    import dataclasses

    import jax
    import numpy as np
    from pcd_reg_hregnet_tpu.core.config import Config
    from pcd_reg_hregnet_tpu.data import batch_iterator
    from pcd_reg_hregnet_tpu.eval.runner import evaluate
    from pcd_reg_hregnet_tpu.train.loop import create_state, restore_params
    from pcd_reg_hregnet_tpu.train.objective import RegistrationObjective

    if jax.devices()[0].platform != 'cpu':
        raise RuntimeError('run with JAX_PLATFORMS=cpu: the yardstick is the CPU eval')
    with open(os.path.join(ckpt_dir, 'meta.json')) as f:
        cfg = Config.from_json(json.load(f)['config'])
    if compute_dtype is not None:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, compute_dtype=compute_dtype))
    ds = test_pairs(cfg, pairs)
    sample = next(batch_iterator(ds, cfg.data.batch_size, drop_last=False))
    state, _ = create_state(cfg, RegistrationObjective(cfg), sample, 1)
    state = restore_params(ckpt_dir, state)
    icp, icp_threshold, icp_iters = 'point_to_plane', 1.0, 30
    t = time.perf_counter()
    out = evaluate(cfg, state, split='test', icp=icp, icp_threshold=icp_threshold,
                   icp_iters=icp_iters, dataset=ds)
    seconds = time.perf_counter() - t
    out['reference'] = dict(reference_meta(name, ds, cfg.data.batch_size, seconds),
                            made_by='tools/export_torch_weights.py --eval', icp=icp,
                            icp_threshold=icp_threshold, icp_iters=icp_iters,
                            compute_dtype=cfg.model.compute_dtype)
    out_name = yardstick_name(name, ckpt_dir, 'eval', compute_dtype)
    with open(os.path.join(out_dir, out_name), 'w') as f:
        json.dump(out, f)
    print('eval', len(ds), 'pairs in', round(seconds, 1), 's;', out['summary'])


def run_feats(name: str, ckpt_dir: str, out_dir: str, pairs: int) -> None:
    """The JAX package's descriptor-stage objective at `train=False` on the
    first `pairs` test pairs, on the CPU: per pair and level the losses of
    that pair alone, per batch the objective's metrics, per pair `xyz_3`."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from pcd_reg_hregnet_tpu.core.config import Config
    from pcd_reg_hregnet_tpu.data import batch_iterator
    from pcd_reg_hregnet_tpu.geometry import se3
    from pcd_reg_hregnet_tpu.losses import matching_loss, prob_chamfer_loss
    from pcd_reg_hregnet_tpu.train.feats import FeatsObjective, create_feats_state
    from pcd_reg_hregnet_tpu.train.loop import restore_params

    if jax.devices()[0].platform != 'cpu':
        raise RuntimeError('run with JAX_PLATFORMS=cpu: the yardstick is the CPU forward')
    with open(os.path.join(ckpt_dir, 'meta.json')) as f:
        cfg = Config.from_json(json.load(f)['config'])
    ds = test_pairs(cfg, pairs)
    bs = cfg.data.batch_size
    objective = FeatsObjective(cfg, train_desc=True)
    sample = next(batch_iterator(ds, bs, drop_last=False))
    state, _ = create_feats_state(cfg, objective, sample, 1)
    state = restore_params(ckpt_dir, state)
    variables = {'params': state.params, 'batch_stats': state.batch_stats}
    apply = jax.jit(lambda v, b: objective.apply(v, b, train=False))
    per_pair = {f'{k}_l{lvl}': [] for k in ('chamfer', 'matching') for lvl in (1, 2, 3)}
    per_pair.update(xyz_3_src=[], xyz_3_dst=[])
    batches = []
    t = time.perf_counter()
    for batch in batch_iterator(ds, bs, drop_last=False):
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        _, metrics, (rs, rd) = apply(variables, batch)
        batches.append({k: float(v) for k, v in metrics.items()})
        gt_R, gt_t = se3.unpack(se3.inverse(batch['igt']))
        for i in range(len(batch['igt'])):
            one = slice(i, i + 1)
            for lvl in (1, 2, 3):
                x, s, d = f'xyz_{lvl}', f'sigmas_{lvl}', f'desc_{lvl}'
                per_pair[f'chamfer_l{lvl}'].append(float(prob_chamfer_loss(
                    rs[x][one], rd[x][one], rs[s][one], rd[s][one], gt_R[one], gt_t[one])))
                per_pair[f'matching_l{lvl}'].append(float(matching_loss(
                    rs[x][one], rs[s][one], rs[d][one], rd[x][one], rd[s][one], rd[d][one],
                    gt_R[one], gt_t[one])))
            per_pair['xyz_3_src'].append(np.asarray(rs['xyz_3'][i], np.float32).tolist())
            per_pair['xyz_3_dst'].append(np.asarray(rd['xyz_3'][i], np.float32).tolist())
    seconds = time.perf_counter() - t
    out = dict(per_pair, batches=batches,
               reference=dict(reference_meta(name, ds, bs, seconds),
                              made_by='tools/export_torch_weights.py --feats',
                              objective='FeatsObjective(train_desc=True), train=False'))
    with open(os.path.join(out_dir, yardstick_name(name, ckpt_dir, 'feats')), 'w') as f:
        json.dump(out, f)
    print('feats', len(ds), 'pairs in', round(seconds, 1), 's;', batches)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--ckpt', default=FLAGSHIP,
                    help='checkpoint name under ckpts/ (default: the flagship)')
    ap.add_argument('--out', default=os.path.join(REPO, 'port_assets'))
    ap.add_argument('--eval', action='store_true',
                    help='also write the JAX-CPU eval of the test split (long)')
    ap.add_argument('--pairs', type=int, default=SPLIT_LENGTHS['test'],
                    help='evaluate the first N test pairs only')
    ap.add_argument('--compute-dtype', default=None, choices=['float32', 'bfloat16'],
                    help='run --eval in this compute dtype (the checkpoint\'s own if unset); '
                         'the file name carries it')
    ap.add_argument('--feats', action='store_true',
                    help='also write the JAX-CPU feats losses of a descriptor-stage checkpoint')
    ap.add_argument('--feats-pairs', type=int, default=FEATS_PAIRS)
    args = ap.parse_args()

    import numpy as np
    from pcd_reg_hregnet_tpu.core.config import Config

    os.makedirs(args.out, exist_ok=True)
    tmp = tempfile.mkdtemp()
    try:
        ckpt_dir = extract(args.ckpt, tmp)
        leaves = flat_leaves(restore(ckpt_dir))
        np.savez(os.path.join(args.out, f'{args.ckpt}.npz'), **leaves)
        shutil.copyfile(os.path.join(ckpt_dir, 'meta.json'),
                        os.path.join(args.out, f'{args.ckpt}.meta.json'))
        with open(os.path.join(ckpt_dir, 'meta.json')) as f:
            cfg = Config.from_json(json.load(f)['config'])
        write_tables(args.out, cfg.data)
        print(f'{len(leaves)} leaves, '
              f'{sum(a.nbytes for a in leaves.values()) / 2**20:.1f} MiB -> {args.out}')
        if args.eval:
            run_eval(args.ckpt, ckpt_dir, args.out, args.pairs, args.compute_dtype)
        if args.feats:
            run_feats(args.ckpt, ckpt_dir, args.out, args.feats_pairs)
    finally:
        shutil.rmtree(tmp)
    return 0


if __name__ == '__main__':
    sys.exit(main())
