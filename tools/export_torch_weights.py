"""Export the flagship checkpoint and its eval yardstick for the PyTorch port.

The card's machine has no JAX, orbax or tensorstore, so the port never
reads the orbax directory.  This tool (JAX and orbax required) writes, into
`port_assets/`:

* `r5_v11_knn_best_rre.npz`: `params` and `batch_stats` of the checkpoint,
  with the objective's `model/` prefix dropped, one uncompressed f32 array
  per flax leaf under its `/`-joined path (`params/feature_extraction/...`);
  `opt_state` is left out;
* `r5_v11_knn_best_rre.meta.json`: the checkpoint's `meta.json` as it is;
* `perturbations_synthetic_{val,test}.txt`: the JAX package's eval twist
  tables (`data/pipeline.py::perturbation_table`, seeds 1 and 2), which the
  port cannot regenerate without JAX's PRNG;
* with `--eval`: `v11_r5_eval_jax_cpu.json`, the JAX package's own
  `eval.runner.evaluate(cfg, state, split='test', icp='point_to_plane')` of
  the checkpoint on the CPU (exact kNN there), the port's yardstick.

    JAX_PLATFORMS=cpu python tools/export_torch_weights.py [--eval] [--pairs N]
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

CKPT = 'r5_v11_knn_best_rre'
SPLIT_SEEDS = {'val': 1, 'test': 2}
SPLIT_LENGTHS = {'val': 256, 'test': 256}


def extract(tmp: str) -> str:
    """Unpack `ckpts/<CKPT>.tar.gz.part.*` into `tmp`; returns the orbax dir."""
    parts = sorted(glob.glob(os.path.join(REPO, 'ckpts', f'{CKPT}.tar.gz.part.*')))
    if not parts:
        raise FileNotFoundError(f'no ckpts/{CKPT}.tar.gz.part.*')
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
    """{'params/feature_extraction/.../kernel': f32 array} without `model/`."""
    import numpy as np
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if hasattr(v, 'items'):
                walk(v, prefix + (k,))
            else:
                out['/'.join(prefix + (k,))] = np.asarray(v, np.float32)

    for coll in ('params', 'batch_stats'):
        tree = variables[coll]
        if set(tree) != {'model'}:
            raise KeyError(f'{coll}: expected the single top-level key model, got {sorted(tree)}')
        walk(tree['model'], (coll,))
    return out


def write_tables(out_dir: str, data_cfg) -> None:
    from pcd_reg_hregnet_tpu.data.pipeline import perturbation_table
    for split, seed in SPLIT_SEEDS.items():
        path = os.path.join(out_dir, f'perturbations_synthetic_{split}.txt')
        if os.path.exists(path):
            os.remove(path)     # regenerate from the seed, never from a stale file
        perturbation_table(path, SPLIT_LENGTHS[split], data_cfg, seed=seed)


def run_eval(ckpt_dir: str, out_dir: str, pairs: int) -> None:
    """The JAX package's own eval of the checkpoint, on the CPU."""
    import jax
    import numpy as np
    from pcd_reg_hregnet_tpu.core.config import Config
    from pcd_reg_hregnet_tpu.data import batch_iterator, load_dataset
    from pcd_reg_hregnet_tpu.eval.runner import evaluate
    from pcd_reg_hregnet_tpu.train.loop import create_state, restore_params
    from pcd_reg_hregnet_tpu.train.objective import RegistrationObjective

    if jax.devices()[0].platform != 'cpu':
        raise RuntimeError('run with JAX_PLATFORMS=cpu: the yardstick is the CPU eval')
    with open(os.path.join(ckpt_dir, 'meta.json')) as f:
        cfg = Config.from_json(json.load(f)['config'])
    ds = load_dataset(cfg.data, 'test')
    ds.table                       # the whole split's table, before any cut
    if pairs < len(ds):
        ds.source.length = pairs
    sample = next(batch_iterator(ds, cfg.data.batch_size, drop_last=False))
    state, _ = create_state(cfg, RegistrationObjective(cfg), sample, 1)
    state = restore_params(ckpt_dir, state)
    icp, icp_threshold, icp_iters = 'point_to_plane', 1.0, 30
    t = time.perf_counter()
    out = evaluate(cfg, state, split='test', icp=icp, icp_threshold=icp_threshold,
                   icp_iters=icp_iters, dataset=ds)
    seconds = time.perf_counter() - t
    out['reference'] = {
        'made_by': 'tools/export_torch_weights.py --eval',
        'checkpoint': f'ckpts/{CKPT}.tar.gz.part.*',
        'platform': jax.devices()[0].platform, 'jax': jax.__version__,
        'split': 'test', 'pairs': len(ds), 'batch_size': cfg.data.batch_size,
        'icp': icp, 'icp_threshold': icp_threshold, 'icp_iters': icp_iters,
        'seconds': seconds, 'numpy': np.__version__,
    }
    with open(os.path.join(out_dir, 'v11_r5_eval_jax_cpu.json'), 'w') as f:
        json.dump(out, f)
    print('eval', len(ds), 'pairs in', round(seconds, 1), 's;', out['summary'])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default=os.path.join(REPO, 'port_assets'))
    ap.add_argument('--eval', action='store_true',
                    help='also write the JAX-CPU eval of the test split (long)')
    ap.add_argument('--pairs', type=int, default=SPLIT_LENGTHS['test'],
                    help='evaluate the first N test pairs only')
    args = ap.parse_args()

    import numpy as np
    from pcd_reg_hregnet_tpu.core.config import Config

    os.makedirs(args.out, exist_ok=True)
    tmp = tempfile.mkdtemp()
    try:
        ckpt_dir = extract(tmp)
        leaves = flat_leaves(restore(ckpt_dir))
        np.savez(os.path.join(args.out, f'{CKPT}.npz'), **leaves)
        shutil.copyfile(os.path.join(ckpt_dir, 'meta.json'),
                        os.path.join(args.out, f'{CKPT}.meta.json'))
        with open(os.path.join(ckpt_dir, 'meta.json')) as f:
            cfg = Config.from_json(json.load(f)['config'])
        write_tables(args.out, cfg.data)
        print(f'{len(leaves)} leaves, '
              f'{sum(a.nbytes for a in leaves.values()) / 2**20:.1f} MiB -> {args.out}')
        if args.eval:
            run_eval(ckpt_dir, args.out, args.pairs)
    finally:
        shutil.rmtree(tmp)
    return 0


if __name__ == '__main__':
    sys.exit(main())
