"""Evaluate the flagship on the 16-pair TruckScenes tree of
`chip_smoke.py::write_man_tree` with both packages on the CPU, to tell a
fault of the port from a property of the data.

Writes the tree into `--out/tree`, runs the port's `evaluate` (which draws
the split's twist table and writes it under the tree), then the JAX
package's `eval.runner.evaluate` on the same tree (whose
`perturbation_table` reads that table) with the flagship's exported
variables, both with point-to-plane ICP, and writes `--out/port_cpu.json`
and `--out/jax_cpu.json`; then prints `tools/compare_evals.py` of the two.

    JAX_PLATFORMS=cpu python tools/probe_man_gap.py --out /tmp/man_probe
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', required=True)
    ap.add_argument('--threads', type=int, default=4, help='the port\'s CPU threads')
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    import chip_smoke
    from pcd_reg_hregnet_torch.eval.runner import evaluate
    from pcd_reg_hregnet_torch.utils import checkpoint
    from pcd_reg_hregnet_tpu.core.config import Config as JConfig
    from pcd_reg_hregnet_tpu.data import load_dataset as jload_dataset
    from pcd_reg_hregnet_tpu.eval.runner import evaluate as jevaluate
    from pcd_reg_hregnet_tpu.train.loop import TrainState

    if jax.devices()[0].platform != 'cpu':
        raise RuntimeError('run with JAX_PLATFORMS=cpu')
    torch.set_num_threads(args.threads)
    root = os.path.join(args.out, 'tree')
    os.makedirs(args.out, exist_ok=True)
    if not os.path.exists(root):
        chip_smoke.write_man_tree(root)
    icp = dict(icp='point_to_plane', icp_threshold=1.0, icp_iters=30)

    cfg = checkpoint.load_config(checkpoint.FLAGSHIP)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset='man', path=root))
    port_path = os.path.join(args.out, 'port_cpu.json')
    t = time.perf_counter()
    evaluate(cfg, checkpoint.FLAGSHIP, split='test', results_path=port_path, device='cpu', **icp)
    print(f'port: {time.perf_counter() - t:.1f} s')

    with open(checkpoint.meta_path(checkpoint.FLAGSHIP)) as f:
        jcfg = JConfig.from_json(json.load(f)['config'])
    jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data, dataset='man', path=root))
    variables = checkpoint.load_variables(checkpoint.FLAGSHIP)
    state = TrainState(step=jnp.zeros((), jnp.int32), params={'model': variables['params']},
                       batch_stats={'model': variables['batch_stats']}, opt_state=None)
    jax_path = os.path.join(args.out, 'jax_cpu.json')
    t = time.perf_counter()
    jevaluate(jcfg, state, split='test', results_path=jax_path,
              dataset=jload_dataset(jcfg.data, 'test'), **icp)
    print(f'jax: {time.perf_counter() - t:.1f} s')
    return subprocess.call([sys.executable, os.path.join(REPO, 'tools', 'compare_evals.py'),
                            jax_path, port_path])


if __name__ == '__main__':
    sys.exit(main())
