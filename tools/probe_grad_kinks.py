"""How the port's and the JAX package's train-step gradients differ, and
why (CPU).

For each experiment, one train step from the same random variables in
both packages, as `tests/test_torch_train.py::TestPresetTrainStep` takes
it (B=2, 256 points, small levels): prints the whole gradient's relative
L2 difference, the largest relative L2 difference of a leaf whose norm is
at least 1e-3 of the largest leaf's, and the count of entries outside
`TestTrainStep`'s element-wise rule (rtol 1e-3, atol 1e-6 plus 4x the
port's own f32-vs-f64 difference of the leaf).  With `--fd LEAF`, for
the entry of that leaf where the packages differ most, the port's and
JAX's analytic gradient beside central finite differences of the port's
train loss in float64 at steps 1e-4, 1e-5 and 1e-6: values that move
between the steps, between the two analytic ones, mark a kink of the loss
(a ReLU or a max over k) within the packages' rounding of the point.

    JAX_PLATFORMS=cpu python tools/probe_grad_kinks.py reg_v0 reg_v2 \\
        --fd model.feature_extraction.detector_2.ConvBNReLU_0.Dense_0.weight
"""
from __future__ import annotations

import argparse
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, 'tests')]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('experiments', nargs='+')
    ap.add_argument('--fd', default=None,
                    help='a parameter name for the finite differences (skipped where absent)')
    args = ap.parse_args()

    import torch
    from test_torch_train import (TestTrainStep, _preset_configs, _rounding,
                                  preset_runs)
    from pcd_reg_hregnet_torch.train.objective import RegistrationObjective
    from pcd_reg_hregnet_torch.utils.convert import from_flax

    torch.set_num_threads(1)
    for name in args.experiments:
        runs = preset_runs(name)
        want, got, g64 = runs['jax'][0], runs['port'][0], runs['port64'][0]
        norms = {n: float(w.double().norm()) for n, w in want.items()}
        diffs = {n: float((got[n].double() - want[n].double()).norm()) for n in want}
        top = max(norms.values())
        leaf, worst = max(((n, diffs[n] / norms[n]) for n in want if norms[n] >= 1e-3 * top),
                          key=lambda x: x[1])
        outside = sum(int(((got[n].double() - want[n].double()).abs() > 1e-3 * want[n].abs()
                           + 1e-6 + TestTrainStep.ROUNDING * _rounding(got[n], g64[n])).sum())
                      for n in want)
        total = math.sqrt(sum(v * v for v in diffs.values())) / math.sqrt(sum(
            v * v for v in norms.values()))
        print(f'{name}: whole gradient rel L2 {total:.2e}; worst leaf rel L2 {worst:.2e} '
              f'({leaf}); {outside} of {sum(w.numel() for w in want.values())} entries '
              f'outside the element-wise rule')
        if args.fd not in want:
            continue
        at = int((got[args.fd] - want[args.fd]).abs().reshape(-1).argmax())
        obj = RegistrationObjective(_preset_configs(name)[1])
        obj.load_state_dict(from_flax(runs['variables']), strict=True)
        obj.double().train()
        batch = {k: torch.from_numpy(v).double() for k, v in runs['batch'].items()}
        param = dict(obj.named_parameters())[args.fd].data.view(-1)
        base = float(param[at])

        def loss(delta: float) -> float:
            param[at] = base + delta
            with torch.no_grad():
                return float(obj(batch)[0])
        fds = [(loss(h) - loss(-h)) / (2 * h) for h in (1e-4, 1e-5, 1e-6)]
        param[at] = base
        print(f'  {args.fd}[{at}]: port {float(got[args.fd].reshape(-1)[at]):.4f}, JAX '
              f'{float(want[args.fd].reshape(-1)[at]):.4f}; f64 central differences at 1e-4, '
              f'1e-5, 1e-6: ' + ', '.join(f'{v:.4f}' for v in fds))
    return 0


if __name__ == '__main__':
    sys.exit(main())
