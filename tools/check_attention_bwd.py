"""First check of the attention backward kernel (K3b) on a GPU: build, then
every (K, d) of the train step at B=8 and B=1 and a set of odd shapes,
against the plain backward, with back-to-back times; then one backward
through `PatchAttentionFunction` against autograd of the plain forward.
A short call before the full `chip_smoke.py`.

    python3 tools/check_attention_bwd.py      # on a machine with a GPU
"""
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from pcd_reg_hregnet_torch.core.device import fp32_numerics  # noqa: E402
from pcd_reg_hregnet_torch.ops.kernels import attention as ka, build  # noqa: E402

t0 = time.time()
lib = build.library()
print('build_s', lib.build_s)
for line in lib.build_log.splitlines():
    if 'bwd' in line or ('ptxas info' in line and ('Used' in line or 'spill' in line)):
        print(line)
gen = torch.Generator().manual_seed(0)
shapes = [(4 * b, h, kk, c // h) for b in (8, 1) for kk, c in ((256, 64), (128, 128), (64, 256))
          for h in (2, 4, 8)]
shapes += [(2, 2, 1024, 32), (4, 2, 256, 128), (4, 3, 64, 24), (2, 2, 64, 256), (4, 2, 100, 16),
           (2, 3, 100, 5), (1, 1, 1, 1), (2, 1, 33, 300)]
worst = 0
with fp32_numerics():
    for R, H, K, d in shapes:
        qkv = torch.randn((R, K, 3, H, d), generator=gen).cuda()
        q, k, v = ka.unpack_qkv(qkv)
        o = ka.patch_attention(q, k, v, d ** -0.5)
        g = torch.randn((R, H, K, d), generator=gen).cuda()
        got = ka.patch_attention_backward(q, k, v, o, g, d ** -0.5)
        ref = ka.patch_attention_backward_reference(q, k, v, g, d ** -0.5)
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(got, ref)]
        worst = max(worst, max(errs))
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for _ in range(3):
            ka.patch_attention_backward(q, k, v, o, g, d ** -0.5)
        s.record()
        for _ in range(20):
            ka.patch_attention_backward(q, k, v, o, g, d ** -0.5)
        e.record()
        e.synchronize()
        print(f'{(R, H, K, d)} rel err dq {errs[0]:.2e} dk {errs[1]:.2e} dv {errs[2]:.2e}  '
              f'{s.elapsed_time(e) / 20 * 1e3:.1f} us/call', flush=True)
    qkv = torch.randn((32, 256, 3, 2, 32), generator=gen).cuda().requires_grad_()
    out = ka.PatchAttentionFunction.apply(qkv, 32 ** -0.5)
    gg = torch.randn_like(out)
    out.backward(gg)
    q2 = qkv.detach().clone().requires_grad_()
    ref = ka.patch_attention_reference(*ka.unpack_qkv(q2), 32 ** -0.5).transpose(1, 2)
    ref.backward(gg)
    print('autograd rel err', float((qkv.grad - q2.grad).abs().max() / q2.grad.abs().max()))
print('worst', worst, 'launches', ka.patch_attention_backward.launches, 'total', time.time() - t0)
