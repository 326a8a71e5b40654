"""First check of the attention backward kernel (K3b) on a GPU, a short
call before the full `chip_smoke.py`: build (on failure only the
compiler's errors, which the register reports of every kernel would
otherwise push out of a short log), each K3b kernel's registers and
spills (attention_bwd.cu's and attention_bwd_bf16.cu's), then
`chip_smoke.py`'s K3b phase in f32 and in bf16 (its routes and tilings
against the compiled ones, every shape of the train step and every opened
shape in every tiling of its route against the plain backward, twice,
bit-identical, with device times and the sweep of tilings), one backward through
`PatchAttentionFunction` in each dtype against autograd of the plain
forward, and what
the log-sum-exp costs the forward: K3's device time per B=8 train step
without and with `lse=`, beside K3b's.  Exits non-zero on a failed check.

    python3 tools/check_attention_bwd.py      # on a machine with a GPU
"""
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import ATTN_BWD_TOL, ATTN_BWD_TOL_BF16, check_attention_backward  # noqa: E402
from pcd_reg_hregnet_torch.core.device import fp32_numerics  # noqa: E402
from pcd_reg_hregnet_torch.ops.kernels import attention as ka, build  # noqa: E402
from pcd_reg_hregnet_torch.time_attention import device_ms, shapes  # noqa: E402


def main() -> int:
    t0 = time.perf_counter()
    try:
        lib = build.library()
    except RuntimeError as e:
        print('\n'.join(x for x in str(e).splitlines()
                        if 'ptxas info' not in x and 'bytes stack frame' not in x))
        return 1
    print('build_s', round(lib.build_s, 1))
    entry = None
    for line in lib.build_log.splitlines():
        if 'Compiling entry function' in line:
            entry = line.split("'")[1]
        elif entry and 'bwd' in entry and ('Used' in line or 'spill' in line):
            print(entry.split('attn_bwd_kernel')[-1][:24], line.split(':', 1)[-1].strip())
    gen = torch.Generator().manual_seed(0)
    ok = True
    with fp32_numerics():
        for dtype, tol in ((torch.bfloat16, ATTN_BWD_TOL_BF16), (torch.float32, ATTN_BWD_TOL)):
            check_attention_backward(torch, lib, ka, gen, t0, dtype)
            qkv = torch.randn((32, 256, 3, 2, 32), generator=gen).to('cuda', dtype)
            qkv.requires_grad_()
            out = ka.PatchAttentionFunction.apply(qkv, 32 ** -0.5)
            gg = torch.randn_like(out)
            out.backward(gg)
            q2 = qkv.detach().clone().requires_grad_()
            ref = ka.patch_attention_reference(*ka.unpack_qkv(q2), 32 ** -0.5).transpose(1, 2)
            ref.backward(gg)
            err = float((qkv.grad.float() - q2.grad.float()).abs().max()
                        / q2.grad.float().abs().max())
            print(f'PatchAttentionFunction gradient {dtype}: max |err| / max |value|', err)
            ok &= err <= tol
        step = {'K3': 0.0, 'K3 with lse': 0.0, 'K3b': 0.0}   # per B=8 train step, ms
        for R, H, K, d in shapes(8):   # each shape runs 4 times a step
            q, k, v = (torch.randn((R, H, K, d), generator=gen).cuda() for _ in range(3))
            g = torch.randn((R, H, K, d), generator=gen).cuda()
            lse = torch.empty((R, H, K), device='cuda')
            s = d ** -0.5
            o = ka.patch_attention(q, k, v, s, lse=lse)
            step['K3'] += 4 * device_ms(lambda: ka.patch_attention(q, k, v, s), 20)
            step['K3 with lse'] += 4 * device_ms(lambda: ka.patch_attention(q, k, v, s, lse=lse),
                                                 20)
            step['K3b'] += 4 * device_ms(
                lambda: ka.patch_attention_backward(q, k, v, o, g, s, lse=lse), 20)
    print('device time per B=8 train step (ms): ' + ', '.join(
        f'{name} {x:.4f}' for name, x in step.items()))
    print('total_s', round(time.perf_counter() - t0, 1))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
