"""Which batch sizes of 3x3 matrices `torch.linalg.eigh` takes on a GPU.

`eval/icp.py::estimate_normals` solves one 3x3 covariance per point
(B=8 x 8096 = 64768 at the flagship's size) in blocks of `EIGH_BATCH`;
this probe finds the batch sizes the card's solver refuses.

    python3 tools/probe_eigh.py          # on a machine with a GPU
"""
import torch

print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0))
for n in (1024, 8096, 16384, 32767, 32768, 64768):
    a = torch.randn(n, 16, 3, device='cuda')
    try:
        torch.linalg.eigh(torch.einsum('bki,bkj->bij', a, a) / 16)
        torch.cuda.synchronize()
        print(n, 'ok')
    except RuntimeError as e:
        print(n, 'refused:', str(e).split(',')[0])
