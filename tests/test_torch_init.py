"""The port's seeded init (`models.zoo.init_weights`) against flax's default
kernel init, `lecun_normal`, which every `nn.Dense` and `nn.Conv` of the
JAX models uses (CPU).

flax draws a normal of std s = sqrt(1/fan_in) / 0.87962566103423978
truncated to [-2s, 2s], so of variance 1/fan_in.  Per weight shape of
`model_v6` at small width (all weights of that shape pooled): every value
within the truncation bound, the largest near it, and the standard
deviation within 5 standard errors of the difference of two sample
standard deviations (0.826 / sqrt(n) of the std, from the truncated
normal's kurtosis 2.366) of flax's own draws on the same shape.
"""
import collections
import math

import jax
import numpy as np
import pytest
import torch
from flax.linen import initializers

from pcd_reg_hregnet_torch.models import zoo
from test_torch_model import LEVELS, SMALL

torch.set_num_threads(1)

TRUNC = 0.87962566103423978


def _kernels() -> dict:
    """{torch weight shape: every value of that shape} of seeded model_v6."""
    model = zoo.build('model_v6', device='cpu', seed=0, levels=LEVELS, **SMALL)
    out = collections.defaultdict(list)
    for name, p in model.named_parameters():
        owner = model.get_submodule(name.rsplit('.', 1)[0])
        if name.endswith('weight') and isinstance(owner, (torch.nn.Linear, torch.nn.Conv1d)):
            out[tuple(p.shape)].append(p.detach().numpy().ravel())
    return {s: np.concatenate(v) for s, v in out.items()}


KERNELS = _kernels()


def _flax_shape(shape: tuple) -> tuple:
    """flax's kernel layout of a torch weight: Dense [in, out], Conv [k, in, out]."""
    return tuple(reversed(shape[2:])) + (shape[1], shape[0])


@pytest.mark.parametrize('shape', sorted(KERNELS))
def test_weights_follow_flax_lecun_normal(shape):
    got = KERNELS[shape]
    fan_in = math.prod(shape[1:])
    bound = 2 * math.sqrt(1 / fan_in) / TRUNC
    count = got.size // math.prod(shape)
    want = np.concatenate([np.asarray(initializers.lecun_normal()(
        jax.random.PRNGKey(i), _flax_shape(shape))).ravel() for i in range(count)])
    assert np.abs(want).max() <= bound * (1 + 1e-6)   # the bound is flax's
    assert np.abs(got).max() <= bound * (1 + 1e-6), (np.abs(got).max(), bound)
    tol = 5 * 0.826 / math.sqrt(got.size)
    assert abs(got.std() / want.std() - 1) <= tol, (got.std(), want.std(), tol)


def test_pooled_draws_reach_the_bound_and_keep_variance_one_over_fan_in():
    z = np.concatenate([v * math.sqrt(math.prod(s[1:])) for s, v in KERNELS.items()])
    assert z.size > 10000
    assert 2 / TRUNC * 0.99 < np.abs(z).max() <= 2 / TRUNC * (1 + 1e-6)
    assert abs(z.std() - 1) < 5 * 0.584 / math.sqrt(z.size)


def test_seeded_and_on_the_cpu_generator():
    a = zoo.lecun_normal_((64, 32), 32, torch.Generator().manual_seed(3))
    b = zoo.lecun_normal_((64, 32), 32, torch.Generator().manual_seed(3))
    assert a.dtype == torch.float32 and torch.equal(a, b)
    assert not torch.equal(a, zoo.lecun_normal_((64, 32), 32, torch.Generator().manual_seed(4)))
