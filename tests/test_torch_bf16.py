"""The port's bf16 compute path (`compute_dtype='bfloat16'`) against the JAX
package's (CPU).

The JAX package's dtype policy: every `Dense` (and the PTv3 depthwise
conv) computes in bf16 with f32 parameters; the final Dense of `MLPHead`
promotes, so sigmas, correspondence weights and the WFPS weights stay f32;
BatchNorm and LayerNorm run in f32 in train mode and in bf16 in eval mode;
xyz, kNN in xyz, Kabsch and the poses stay f32.  The port reproduces XLA's
CPU rounding where it is a rule of the function (softmax, GELU and a sum of
products rounded as XLA fuses them, a Dense's bias added in f32 where its
consumer takes f32), so that most layers agree bit for bit; where XLA
elides other roundings (a residual sum read by the next LayerNorm) the two
differ by single bf16 roundings.  Tolerances, stated per test, are
therefore in units of one bf16 rounding at the output's scale, `ULP` =
2^-8 of the largest |value| (bf16 keeps 8 significant bits).

The attention: the JAX model's PTv3 attention at these patch sizes is the
dense XLA path, which rounds q*scale and the probabilities p to bf16
(`ptv3.py`); the port's K3/K3b compute the TPU kernel's function (f32
softmax and f32 PV from bf16 inputs, `ops/pallas/attention.py`).  So the
port and the JAX model differ by one bf16 rounding of p and of q*scale in
every attention layer, and the PTv3 tests carry that difference.  The
plain K3/K3b in bf16 are held against the Pallas kernel itself (interpret
mode) and its `_bwd`.

Descriptor-space kNN runs in bf16 (as in JAX), where exact distance ties
are common: the port takes the lower index first, as JAX's `top_k` does.

The backward: each layer's gradients (`jax.vjp` against autograd, in train
mode) to a few bf16 roundings in norm, stated per test; the whole step,
chaotic at random weights, by its norm, direction and per-module norms,
whose bounds a zeroed, halved, doubled, random or partly lost gradient
fails.
"""
import argparse
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pcd_reg_hregnet_tpu import cli as jcli
from pcd_reg_hregnet_tpu.models import attention as jattention
from pcd_reg_hregnet_tpu.models import build as jbuild
from pcd_reg_hregnet_tpu.models import layers as jlayers
from pcd_reg_hregnet_tpu.models import ptv3 as jptv3
from pcd_reg_hregnet_tpu.ops import neighbors as jneighbors
from pcd_reg_hregnet_tpu.ops.pallas import attention as jattn
from pcd_reg_hregnet_torch.geometry import se3
from pcd_reg_hregnet_torch.models import attention, layers, ptv3, zoo
from pcd_reg_hregnet_torch.ops import neighbors
from pcd_reg_hregnet_torch.ops import sampling
from pcd_reg_hregnet_torch.ops.kernels import attention as kattn
from pcd_reg_hregnet_torch.train import experiments, loop
from pcd_reg_hregnet_torch.utils import checkpoint
from pcd_reg_hregnet_torch.utils.convert import from_flax
from test_torch_forward import _pair
from test_torch_model import J_LEVELS, LEVELS, SMALL, _rand, _variables
from test_torch_train import _batches, _configs, _keypoints, _qkvg

torch.set_num_threads(1)

JBF, BF = jnp.bfloat16, torch.bfloat16
ULP = 2.0 ** -8


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.detach().float().numpy()


def _dtype_name(x):
    return str(x.dtype).split('.')[-1]


def _compare(jouts, touts, ulps, what=''):
    """Every output leaf: the same dtype, and within `ulps` bf16 roundings
    at its scale (`ULP` of its largest |value|)."""
    jl, tl = jax.tree.leaves(jouts), jax.tree.leaves(touts)
    assert len(jl) == len(tl), what
    for i, (a, b) in enumerate(zip(jl, tl)):
        assert _dtype_name(a) == _dtype_name(b), (what, i, a.dtype, b.dtype)
        ref, got = _f32(a), _f32(b)
        tol = ulps * ULP * float(np.abs(ref).max())
        err = float(np.abs(got - ref).max())
        assert err <= tol, f'{what} output {i} {a.dtype} {ref.shape}: {err} > {tol}'


def _port(tmod, variables, train):
    tmod.load_state_dict(from_flax(variables), strict=True)
    return tmod.train(train)


# --- module 1-2: layers.py -------------------------------------------------

def _layer_cases():
    x4 = _rand(0, (2, 8, 4, 6)) * 8
    xyz, feat, w = _rand(1, (2, 96, 3), -40, 40), _rand(2, (2, 96, 8)), _rand(3, (2, 96), .5, 1.5)
    grouped, amap = _rand(4, (2, 16, 8, 12)) * 4, _rand(5, (2, 16, 8, 16))
    sx, dx = _rand(6, (2, 32, 3), -40, 40), _rand(7, (2, 32, 3), -40, 40)
    sd, dd = _rand(8, (2, 32, 16)) * 4, _rand(9, (2, 32, 16)) * 4
    sw, dw = _rand(10, (2, 32), 0.1, 2), _rand(11, (2, 32), 0.1, 2)
    reg = (sx, sd, dx, dd, sw, dw)
    return {
        'conv_bn_relu': (lambda: jlayers.ConvBNReLU((16, 8), dtype=JBF),
                         lambda: layers.ConvBNReLU(6, (16, 8), BF), (x4,), True),
        'mlp_head': (lambda: jlayers.MLPHead((12, 12), 1, dtype=JBF),
                     lambda: layers.MLPHead(6, (12, 12), 1, BF), (x4,), True),
        'detector': (lambda: jlayers.KeypointDetector(nsample=32, k=8, out_channels=(8, 8, 16),
                                                      dtype=JBF),
                     lambda: layers.KeypointDetector(0, 32, 8, (8, 8, 16), True, BF),
                     (xyz, None, None), True),
        'detector_feats': (lambda: jlayers.KeypointDetector(nsample=32, k=8,
                                                            out_channels=(8, 8, 16), dtype=JBF),
                           lambda: layers.KeypointDetector(8, 32, 8, (8, 8, 16), True, BF),
                           (xyz, feat, w), True),
        'desc_extractor': (lambda: jlayers.DescExtractor((8, 8, 16), 32, dtype=JBF),
                           lambda: layers.DescExtractor(12, 16, (8, 8, 16), 32, BF),
                           (grouped, amap), True),
        'coarse_reg': (lambda: jlayers.CoarseReg(k=8, in_channels=16, return_dists=True,
                                                 dtype=JBF),
                       lambda: layers.CoarseReg(8, 16, True, True, True, dtype=BF), reg, True),
        'coarse_reg_mi': (lambda: jlayers.CoarseReg(k=8, in_channels=16, mi_outputs=True,
                                                    dtype=JBF),
                          lambda: layers.CoarseReg(8, 16, mi_outputs=True, dtype=BF), reg, True),
        'fine_reg': (lambda: jlayers.FineReg(k=8, in_channels=16, dtype=JBF),
                     lambda: layers.FineReg(8, 16, dtype=BF), reg, True),
        'fine_reg_mi': (lambda: jlayers.FineReg(k=8, in_channels=16, mi_outputs=True, dtype=JBF),
                        lambda: layers.FineReg(8, 16, True, BF), reg, True),
        'detector_self_attention': (
            lambda: jattention.KeypointDetectorSelfAttention(nsample=32, k=8,
                                                             out_channels=(8, 8, 16), dtype=JBF),
            lambda: attention.KeypointDetectorSelfAttention(8, 32, 8, (8, 8, 16), True, BF),
            (xyz, feat, w), True),
    }


# observed at most 2.2 (train mode, where an f32 sum's last bit moves the
# bf16 rounding of the next Dense's input); every eval output agrees exactly
LAYER_ULPS = 4


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('name', sorted(_layer_cases()))
def test_layers(name, train):
    """Each layer of `models/layers.py` and model_v5's detector, in eval and
    train mode (BatchNorm on batch statistics), from the same random flax
    variables: every output of the jitted flax module and the port within
    `LAYER_ULPS` bf16 roundings at its scale, in the same dtype (bf16
    features in eval, f32 in train, f32 keypoints, sigmas and weights)."""
    jmk, tmk, args, _ = _layer_cases()[name]
    jm = jmk()
    v = _variables(jm, *args)
    tm = _port(tmk(), v, train)
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    if train:
        fn = jax.jit(lambda v, *a: jm.apply(v, *a, train=True, mutable=['batch_stats'])[0])
    else:
        fn = jax.jit(lambda v, *a: jm.apply(v, *a))
    jout = fn(v, *args)
    tout = tm(*targs)
    _compare(jout, tout, LAYER_ULPS, name)


# --- module 3: ptv3.py -----------------------------------------------------

def _ptv3_cases():
    """name: (flax module, port module, flax args, port args, the index of
    the activation argument, whether the module takes `train`)."""
    x = _rand(20, (2, 32, 16)) * 4
    xyz = _rand(21, (2, 32, 3), -40, 40)
    jidx, jrel = jptv3.cpe_neighbors(jnp.asarray(xyz))
    idx, rel = ptv3.cpe_neighbors(torch.from_numpy(xyz))
    exyz, efeat = _rand(22, (2, 64, 3), -40, 40), _rand(23, (2, 64, 8)) * 4
    return {
        'depthwise_conv': (lambda: jptv3.SerializedDepthwiseConv(16, kernel=5, dtype=JBF),
                           lambda: ptv3.SerializedDepthwiseConv(16, 5, BF), (x,), (x,), 0,
                           False),
        'knn_cpe': (lambda: jptv3.KnnCPE(16, dtype=JBF), lambda: ptv3.KnnCPE(16, dtype=BF),
                    (x, jidx, jrel), (x, idx, rel), 0, False),
        'patch_attention': (lambda: jptv3.PatchAttention(16, 2, 16, dtype=JBF),
                            lambda: ptv3.PatchAttention(16, 2, 16, dtype=BF), (x,), (x,), 0,
                            False),
        'mlp': (lambda: jptv3.PTv3Mlp(16, dtype=JBF), lambda: ptv3.PTv3Mlp(16, dtype=BF),
                (x,), (x,), 0, False),
        'block_knn': (lambda: jptv3.PTv3Block(16, 2, 16, cpe='knn', dtype=JBF),
                      lambda: ptv3.PTv3Block(16, 2, 16, cpe='knn', dtype=BF),
                      (x, jidx, jrel), (x, idx, rel), 0, True),
        'block_curve': (lambda: jptv3.PTv3Block(16, 2, 16, cpe='curve', dtype=JBF),
                        lambda: ptv3.PTv3Block(16, 2, 16, cpe='curve', dtype=BF),
                        (x, None, None), (x, None, None), 0, True),
        'encoder': (lambda: jptv3.PointTransformerEncoder(16, depths=(1, 1), num_heads=(2, 4),
                                                          patch_size=16, cpe='knn', dtype=JBF),
                    lambda: ptv3.PointTransformerEncoder(8, 16, (1, 1), (2, 4), 16, cpe='knn',
                                                         dtype=BF),
                    (exyz, efeat), (exyz, efeat), 1, True),
    }


# one rounding of p and of q*scale in every attention (the stated
# difference) and XLA's elided roundings, carried through the residual
# stream; observed at most 0.9 (attention), 1.3 (conv), 2.4 (block), 3.3
# (encoder); the CPE and MLP agree exactly
PTV3_ULPS = {'depthwise_conv': 2, 'knn_cpe': 1, 'mlp': 1, 'patch_attention': 2,
             'block_knn': 4, 'block_curve': 4, 'encoder': 6}


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('name', sorted(_ptv3_cases()))
def test_ptv3(name, train):
    """Each module of `models/ptv3.py` as the model runs it: in eval mode
    on a bf16 activation (LayerNorm and BatchNorm in bf16), in train mode on
    an f32 one (LayerNorm and the stem BatchNorm in f32, every sublayer's
    output back in f32), from the same random flax variables.  Every output
    within `PTV3_ULPS[name]` bf16 roundings at its scale, in the same
    dtype.  The attention's allowance is the stated difference of p and
    q*scale; the conv, CPE and MLP agree to one rounding."""
    jmk, tmk, args, targs, act, takes_train = _ptv3_cases()[name]
    jm = jmk()
    v = _variables(jm, *args)
    tm = _port(tmk(), v, train)
    args, targs = list(args), list(targs)
    if not train:   # the model hands these modules bf16 activations in eval
        args[act] = np.asarray(jnp.asarray(args[act], JBF))
        targs[act] = torch.from_numpy(targs[act]).to(BF)
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in targs]
    args = [jnp.asarray(a, JBF) if i == act and not train else a for i, a in enumerate(args)]
    kw = {'train': train} if takes_train else {}
    if train and takes_train:
        fn = jax.jit(lambda v, *a: jm.apply(v, *a, **kw, mutable=['batch_stats'])[0])
    else:
        fn = jax.jit(lambda v, *a: jm.apply(v, *a, **kw))
    _compare(fn(v, *args), tm(*targs), PTV3_ULPS[name], name)


# --- the backward of each layer in train mode ------------------------------

def _vjp_both(jm, v, args, tm, targs, kw, seed):
    """The gradient of <outputs, cotangent> for one random cotangent (per
    output leaf, in its dtype), by `jax.vjp` of the flax module in train
    mode and by autograd of the port's: (JAX's, the port's) gradients of
    the parameters by `state_dict` name and of the float inputs by index,
    as f32 numpy."""
    rest = {k: x for k, x in v.items() if k != 'params'}
    fi = [i for i, a in enumerate(args)
          if a is not None and jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)]

    def f(params, *fa):
        a = list(args)
        for i, x in zip(fi, fa):
            a[i] = x
        out = jm.apply({'params': params, **rest}, *a, **kw, mutable=['batch_stats'])
        return out[0]

    primals = (v['params'],) + tuple(args[i] for i in fi)
    jout = jax.eval_shape(f, *primals)
    rng = np.random.default_rng(seed)
    cots = [np.zeros(x.shape, jax.dtypes.float0) if not jnp.issubdtype(x.dtype, jnp.floating)
            else np.asarray(jnp.asarray(rng.standard_normal(x.shape), x.dtype))
            for x in jax.tree.leaves(jout)]
    tree = jax.tree.unflatten(jax.tree.structure(jout), cots)
    jg = jax.jit(lambda *p: jax.vjp(f, *p)[1](tree))(*primals)
    jgrads = {k: t.numpy() for k, t in from_flax({'params': jax.tree.map(np.asarray,
                                                                         jg[0])}).items()}
    jgrads.update({i: _f32(g) for i, g in zip(fi, jg[1:])})

    targs = list(targs)
    for i in fi:
        targs[i] = targs[i].detach().requires_grad_()
    touts = [t for t in jax.tree.leaves(tm(*targs)) if t.is_floating_point()]
    tcots = [torch.from_numpy(np.asarray(c, np.float32)).to(t.dtype)
             for c, t in zip((c for c in cots if c.dtype != jax.dtypes.float0), touts)]
    torch.autograd.backward(touts, tcots)
    tgrads = {n: (torch.zeros_like(q) if q.grad is None else q.grad).numpy()
              for n, q in tm.named_parameters()}
    tgrads.update({i: np.zeros(targs[i].shape, np.float32) if targs[i].grad is None
                   else _f32(targs[i].grad) for i in fi})
    return jgrads, tgrads


def _compare_grads(jgrads, tgrads, ulps, what):
    """Every gradient within `ulps` bf16 roundings, in norm: |dg| <= ulps *
    ULP * max(|g|, |g_max| / 10), |g_max| the module's largest gradient
    norm (a bias ahead of a train-mode BatchNorm has a gradient of round-off
    only; against a tenth of the largest, its errors are as small as the
    others')."""
    assert set(jgrads) == set(tgrads), what
    top = max(float(np.linalg.norm(g)) for g in jgrads.values())
    assert top > 0, what
    for key, ref in jgrads.items():
        got = tgrads[key]
        assert got.shape == ref.shape, (what, key)
        scale = max(float(np.linalg.norm(ref)), 0.1 * top)
        err = float(np.linalg.norm(got - ref))
        assert err <= ulps * ULP * scale, \
            f'{what} d/d{key}: |dg| {err} > {ulps} x {ULP * scale} ({err / ULP / scale:.2f})'


# Observed (roundings, in norm): at most 3.7 but in CoarseReg with the MI
# outputs (11.5), FineReg with the MI outputs (5.6) and MLPHead (5.2, a
# bias ahead of train BatchNorm: round-off alone).  In f32 the same modules
# agree to 2e-6, so these are single roundings (a bf16 cotangent into a
# bf16 Dense's backward, flipped by an f32 sum in another order) that train
# BatchNorm's backward, a difference of nearly equal terms, magnifies where
# the batch variance is small.  A zeroed, detached or halved gradient is
# 256 or 128 roundings off.
LAYER_GRAD_ULPS = {'coarse_reg_mi': 16, 'fine_reg_mi': 8, 'mlp_head': 8}


@pytest.mark.parametrize('name', sorted(_layer_cases()))
def test_layers_backward(name):
    """The backward of each layer of `models/layers.py` and model_v5's
    detector in bf16 train mode, from the same random flax variables and
    one random cotangent of every output: `jax.vjp` of the flax module and
    the port's autograd give every parameter's gradient (f32) and every
    float input's within `LAYER_GRAD_ULPS` bf16 roundings (6 where not
    listed) at its scale, as `_compare_grads` measures them."""
    jmk, tmk, args, _ = _layer_cases()[name]
    jm = jmk()
    v = _variables(jm, *args)
    tm = _port(tmk(), v, True)
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    jg, tg = _vjp_both(jm, v, args, tm, targs, {'train': True}, seed=50)
    _compare_grads(jg, tg, LAYER_GRAD_ULPS.get(name, 6), name)


# Observed (roundings, in norm): at most 2.9 but where a bias's gradient
# sums many rows: the JAX package takes the gradient of a bias added in bf16
# as a reduction in bf16 (XLA's reduce of the bf16 cotangent), the port in
# f32, rounded once; the KnnCPE's two biases sum B*N*k rows (9.7 alone,
# 14.9 in a block, 12.1 in the encoder).  The attention's backward carries
# the stated difference of p and q*scale (the JAX model differentiates its
# dense path, which rounds both): 1.7.
PTV3_GRAD_ULPS = {'depthwise_conv': 4, 'knn_cpe': 16, 'mlp': 4, 'patch_attention': 4,
                  'block_knn': 24, 'block_curve': 6, 'encoder': 20}


@pytest.mark.parametrize('name', sorted(_ptv3_cases()))
def test_ptv3_backward(name):
    """The backward of each module of `models/ptv3.py` as the train step
    runs it (f32 activations in, LayerNorm and the stem BatchNorm in f32,
    the Dense layers, conv and attention in bf16), from the same random
    flax variables and one random cotangent: every parameter's and the
    activation's gradient within `PTV3_GRAD_ULPS[name]` bf16 roundings at
    its scale."""
    jmk, tmk, args, targs, act, takes_train = _ptv3_cases()[name]
    jm = jmk()
    v = _variables(jm, *args)
    tm = _port(tmk(), v, True)
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in targs]
    kw = {'train': True} if takes_train else {}
    jg, tg = _vjp_both(jm, v, list(args), tm, targs, kw, seed=51)
    _compare_grads(jg, tg, PTV3_GRAD_ULPS[name], name)


# --- the plain K3 and K3b in bf16 against the Pallas kernel ---------------

ATTN_SHAPES = [(2, 2, 256, 32), (2, 4, 128, 32), (2, 8, 64, 32), (2, 8, 256, 8),
               (2, 3, 100, 5)]
ATTN_ULPS = 1


@pytest.mark.parametrize('shape', ATTN_SHAPES)
def test_plain_attention_and_backward_match_pallas(shape):
    """`patch_attention_reference` and `patch_attention_backward_reference`
    on bf16 q, k, v, g against the Pallas `patch_attention` (interpret mode)
    and `jax.vjp` of it, its `_bwd`: both compute in f32 and cast once to
    bf16, so every output is bf16 and within `ATTN_ULPS` rounding at its
    scale (f32 sums in other orders can move a value across a rounding)."""
    q, k, v, g = (np.asarray(jnp.asarray(x, JBF)) for x in _qkvg(11, shape))
    scale = shape[-1] ** -0.5
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda a, b, c: jattn.patch_attention(a, b, c, scale),
                           *(jnp.asarray(x, JBF) for x in (q, k, v)))
        grads = vjp(jnp.asarray(g, JBF))
    tq, tk, tv, tg = (torch.from_numpy(np.asarray(x, np.float32)).to(BF) for x in (q, k, v, g))
    _compare(out, kattn.patch_attention_reference(tq, tk, tv, scale), ATTN_ULPS, 'forward')
    _compare(grads, kattn.patch_attention_backward_reference(tq, tk, tv, tg, scale),
             ATTN_ULPS, 'backward')


def test_attention_function_in_bf16_on_the_cpu():
    """`PatchAttentionFunction` on a bf16 projection: bf16 output and
    gradient (the plain versions on the CPU), the saved log-sum-exp f32,
    and the gradient that of the plain forward by autograd to one bf16
    rounding of p (the plain backward is JAX's `_bwd`, f32 inside)."""
    R, K, H, d = 2, 32, 2, 16
    qkv = torch.from_numpy(_rand(30, (R, K, 3, H, d)) * 2).to(BF).requires_grad_()
    out = kattn.PatchAttentionFunction.apply(qkv, d ** -0.5)
    assert out.dtype == BF and out.grad_fn is not None
    saved = out.grad_fn.saved_tensors
    assert saved[2].dtype == torch.float32 and saved[2].shape == (R, H, K)
    gg = torch.from_numpy(_rand(31, (R, K, H, d))).to(BF)
    out.backward(gg)
    assert qkv.grad.dtype == BF
    q2 = qkv.detach().float().requires_grad_()
    ref = kattn.patch_attention_reference(*kattn.unpack_qkv(q2), d ** -0.5).transpose(1, 2)
    ref.backward(gg.float())
    err = float((qkv.grad.float() - q2.grad).abs().max() / q2.grad.abs().max())
    assert err <= 2 * ULP, err


# --- descriptor-space kNN: exact ties --------------------------------------

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('n', [256, 3000])
def test_knn_takes_ties_in_jax_order(dtype, n):
    """Rows full of exact distance ties (duplicated database points, and
    bf16 descriptors on a coarse grid): the port selects and orders the k
    neighbours exactly as the JAX package's exact `knn` (one `top_k`
    below 2048 columns, chunked two-stage above), the lower index first
    among equals."""
    rng = np.random.default_rng(40)
    base = rng.integers(-3, 4, (2, n // 4, 8)).astype(np.float32)
    db = np.concatenate([base] * 4, axis=1)[:, rng.permutation(n)]
    query = rng.integers(-3, 4, (2, 64, 8)).astype(np.float32)
    jd = getattr(jnp, dtype)
    _, jidx = jneighbors.knn(jnp.asarray(query, jd), jnp.asarray(db, jd), 16, approx=False)
    td = getattr(torch, dtype)
    dist, idx = neighbors.knn(torch.from_numpy(query).to(td), torch.from_numpy(db).to(td), 16)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert dist.dtype == td
    assert bool((dist[..., 1:] >= dist[..., :-1]).all())


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16', 'float64'])
@pytest.mark.parametrize('k', [1, 8, 16])
def test_knn_selects_by_distance_then_index(dtype, k):
    """`knn` against a stable sort of each distance row (by distance, then
    index) on a batch that mixes rows without ties (continuous
    coordinates), rows tied inside the selection and rows tied across its
    k-th place (selected again by the int64 key), and with k equal to the
    row's length."""
    rng = np.random.default_rng(41)
    td = getattr(torch, dtype)
    grid = rng.integers(-2, 3, (1, 300, 4)).astype(np.float64)
    smooth = rng.standard_normal((1, 300, 4))
    db = torch.from_numpy(np.concatenate([grid, smooth])).to(td)
    query = torch.from_numpy(np.concatenate([grid[:, :40], smooth[:, :40] + 0.1])).to(td)
    for database in (db, db[:, :k]):
        dist, idx = neighbors.knn(query, database, k)
        d2 = neighbors.pairwise_sqdist(query, database)
        want = torch.sort(d2.double(), dim=-1, stable=True).indices[..., :k]
        assert torch.equal(idx, want)
        assert torch.equal(dist, torch.gather(d2, -1, want))


# --- the whole model_v6 bf16 forward ---------------------------------------

@pytest.fixture(scope='module')
def forward_bf16():
    """The model_v6 forward at small levels in bf16, both packages from the
    same random flax variables, with the port's WFPS weights and attention
    inputs recorded."""
    src, dst = _pair(1, 2, 256)
    jm = jbuild('model_v6', levels=J_LEVELS, compute_dtype='bfloat16', **SMALL)
    v = _variables(jm, src, dst, seed=1, train=False)
    jout = jax.jit(lambda v, a, b: jm.apply(v, a, b, train=False))(v, src, dst)
    tm = zoo.build('model_v6', device='cpu', levels=LEVELS, compute_dtype='bfloat16', **SMALL)
    tm.load_state_dict(from_flax(v), strict=True)
    seen = {'wfps': [], 'qkv': []}
    real_wfps = sampling.weighted_fps

    def wfps(xyz, weights, m):
        seen['wfps'].append((xyz.dtype, weights.dtype))
        return real_wfps(xyz, weights, m)
    tm.feature_extraction.ptv3_1.PTv3Block_0.PatchAttention_0.Dense_0.register_forward_hook(
        lambda mod, a, out: seen['qkv'].append(out.dtype))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, 'weighted_fps', wfps)
        with torch.no_grad():
            tout = tm(torch.from_numpy(src), torch.from_numpy(dst))
    return jout, tout, seen


def test_forward_pyramid_matches_jax(forward_bf16):
    """All three levels of both towers: keypoints within 1e-3 m (observed
    ~1e-5: bf16 attention weights that round alike), sigmas within 1e-4
    relative, descriptors (bf16) within `FORWARD_DESC_ULPS` roundings at
    their scale (the stated attention difference through the PTv3 stack;
    observed 2.3)."""
    jout, tout, _ = forward_bf16
    for side in ('src_feats', 'dst_feats'):
        for lvl in (1, 2, 3):
            j, t = jout[side], tout[side]
            np.testing.assert_allclose(_f32(t[f'xyz_{lvl}']), _f32(j[f'xyz_{lvl}']), atol=1e-3,
                                       rtol=0, err_msg=f'{side} xyz_{lvl}')
            np.testing.assert_allclose(_f32(t[f'sigmas_{lvl}']), _f32(j[f'sigmas_{lvl}']),
                                       rtol=1e-4, atol=1e-6, err_msg=f'{side} sigmas_{lvl}')
            _compare(j[f'desc_{lvl}'], t[f'desc_{lvl}'], FORWARD_DESC_ULPS, f'{side} desc_{lvl}')


FORWARD_DESC_ULPS = 4


def test_forward_dtypes_and_geometry(forward_bf16):
    """Every output in JAX's dtype (bf16 descriptors, MI features and
    feature distances; f32 keypoints, sigmas, weights and poses); the WFPS
    inputs (K2's xyz and weights) f32; the attention's projection bf16, so
    K3 runs in bf16; the poses finite rotations."""
    jout, tout, seen = forward_bf16
    assert set(tout) == set(jout)
    for key in jout:
        for a, b in zip(jax.tree.leaves(jout[key]), jax.tree.leaves(tout[key])):
            assert _dtype_name(a) == _dtype_name(b), key
    assert tout['src_feats']['desc_1'].dtype == BF
    assert tout['src_feats']['sigmas_1'].dtype == torch.float32
    assert seen['wfps'] and all(x == (torch.float32, torch.float32) for x in seen['wfps'])
    assert seen['qkv'] and all(x == BF for x in seen['qkv'])
    for R, t in zip(tout['rotation'], tout['translation']):
        assert R.dtype == t.dtype == torch.float32
        assert bool(torch.isfinite(R).all() and torch.isfinite(t).all())
        np.testing.assert_allclose((R @ R.transpose(1, 2)).numpy(), np.eye(3)[None].repeat(2, 0),
                                   atol=1e-5)


# --- one reg_v11 bf16 train step, both packages -----------------------------

def _bf16(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              compute_dtype='bfloat16'))


def _step_batch():
    """Two target clouds in an anisotropic box (80 x 40 x 10 m: the
    cross-covariance that Kabsch takes has well-separated singular values,
    so its backward does not magnify rounding as an isotropic cloud's
    does) and their decalibrated, noisy sources."""
    rng = np.random.default_rng(17)
    dst = (rng.uniform(-1, 1, (2, 256, 3)) * [40, 20, 5]).astype(np.float32)
    tw = np.concatenate([rng.uniform(-0.05, 0.05, (2, 3)),
                         rng.uniform(-0.3, 0.3, (2, 3))], 1).astype(np.float32)
    igt = se3.exp(torch.from_numpy(tw)).numpy()
    src = (np.einsum('bij,bnj->bni', igt[:, :3, :3], dst) + igt[:, None, :3, 3]
           + rng.normal(0, 0.01, dst.shape)).astype(np.float32)
    return {'uncalibed_pcd': src, 'pcd_left': dst, 'igt': igt}


@pytest.fixture(scope='module')
def train_step_bf16():
    """One reg_v11 train step at small levels (one PTv3 block a level) in
    bf16 from the same random
    flax variables (sigma heads zeroed: constant sigmas, WFPS weights of
    exactly 1): JAX's `jax.grad` of its objective in train mode, and the
    port's `loop.make_train_step` on the batch and on the batch with every
    coordinate moved by one f32 ulp either way (the port's own last-bit
    spread)."""
    from pcd_reg_hregnet_tpu.train.objective import RegistrationObjective as JObjective
    # one PTv3 block per level (the depth of `--debug-scale`): one compile
    jcfg, cfg = (_bf16(dataclasses.replace(c, model=dataclasses.replace(
        c.model, ptv3_depths=(1,), ptv3_num_heads=(2,)))) for c in _configs())
    batch = _step_batch()
    jobj = JObjective(jcfg)
    variables = _variables(jobj, batch, seed=3, train=False)
    for i in (1, 2, 3):
        head = variables['params']['model']['feature_extraction'][f'detector_{i}']['MLPHead_0']
        head['Dense_2']['kernel'] = np.zeros_like(head['Dense_2']['kernel'])

    @jax.jit
    def jgrad(params, batch_stats, batch):
        def loss_fn(p):
            (loss, metrics, ret), _ = jobj.apply({'params': p, 'batch_stats': batch_stats},
                                                 batch, train=True, mutable=['batch_stats'])
            return loss, (metrics, _keypoints(ret))
        return jax.grad(loss_fn, has_aux=True)(params)

    grads, (metrics, kps) = jgrad(variables['params'], variables['batch_stats'], batch)
    init = from_flax(variables)
    nudged = [{k: np.nextafter(v, d).astype(np.float32) if k != 'igt' else v
               for k, v in batch.items()} for d in (np.inf, -np.inf)]
    return dict(jax=(from_flax({'params': jax.tree.map(np.asarray, grads)}),
                     jax.tree.map(float, metrics), jax.tree.map(np.asarray, kps)),
                port=[_port_bf16_step(cfg, init, b) for b in [batch] + nudged])


def _port_bf16_step(cfg, init, batch):
    """The port's train step from the state `init`: (gradients by name,
    metrics, keypoints, the objective)."""
    from pcd_reg_hregnet_torch.train.objective import RegistrationObjective
    from pcd_reg_hregnet_torch.train.optimizer import Optimizer
    obj = RegistrationObjective(cfg)
    obj.load_state_dict(init, strict=True)
    state = loop.TrainState(obj, Optimizer(cfg.train, obj.named_parameters(), 100))
    kps = {}
    obj.model.register_forward_hook(lambda m, a, ret: kps.update(
        {k: v.detach().numpy().copy() for k, v in _keypoints(ret).items()}))
    metrics = loop.make_train_step()(state, {k: torch.from_numpy(batch[k]) for k in loop.USED})
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for n, p in obj.named_parameters()}
    return grads, {k: float(v) for k, v in metrics.items()}, kps, obj


def _flat(grads, names):
    return torch.cat([grads[n].double().flatten() for n in names])


def _step_gradient_ok(got, want):
    """Whether a whole-step gradient `got` holds to `want` (both by name)
    within the bounds of `test_train_step_against_jax`: the global norm
    ratio within `STEP_NORM_RATIO` of 1 and the cosine at least
    `STEP_COSINE`; every module (the third level of names) that carries at
    least 1% of the norm within `MODULE_NORM_RATIO` of 1."""
    names = sorted(want)
    g, w = _flat(got, names), _flat(want, names)
    if not (float(g.norm()) > 0 and float(w.norm()) > 0):
        return False
    ratio, cos = float(g.norm() / w.norm()), float(g @ w / (g.norm() * w.norm()))
    if not (1 / STEP_NORM_RATIO <= ratio <= STEP_NORM_RATIO and cos >= STEP_COSINE):
        return False
    modules = {}
    for n in names:
        modules.setdefault('.'.join(n.split('.')[:3]), []).append(n)
    for group in modules.values():
        gm, wm = _flat(got, group), _flat(want, group)
        if float(wm.norm()) >= 0.01 * float(w.norm()):
            r = float(gm.norm() / wm.norm())
            if not 1 / MODULE_NORM_RATIO <= r <= MODULE_NORM_RATIO:
                return False
    return True


SPREAD = 4
# A bf16 step at random weights is chaotic (see below), so the whole
# gradient is held by what chaos leaves alone: its norm and its rough
# direction.  Observed against JAX: norm ratio 0.977, cosine 0.86, module
# ratios 0.75-1.07; the port against itself one f32 ulp away on this and two
# other batches: ratios 0.69-1.0, cosines 0.40-1.0, module ratios
# 0.52-1.39.  A zeroed, halved, doubled or random gradient fails, and so
# does a module whose gradient is lost (`test_step_gradient_bound_has_power`).
STEP_NORM_RATIO, STEP_COSINE, MODULE_NORM_RATIO = 1 / 0.6, 0.2, 1 / 0.3


def test_train_step_against_jax(train_step_bf16):
    """The loss and the whole gradient of JAX's bf16 step and the port's.

    A bf16 train step at random weights is chaotic: BatchNorm and LayerNorm
    run in f32 in train mode, and an f32 sum taken in another order (XLA's
    reduction orders are not the port's), or one rounding of p in the
    attention (the stated difference), moves a value across a bf16
    rounding at the next Dense's input, and the pyramid, the
    correspondences and Kabsch (at random weights, poses ~90-180 degrees
    off) carry it to the poses.  The port alone, given inputs one f32 ulp
    away, moves its loss by up to 3.7% and its gradient by ~50-100% of its
    norm in distance.  So the loss and each loss term are held within 2%
    of JAX's or the port's own last-bit spread of them, the larger
    (observed: loss 1.0%, loss_t 1.8%), and the gradient by
    `_step_gradient_ok`, whose bounds a zeroed, halved, doubled or random
    gradient fails.  The per-layer backward tests hold each layer's
    gradient to a few bf16 roundings."""
    (jg, jm, _), runs = train_step_bf16['jax'], train_step_bf16['port']
    (tg, tm, _, obj), nudged = runs[0], runs[1:]
    assert set(tg) == set(jg)
    for key in ('loss', 'loss_R', 'loss_t', 'tf_loss'):
        spread = max(abs(r[1][key] - tm[key]) for r in nudged)
        assert abs(tm[key] - jm[key]) <= max(0.02 * abs(jm[key]), spread), key
    assert _step_gradient_ok(tg, jg)
    for key in jm:
        assert math.isfinite(tm[key]), key
    assert math.isfinite(tm['grad_norm']) and tm['grad_norm'] > 0


@pytest.mark.parametrize('broken', ['zeroed', 'halved', 'doubled', 'random', 'module_lost'])
def test_step_gradient_bound_has_power(train_step_bf16, broken):
    """`_step_gradient_ok` refuses the port's step gradient broken in each
    way against JAX's (which the unbroken one passes): zeroed, halved,
    doubled, replaced by a random gradient of the same norm, or with the
    largest module's gradient lost (detached)."""
    jg, tg = train_step_bf16['jax'][0], train_step_bf16['port'][0][0]
    assert _step_gradient_ok(tg, jg)
    gen = torch.Generator().manual_seed(5)
    if broken == 'random':
        noise = {n: torch.randn(g.shape, generator=gen) for n, g in tg.items()}
        scale = float(_flat(tg, sorted(tg)).norm() / _flat(noise, sorted(tg)).norm())
        bad = {n: g * scale for n, g in noise.items()}
    elif broken == 'module_lost':
        top = max(tg, key=lambda n: float(tg[n].norm()))
        prefix = '.'.join(top.split('.')[:3]) + '.'
        bad = {n: torch.zeros_like(g) if n.startswith(prefix) else g for n, g in tg.items()}
    else:
        factor = {'zeroed': 0.0, 'halved': 0.5, 'doubled': 2.0}[broken]
        bad = {n: g * factor for n, g in tg.items()}
    assert not _step_gradient_ok(bad, jg)


def test_train_step_keypoints_and_dtypes(train_step_bf16):
    """Keypoints of every level within 1e-3 m plus `SPREAD` times the port's
    own last-bit spread of them (observed at most 2.0 times, at level 3,
    whose detector reads level 2's features: train BatchNorm's flips
    add up over the levels); gradients land on f32 parameters (every
    parameter and every gradient f32), and the BatchNorm statistics stay
    f32."""
    jk, runs = train_step_bf16['jax'][2], train_step_bf16['port']
    (tg, _, tk, obj), nudged = runs[0], runs[1:]
    for key in jk:
        spread = max(float(np.abs(r[2][key] - tk[key]).max()) for r in nudged)
        assert float(np.abs(tk[key] - jk[key]).max()) <= 1e-3 + SPREAD * spread, key
    assert all(p.dtype == torch.float32 for p in obj.parameters())
    assert all(g.dtype == torch.float32 for g in tg.values())
    assert all(b.dtype == torch.float32 for b in obj.buffers())


# --- every other preset: builds and takes a finite bf16 step --------------

@pytest.mark.parametrize('name', sorted(set(experiments.available()) - {'reg_v11'}))
def test_every_experiment_takes_a_bf16_step(name):
    """Every experiment of the table builds in bf16 at small levels and
    takes one finite train step with exactly its loss terms; parameters,
    gradients and the optimizer's moments stay f32, and the eval step
    (bf16 BatchNorm) is finite too."""
    cfg = experiments.experiment(name)
    cfg = _bf16(dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, levels=LEVELS,
                                                                   **SMALL)))
    state = loop.create_state(cfg, 3, device='cpu')
    batch = loop.to_device(_batches()[0], torch.device('cpu'))
    m = loop.make_train_step()(state, batch)
    terms = {'chamfer_loss': cfg.loss.chamfer, 'mi_loss': cfg.loss.mi,
             'circle_loss': cfg.loss.circle}
    assert {t for t, on in terms.items() if on} == set(m) & set(terms)
    assert all(math.isfinite(float(v)) for v in m.values()), m
    params = list(state.objective.parameters())
    assert all(p.dtype == torch.float32 for p in params)
    assert any(p.grad is not None for p in params)
    assert all(p.grad.dtype == torch.float32 for p in params if p.grad is not None)
    assert all(v.dtype == torch.float32 for st in state.optimizer.state.values()
               for v in st.values() if torch.is_tensor(v) and v.is_floating_point())
    metrics, (R, t) = loop.make_eval_step()(state, batch)
    assert all(math.isfinite(float(v)) for v in metrics.values()), metrics
    assert R.dtype == t.dtype == torch.float32
    with torch.no_grad():
        ret = state.objective.model(batch['uncalibed_pcd'], batch['pcd_left'])
    desc = ret['src_feats'].get('desc_1', ret['src_feats'].get('feat_1'))
    # model_v5's detector features are its f32 attended values, as in JAX
    assert desc.dtype == (torch.float32 if cfg.model.backbone == 'attention' else BF)


# --- the command line and the checkpoints -----------------------------------

@pytest.mark.parametrize('argv', [
    ['--compute-dtype', 'bfloat16'],
    ['--compute-dtype', 'bfloat16', '--debug-scale'],
    ['--experiment', 'reg_v0', '--compute-dtype', 'bfloat16', '--debug-scale'],
    ['--experiment', 'reg_v10', '--compute-dtype', 'float32', '--debug-scale',
     '--batch-size', '4', '--npoints', '512'],
], ids=['reg_v11', 'reg_v11_debug', 'reg_v0_debug', 'reg_v10_f32'])
def test_cli_config_matches_jax(argv):
    """`--compute-dtype` (and `--debug-scale`, which shrinks the PTv3 stack
    only for the ptv3 backbone) gives the JAX CLI's `train` config: model,
    data and train fields equal."""
    from pcd_reg_hregnet_torch.core.config import Config
    jp = argparse.ArgumentParser()
    jcli._common(jp)
    jcfg = jcli._build_config(jp.parse_args(argv))
    tp = argparse.ArgumentParser()
    experiments.add_config_args(tp)
    cfg = experiments.config_from_args(tp.parse_args(argv))
    assert cfg == Config.from_json(jcfg.to_json())


def test_checkpoint_round_trip_in_bf16(tmp_path):
    """A bf16 train checkpoint records its compute dtype, reloads into a
    bf16 objective built from its own config, and the next step is the same
    from both; its weights serve in f32 too (`zoo.build` with the
    override), with the same state_dict keys."""
    cfg = _bf16(_configs()[1])
    state = loop.create_state(cfg, 3, device='cpu')
    step = loop.make_train_step()
    batch = loop.to_device(_batches()[0], torch.device('cpu'))
    step(state, batch)
    checkpoint.save_train(tmp_path / 'ck', state, cfg)
    saved = checkpoint.load_config(tmp_path / 'ck')
    assert saved.model.compute_dtype == 'bfloat16'
    other = loop.create_state(saved, 3, device='cpu', seed=99)
    checkpoint.restore_train(tmp_path / 'ck', other)
    assert float(step(state, batch)['loss']) == float(step(other, batch)['loss'])
    f32 = zoo.build('model_v6', device='cpu', weights=tmp_path / 'ck', compute_dtype='float32')
    assert f32.cfg.compute_dtype == 'float32'
    assert set(f32.state_dict()) == set(state.objective.model.state_dict())


@pytest.mark.parametrize('stage', ['detector', 'descriptor'])
def test_feats_objective_in_bf16(stage):
    """The feats pretrain objective shares the feature extraction, so it
    runs bf16 too: one finite train step of each stage at small levels (f32
    parameters and gradients), and at eval bf16 descriptors with f32
    keypoints and sigmas into finite losses."""
    from pcd_reg_hregnet_torch.train import feats
    cfg = _bf16(dataclasses.replace(_configs()[1], model=dataclasses.replace(
        _configs()[1].model, levels=LEVELS, **SMALL)))
    cfg = feats.recipe(cfg, stage)
    state = feats.create_feats_state(cfg, 3, stage=stage, device='cpu')
    batch = loop.to_device(_batches()[0], torch.device('cpu'))
    m = loop.make_train_step()(state, batch)
    assert all(math.isfinite(float(v)) for v in m.values()), m
    assert all(p.grad is None or p.grad.dtype == torch.float32
               for p in state.objective.parameters())
    state.objective.eval()
    with torch.no_grad():
        loss, metrics, (rs, _) = state.objective(batch)
    assert math.isfinite(float(loss))
    assert rs['desc_1'].dtype == BF and rs['xyz_1'].dtype == rs['sigmas_1'].dtype == torch.float32


def test_flagship_starts_a_bf16_run():
    """`create_state(init=)` takes the f32-trained flagship into a bf16
    `reg_v11` objective (the compute dtype leaves the parameters as they
    are), strictly, and refuses a checkpoint of another architecture."""
    cfg = _bf16(experiments.experiment('reg_v11'))
    state = loop.create_state(cfg, 256, device='cpu', init=checkpoint.FLAGSHIP)
    assert state.objective.model.cfg.compute_dtype == 'bfloat16'
    want = checkpoint.load(checkpoint.FLAGSHIP)[1]
    got = state.objective.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    other = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, ptv3_cpe='curve'))
    with pytest.raises(ValueError, match='another model configuration'):
        loop.create_state(other, 256, device='cpu', init=checkpoint.FLAGSHIP)
