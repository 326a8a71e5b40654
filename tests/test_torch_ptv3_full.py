"""The full PointTransformerV3 of the port against the JAX package (CPU).

Hilbert keys and their decoding, the four serialization orders, the
serialized pooling and unpooling, and the encoder-decoder at a small size
(3 stages, patch 16, 2 x 128 points) for each CPE: the JAX module's
variables (random, batch statistics included) go through
`utils.convert.from_flax` into the port's module (strict `load_state_dict`)
and both run the same numpy inputs: the eval forward, the train-mode
forward with its updated batch statistics, and the gradient of
mean(out ** 2).  The port's attention runs K3/K3b's plain versions here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcd_reg_hregnet_tpu.models import ptv3 as jptv3
from pcd_reg_hregnet_tpu.ops import hilbert as jhilbert
from pcd_reg_hregnet_tpu.ops import serialization as jserialization
from pcd_reg_hregnet_torch.models import ptv3, zoo
from pcd_reg_hregnet_torch.ops import hilbert, serialization
from pcd_reg_hregnet_torch.utils.convert import from_flax

torch.set_num_threads(1)

SMALL = dict(enc_channels=(16, 32, 64), enc_depths=(1, 1, 1), enc_heads=(2, 4, 4),
             dec_channels=(16, 32), dec_depths=(1, 1), dec_heads=(2, 4), patch_size=16,
             grid_size=0.05)
FWD_TOL = 1e-4        # of the output's largest value
GRAD_TOL = 1e-3       # of each gradient leaf's largest value
# A bias ahead of a train-mode BatchNorm has a gradient of exactly zero
# (the batch mean removes it); both packages give f32 round-off there,
# below this share of the largest gradient anywhere, and such a leaf is
# held to stay below it in the port too.
ZERO_GRAD = 1e-5


def _rand(seed, shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _variables(jmod, *args, seed=0, **kw):
    """Random flax variables of `jmod`'s shapes: kernels N(0, 1/fan_in),
    biases N(0, 0.1), scales U(0.5, 1.5), batch statistics random."""
    shapes = jax.eval_shape(lambda *a: jmod.init(jax.random.PRNGKey(0), *a, **kw), *args)
    rng = np.random.default_rng(seed + 100)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == 'kernel':
            a = rng.normal(0, 1, shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ('bias', 'mean'):
            a = rng.normal(0, 0.1, shape)
        else:
            a = rng.uniform(0.5, 1.5, shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _np_hilbert(locs, nb):
    """Skilling's transform on boolean bit planes, in numpy (the reference
    of the JAX package's own test)."""
    n = locs.shape[0]
    gray = ((locs[..., None] >> np.arange(nb - 1, -1, -1)) & 1).astype(bool)
    for bit in range(nb):
        for dim in range(3):
            mask = gray[:, dim, bit]
            gray[mask, 0, bit + 1:] ^= True
            to_flip = (~mask[:, None]) & (gray[:, 0, bit + 1:] ^ gray[:, dim, bit + 1:])
            gray[:, dim, bit + 1:] ^= to_flip
            gray[:, 0, bit + 1:] ^= to_flip
    flat = np.swapaxes(gray, 1, 2).reshape(n, 3 * nb)
    for i in range(1, 3 * nb):
        flat[:, i] = flat[:, i] ^ flat[:, i - 1]
    vals = np.zeros(n, dtype=np.uint64)
    for i in range(3 * nb):
        vals = (vals << np.uint64(1)) | flat[:, i].astype(np.uint64)
    return vals


class TestHilbert:
    @pytest.mark.parametrize('nb', [1, 2, 5, 10, 16])
    def test_keys_against_jax_and_numpy_skilling(self, nb):
        g = np.random.default_rng(nb).integers(0, 1 << nb, (500, 3)).astype(np.int64)
        g[:2] = [[0, 0, 0], [(1 << nb) - 1] * 3]
        hi, lo = hilbert.hilbert_keys(torch.from_numpy(g), nb)
        jhi, jlo = jhilbert.hilbert_keys(jnp.asarray(g.astype(np.int32)), nb)
        np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
        want = _np_hilbert(g, nb)
        np.testing.assert_array_equal(hilbert.hilbert_index(torch.from_numpy(g), nb).numpy(),
                                      want.astype(np.int64))

    @pytest.mark.parametrize('nb', [3, 16])
    def test_decode_round_trip(self, nb):
        g = np.random.default_rng(20 + nb).integers(0, 1 << nb, (2, 300, 3)).astype(np.int32)
        hi, lo = hilbert.hilbert_keys(torch.from_numpy(g), nb)
        back = hilbert.hilbert_decode(hi, lo, nb)
        assert back.dtype == torch.int32
        np.testing.assert_array_equal(back.numpy(), g)
        np.testing.assert_array_equal(back.numpy(), np.asarray(jhilbert.hilbert_decode(
            jnp.asarray(hi.numpy().astype(np.uint32)), jnp.asarray(lo.numpy().astype(np.uint32)),
            nb)))
        # consecutive indices are neighbouring cells
        cells = torch.stack(torch.meshgrid(*[torch.arange(8)] * 3, indexing='ij'),
                            -1).reshape(-1, 3)
        cells = cells[torch.argsort(hilbert.hilbert_index(cells, 3))]
        assert bool(((cells[1:] - cells[:-1]).abs().sum(-1) == 1).all())


class TestSerialize:
    @pytest.mark.parametrize('order', serialization.ORDERS)
    @pytest.mark.parametrize('grid', [0.01, 0.5])
    def test_permutation_against_jax(self, order, grid):
        # clouds with duplicates (equal keys keep their input order) and a
        # 2 km extent, which the Hilbert order clips to 16 bits at 1 cm
        xyz = _rand(30, (3, 512, 3), -20, 20)
        xyz[0, 100:150] = xyz[0, 0]
        xyz[2, :8] = [[1000, 0, 0], [-1000, 5, 5], [0, 1000, 0], [0, 0, -1000]] * 2
        o, inv = serialization.serialize(torch.from_numpy(xyz), grid, order)
        jo, jinv = jserialization.serialize(jnp.asarray(xyz), grid, order)
        np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))

    def test_refuses_unknown_order(self):
        with pytest.raises(ValueError, match='order'):
            serialization.serialize(torch.zeros(1, 4, 3), 0.01, 'peano')


def _port(tmod, variables, train=False):
    tmod.load_state_dict(from_flax(variables), strict=True)
    return tmod.train(train)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (err, np.abs(want).max())


class TestPooling:
    @pytest.mark.parametrize('train', [False, True])
    def test_pooling_and_unpooling(self, train):
        xyz, x = _rand(40, (2, 64, 3), -10, 10), _rand(41, (2, 64, 16))
        jm = jptv3.SerializedPooling(32)
        v = _variables(jm, xyz, x, train=False)
        tm = _port(ptv3.SerializedPooling(16, 32), v, train)
        out, upd = jm.apply(v, xyz, x, train, mutable=['batch_stats'])
        txyz, tx = tm(torch.from_numpy(xyz), torch.from_numpy(x))
        _close(txyz.detach(), out[0], 1e-6)
        _close(tx.detach(), out[1], 1e-5)
        skip = _rand(42, (2, 64, 8))
        ju = jptv3.SerializedUnpooling(24)
        vu = _variables(ju, x[:, :32], skip, seed=1, train=False)
        tu = _port(ptv3.SerializedUnpooling(16, 8, 24), vu, train)
        uout, uupd = ju.apply(vu, x[:, :32], skip, train, mutable=['batch_stats'])
        _close(tu(torch.from_numpy(x[:, :32]), torch.from_numpy(skip)).detach(), uout, 1e-5)
        for tmod, new in ((tm, upd), (tu, uupd)):
            want = from_flax({'batch_stats': new['batch_stats']})
            got = tmod.state_dict()
            for k, a in want.items():
                _close(got[k], a, 1e-5)


def _grads_by_key(jgrads):
    return from_flax({'params': jgrads})


@pytest.fixture(scope='module', params=['curve', 'knn', 'none'])
def full(request):
    """The JAX module at `SMALL` for one CPE, its random variables, and its
    eval output, train output, updated batch statistics and the gradient
    of mean(out ** 2) in train mode (each computed once per CPE)."""
    cpe = request.param
    xyz, feat = _rand(50, (2, 128, 3), -10, 10), _rand(51, (2, 128, 8))
    jm = jptv3.PointTransformerV3(**SMALL, cpe=cpe)
    v = _variables(jm, xyz, feat, train=False)
    eval_out = np.asarray(jax.jit(lambda v: jm.apply(v, xyz, feat, False))(v))

    def loss(params):
        out, upd = jm.apply({'params': params, 'batch_stats': v['batch_stats']}, xyz, feat,
                            True, mutable=['batch_stats'])
        return jnp.mean(out ** 2), (out, upd)

    (_, (train_out, upd)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v['params'])
    return dict(cpe=cpe, xyz=xyz, feat=feat, v=v, eval_out=eval_out,
                train_out=np.asarray(train_out), stats=upd['batch_stats'], grads=grads)


class TestPointTransformerV3:
    def _model(self, full, train):
        return _port(ptv3.PointTransformerV3(8, **SMALL, cpe=full['cpe']), full['v'], train)

    def test_flax_names(self, full):
        # every variable of the JAX module has its entry in the port, and
        # no other (`load_state_dict(strict=True)` above), 9 blocks named
        # through encoder and decoder
        names = set(self._model(full, False).state_dict())
        assert {k.split('.')[0] for k in names} == (
            {'SerializedDepthwiseConv_0', 'Dense_0', 'BatchNorm_0', 'SerializedPooling_0',
             'SerializedPooling_1', 'SerializedUnpooling_0', 'SerializedUnpooling_1'}
            | {f'PTv3Block_{i}' for i in range(5)})

    def test_eval_forward(self, full):
        with torch.no_grad():
            out = self._model(full, False)(torch.from_numpy(full['xyz']),
                                           torch.from_numpy(full['feat']))
        assert out.shape == (2, 128, 16)
        _close(out, full['eval_out'], FWD_TOL)

    def test_train_forward_stats_and_grad(self, full):
        model = self._model(full, True)
        out = model(torch.from_numpy(full['xyz']), torch.from_numpy(full['feat']))
        torch.mean(out ** 2).backward()
        _close(out.detach(), full['train_out'], FWD_TOL)
        state = model.state_dict()
        want = from_flax({'batch_stats': full['stats']})
        for k, a in want.items():
            _close(state[k], a, FWD_TOL)
        grads = _grads_by_key(full['grads'])
        params = dict(model.named_parameters())
        assert set(grads) == set(params)
        floor = ZERO_GRAD * max(float(g.abs().max()) for g in grads.values())
        zero = 0
        for k, g in grads.items():
            if float(g.abs().max()) < floor:
                assert float(params[k].grad.abs().max()) < floor, k
                zero += 1
            else:
                _close(params[k].grad, g, GRAD_TOL)
        assert zero < len(grads) // 4


class TestBuild:
    def test_build_ptv3_seeded_on_cpu(self):
        a = zoo.build_ptv3(device='cpu', seed=3, in_channels=3, **SMALL)
        b = zoo.build_ptv3(device='cpu', seed=3, in_channels=3, **SMALL)
        assert not a.training
        for (ka, pa), (kb, pb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert ka == kb and torch.equal(pa, pb)
        xyz = torch.from_numpy(_rand(60, (1, 64, 3), -5, 5))
        with torch.no_grad():
            out = a(xyz, xyz)
        assert out.shape == (1, 64, 16) and bool(torch.isfinite(out).all())
