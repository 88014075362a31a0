"""The port's tape ``Tensor`` (``pydynet_tpu_torch/core``) against the JAX
package's on the same seeded NumPy inputs: forward values and result types
of the ops, promotion over dtype pairs, indexing, the data proxy, shared
buffers, and the factories. The cases of ``test_tensor_basic.py`` and
``test_ops_extended.py``.

Tolerances: float64 within 1e-12, float32 within 1e-6 (float16 within one
of its ulps, 1e-3), integers and bools exact."""
import random
from itertools import product

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydynet_tpu as jpdn
import pydynet_tpu_torch as pdt
from pydynet_tpu_torch.core import tensor as ttensor

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

TOL = {np.dtype(np.float64): 1e-12, np.dtype(np.float32): 1e-6,
       np.dtype(np.float16): 1e-3}
FLOATS = [np.float16, np.float32, np.float64]
# every type NumPy and both packages hold (bfloat16 has no NumPy type: it is
# held to JAX through result_type alone)
DTYPES = [np.bool_, np.uint8, np.uint16, np.uint32, np.uint64, np.int8,
          np.int16, np.int32, np.int64, np.float16, np.float32, np.float64]


def close(got, want):
    """``got`` (port) equals ``want`` (JAX) in type and shape, exactly for
    integers and bools, within the type's tolerance for floats."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype in TOL:
        tol = TOL[want.dtype]
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), rtol=tol,
                                   atol=tol, equal_nan=True)
    else:
        np.testing.assert_array_equal(got, want)


def both(fn, *arrays):
    """``fn(pkg, *Tensors)`` in each package; returns (port, JAX)."""
    with np.errstate(all="ignore"):
        want = fn(jpdn, *(jpdn.Tensor(a) for a in arrays))
    got = fn(pdt, *(pdt.Tensor(a) for a in arrays))
    return got, want


# ------------------------------------------------------- binary operators
def broadcastable_pair(max_dim=4, max_size=5, matmul=False):
    ndim = random.randint(0, max_dim)
    s1, s2 = [], []
    for _ in range(ndim):
        if random.random() < 0.5:
            a, b = random.choice([(1, random.randint(1, max_size)),
                                  (random.randint(1, max_size), 1)])
        else:
            a = b = random.randint(1, max_size)
        s1.append(a)
        s2.append(b)
    if matmul:
        m, n, p = (random.randint(1, max_size) for _ in range(3))
        s1 += [m, n]
        s2 += [n, p]
        s1 = s1[random.randint(0, len(s1) - 2):]
    else:
        s1 = s1[random.randint(0, len(s1)):]
    return tuple(s1), tuple(s2)


def gen_pairs(n, matmul=False, seed=42):
    random.seed(seed)
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        sh1, sh2 = broadcastable_pair(matmul=matmul)
        a = rng.standard_normal(sh1).astype(rng.choice(FLOATS))
        b = rng.standard_normal(sh2).astype(rng.choice(FLOATS))
        pairs.append((a, b))
    return pairs


BINARY = ["add", "sub", "mul", "div", "pow", "maximum", "minimum"]


@pytest.mark.parametrize("k", range(8))
@pytest.mark.parametrize("op", BINARY)
def test_binary_operator_matches_jax(op, k):
    a, b = gen_pairs(8)[k]
    got, want = both(lambda pkg, x, y: getattr(pkg, op)(x, y), a, b)
    close(got.numpy(), want.numpy())


@pytest.mark.parametrize("k", range(8))
def test_matmul_matches_jax(k):
    a, b = gen_pairs(8, matmul=True)[k]
    got, want = both(lambda pkg, x, y: pkg.matmul(x, y), a, b)
    close(got.numpy(), want.numpy())


@pytest.mark.parametrize("x", DTYPES + [torch.bfloat16],
                         ids=lambda d: str(np.dtype(d)) if d is not
                         torch.bfloat16 else "bfloat16")
def test_result_type_is_jax_lattice(x):
    """``result_type`` over every pair and against Python scalars (weakly
    typed) equals ``jnp.promote_types``/``jnp.result_type`` under x64."""
    jx = jnp.bfloat16 if x is torch.bfloat16 else x
    tx = x if x is torch.bfloat16 else ttensor.torch_dtype(x)
    for y in DTYPES + [torch.bfloat16]:
        jy = jnp.bfloat16 if y is torch.bfloat16 else y
        ty = y if y is torch.bfloat16 else ttensor.torch_dtype(y)
        want = jnp.promote_types(jx, jy)
        got = ttensor.result_type(tx, ty)
        assert str(got).split(".")[-1] == want.name, (x, y, got, want)
    for scalar in (True, 3, 2.5):
        want = jnp.result_type(jnp.zeros(1, jx), scalar)
        got = ttensor.result_type(torch.zeros(1, dtype=tx), scalar)
        assert str(got).split(".")[-1] == want.name, (x, scalar)


@pytest.mark.parametrize("x,y", list(product(DTYPES, DTYPES)),
                         ids=lambda d: np.dtype(d).name)
def test_dtype_pair_ops_match_jax(x, y):
    """add, mul and maximum between two tensors of every type pair: the
    JAX package's result type and values (PyTorch cannot compute uint16-64:
    the port goes through int64)."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 4, (2, 3)).astype(x)
    b = rng.integers(0, 4, (3,)).astype(y)
    for op in ("add", "mul", "maximum"):
        got, want = both(lambda pkg, p, q: getattr(pkg, op)(p, q), a, b)
        close(got.numpy(), want.numpy())
    if np.dtype(x) != np.bool_ and np.dtype(y) != np.bool_:
        got, want = both(lambda pkg, p, q: pkg.div(p + 1, q + 1), a, b)
        close(got.numpy(), want.numpy())


def test_scalar_operand_keeps_peer_dtype():
    for dt in (np.float32, np.int32, np.uint8, np.float16):
        x = np.arange(1, 7).reshape(2, 3).astype(dt)
        for f in (lambda t: t + 1, lambda t: 1 + t, lambda t: t * 2,
                  lambda t: 2 * t, lambda t: t / 2, lambda t: t ** 2,
                  lambda t: 2.0 ** t, lambda t: t - 1, lambda t: t * 1.5,
                  lambda t: t + np.ones(3)):
            got, want = both(lambda pkg, t: f(t), x)
            close(got.numpy(), want.numpy())


def test_host_literals_take_numpy_types():
    for v in (1.0, 3, [1, 2], [1.5, 2], True, np.float32(2.0),
              np.arange(3, dtype=np.int16)):
        assert pdt.Tensor(v).dtype == jpdn.Tensor(v).dtype
    assert pdt.Tensor(1.0, dtype=np.float32).dtype == np.float32
    assert pdt.Tensor(torch.ones(2, dtype=torch.int8)).dtype == np.int8


def test_dunder_matches_functional():
    a, b = np.random.randn(3, 4), np.random.randn(4, 5)
    ta, tb = pdt.Tensor(a), pdt.Tensor(b)
    ja, jb = jpdn.Tensor(a), jpdn.Tensor(b)
    close((ta @ tb).numpy(), (ja @ jb).numpy())
    close((-ta).numpy(), (-ja).numpy())
    close((+ta).numpy(), (+ja).numpy())
    close(abs(ta).numpy(), abs(ja).numpy())
    close((2.0 / ta).numpy(), (2.0 / ja).numpy())
    close((ta - 1).numpy(), (ja - 1).numpy())


def test_comparisons_return_bool_tensors():
    a, b = np.array([1.0, 2.0, 3.0]), np.array([2.0, 2.0, 2.0])
    ta, tb = pdt.Tensor(a), pdt.Tensor(b)
    ja, jb = jpdn.Tensor(a), jpdn.Tensor(b)
    for f in (lambda p, q: p < q, lambda p, q: p <= q, lambda p, q: p > q,
              lambda p, q: p >= q, lambda p, q: p.eq(q),
              lambda p, q: p.ne(q), lambda p, q: p.eq(2),
              lambda p, q: p < 2.5):
        got, want = f(ta, tb), f(ja, jb)
        close(got.numpy(), want.numpy())
        assert not got.requires_grad
    assert (ta.eq(tb)).numpy().tolist() == [False, True, False]


def test_tensor_of_tensor_forbidden():
    with pytest.raises(TypeError):
        pdt.Tensor(pdt.Tensor([1.0]))


def test_int_tensor_cannot_require_grad():
    with pytest.raises(ValueError):
        pdt.Tensor(np.array([1, 2]), requires_grad=True)
    with pytest.raises(ValueError):
        jpdn.Tensor(np.array([1, 2]), requires_grad=True)


def test_item_numpy_len_repr():
    for pkg in (pdt, jpdn):
        t = pkg.Tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
        assert len(t) == 2
        assert t.numpy().shape == (2, 3)
        assert t.sum().item() == 15.0
        assert repr(t).startswith("Tensor([[0. 1. 2.]")
        assert t.strides == (12, 4)
        assert t.size == 6 and t.ndim == 2 and t.shape == (2, 3)
        assert float(t[1, 2]) == 5.0 and int(t[0, 1]) == 1
        assert t.tolist() == [[0, 1, 2], [3, 4, 5]]
    assert repr(pdt.Tensor(np.ones(2))) == repr(jpdn.Tensor(np.ones(2)))


def test_inplace_forbidden_on_grad_node():
    t = pdt.Tensor(np.ones(3), requires_grad=True)
    with pytest.raises(ValueError):
        t += 1
    with pytest.raises(ValueError):
        t[0] = 5.0
    with pdt.no_grad():
        t2 = pdt.Tensor(np.ones(3))
        t2 += 1
        assert np.allclose(t2.data, 2)
        t += 1  # allowed with grad off
    assert np.allclose(t.numpy(), 2)


def run_writes(pkg):
    t = pkg.Tensor(np.zeros((3, 4), np.float32))
    t[1, 2] = 7.0
    t.data[...] = 1.0
    t.data[0] = np.arange(4, dtype=np.float32)
    t.data -= 1.0
    t[2] = pkg.Tensor(np.full(4, 5.0, np.float32))
    t += 2
    t *= np.float32(3)
    t -= np.ones(4, np.float32)
    t /= 2
    t.data[:, ::-2] = 9.0
    return t


def test_setitem_and_data_proxy_match_jax():
    got, want = run_writes(pdt), run_writes(jpdn)
    close(got.numpy(), want.numpy())
    # a write into a tensor's own memory keeps its buffer (a CUDA graph
    # reads and writes the memory it saw at its capture)
    t = pdt.Tensor(np.zeros(4, np.float32), requires_grad=True)
    ptr = t.torch.data_ptr()
    t.data -= 0.5 * torch.ones(4, dtype=torch.float32)
    t.data = np.ones(4)
    t.data[1] = 3.0
    assert t.torch.data_ptr() == ptr and t.numpy().tolist() == [1, 3, 1, 1]


def test_data_setter_rebinds_like_jax_on_a_new_type_or_shape():
    for pkg in (pdt, jpdn):
        t = pkg.Tensor(np.ones(3, np.float32))
        t.data = t.data - np.ones(3)  # float64 result: rebound
        assert t.dtype == np.float64
        t.data = np.zeros((2, 2))
        assert t.shape == (2, 2)


def run_shared(pkg):
    """Tensors over one array in the JAX package (immutable, so each
    write rebinds only its writer): the port must give the same values."""
    t = pkg.Tensor(np.arange(4.0))
    u = pkg.Tensor._wrap(t._data, t.device, False)
    v = t.reshape(2, 2)
    w = t[1:3]
    p = pkg.nn.Parameter(t)
    t.data -= 1
    u.data[0] = 7.0
    t[3] = 30.0
    p.data -= 100
    return [x.numpy() if hasattr(x, "numpy") and not torch.is_tensor(x)
            else x.detach().numpy() for x in (t, u, v, w, p)]


def test_shared_buffers_match_jax():
    for got, want in zip(run_shared(pdt), run_shared(jpdn)):
        close(got, np.asarray(want))


def test_boolean_mask_setitem():
    for pkg in (pdt, jpdn):
        t = pkg.Tensor(np.array([[0.0, 1.0], [1.0, 0.0]]))
        t[t.eq(1)] = np.float64("-inf")
        assert np.array_equal(np.isinf(t.numpy()),
                              [[False, True], [True, False]])


@pytest.mark.parametrize("key", [
    (None,), (Ellipsis, 0), (slice(None), [2, 0]), (slice(None, None, -1),),
    (slice(3, 0, -2), slice(None, None, -1)), (1, slice(None, None, -2)),
    ([0, 0, 2],), (slice(1, None), None, -1), (Ellipsis, slice(4, 0, -1)),
], ids=str)
def test_getitem_matches_jax(key):
    x = np.arange(20, dtype=np.float64).reshape(4, 5)
    got, want = both(lambda pkg, t: t[key], x)
    close(got.numpy(), want.numpy())


def test_getitem_with_tensor_key():
    x = np.arange(12, dtype=np.float64).reshape(3, 4)
    got, want = both(lambda pkg, t, i: t[i], x, np.array([2, 0, 2]))
    close(got.numpy(), want.numpy())
    got, want = both(lambda pkg, t: t[t > 5.0], x)
    close(got.numpy(), want.numpy())


# ------------------------------------------------- unary and reductions
UNARY = ["abs", "exp", "log", "sign", "sigmoid", "tanh", "sqrt", "square"]


@pytest.mark.parametrize("dt", FLOATS)
@pytest.mark.parametrize("op", UNARY)
def test_unary_function_matches_jax(op, dt):
    x = np.random.default_rng(1).uniform(0.5, 2.0, (3, 4)).astype(dt)
    got, want = both(lambda pkg, t: getattr(pkg, op)(t), x)
    close(got.numpy(), want.numpy())


@pytest.mark.parametrize("dt", [np.bool_, np.uint8, np.uint32, np.int8,
                                np.int32, np.int64, np.uint64])
def test_integer_inputs_take_jax_types(dt):
    """exp/log/tanh/mean/division of integers become JAX's float type;
    sums of integers int64 (unsigned uint64); sqrt is ``x ** 0.5`` with
    0.5 cast to the integer type, as in the JAX package."""
    x = np.arange(1, 7).reshape(2, 3).astype(dt)
    ops = [lambda pkg, t: pkg.exp(t), lambda pkg, t: pkg.log(t),
           lambda pkg, t: pkg.tanh(t), lambda pkg, t: pkg.mean(t),
           lambda pkg, t: pkg.mean(t, axis=0), lambda pkg, t: pkg.sum(t),
           lambda pkg, t: pkg.sum(t, axis=1, keepdims=True),
           lambda pkg, t: pkg.max(t, axis=1), lambda pkg, t: pkg.argmin(t),
           lambda pkg, t: pkg.square(t)]
    if np.dtype(dt) != np.bool_:
        ops += [lambda pkg, t: t / t, lambda pkg, t: pkg.sqrt(t),
                lambda pkg, t: pkg.abs(t), lambda pkg, t: t - t,
                lambda pkg, t: pkg.sign(t)]
    for f in ops:
        got, want = both(f, x)
        close(got.numpy(), want.numpy())


REDUCE = [
    lambda pkg, t: pkg.sum(t), lambda pkg, t: pkg.mean(t),
    lambda pkg, t: pkg.sum(t, axis=1),
    lambda pkg, t: pkg.mean(t, axis=(0, 2), keepdims=True),
    lambda pkg, t: pkg.max(t, axis=2), lambda pkg, t: pkg.min(t, axis=0),
    lambda pkg, t: pkg.argmax(t, axis=1), lambda pkg, t: pkg.argmin(t, axis=2),
    lambda pkg, t: pkg.max(t, axis=-1), lambda pkg, t: pkg.argmax(t),
    lambda pkg, t: t.argmax(axis=None, keepdims=True),
    lambda pkg, t: t.max(), lambda pkg, t: t.min(axis=(0, 1)),
    lambda pkg, t: t.sum(axis=-2, keepdims=True), lambda pkg, t: t.mean(1),
]


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("k", range(len(REDUCE)))
def test_reduce_function_matches_jax(k, dt):
    x = np.random.default_rng(k).standard_normal((2, 3, 4)).astype(dt)
    got, want = both(REDUCE[k], x)
    close(got.numpy(), want.numpy())


SHAPE = [
    lambda pkg, t: pkg.reshape(t, (4, 6)), lambda pkg, t: t.reshape(4, -1),
    lambda pkg, t: pkg.transpose(t, (2, 0, 1)), lambda pkg, t: t.T,
    lambda pkg, t: pkg.swapaxes(t, 0, 2), lambda pkg, t: t.flatten(),
    lambda pkg, t: pkg.unsqueeze(t, (0, 2)), lambda pkg, t: t.transpose(),
    lambda pkg, t: pkg.squeeze(pkg.unsqueeze(t, 1), axis=1),
    lambda pkg, t: pkg.squeeze(t[:1, :, :1]),
    lambda pkg, t: pkg.concat([t, t * 2], axis=-1),
    lambda pkg, t: pkg.concat(pkg.split(t, 2, axis=2), axis=0),
    lambda pkg, t: pkg.split(t, [1, 3], axis=-1)[1],
    lambda pkg, t: pkg.vsplit(t, 2)[1], lambda pkg, t: pkg.hsplit(t, 3)[2],
    lambda pkg, t: pkg.dsplit(t, [1])[1], lambda pkg, t: t.astype(np.int32),
]


@pytest.mark.parametrize("k", range(len(SHAPE)))
def test_shape_manipulation_matches_jax(k):
    x = np.arange(24, dtype=np.float64).reshape(2, 3, 4)
    got, want = both(SHAPE[k], x)
    close(got.numpy(), want.numpy())


@pytest.mark.parametrize("fn", [
    lambda pkg: pkg.squeeze(pkg.Tensor(np.random.randn(1, 4)), -5),
    lambda pkg: pkg.unsqueeze(pkg.Tensor(np.random.randn(3, 4)), -10),
    lambda pkg: pkg.split(pkg.Tensor(np.random.randn(3, 4)), 2, axis=-5),
    lambda pkg: pkg.transpose(pkg.Tensor(np.random.randn(2, 3, 4)),
                              (0, 1, -10)),
])
def test_out_of_range_axes_raise_axis_error(fn):
    for pkg in (pdt, jpdn):
        with pytest.raises(np.exceptions.AxisError):
            fn(pkg)


def test_split_errors_match_jax():
    for pkg in (pdt, jpdn):
        with pytest.raises(ValueError, match="equal division"):
            pkg.split(pkg.Tensor(np.ones((3, 4))), 2)
        with pytest.raises(ValueError, match="repeated axis"):
            pkg.core.normalize_axis_tuple((0, 0), 2)
        with pytest.raises(ValueError):
            pkg.squeeze(pkg.Tensor(np.ones((2, 3))), axis=0)


# ---------------------------------------------------------------- factories
FACTORIES = [
    lambda pkg: pkg.zeros((2, 3)), lambda pkg: pkg.ones(4, dtype=np.int32),
    lambda pkg: pkg.special.full((2, 2), 3.5, dtype=np.float32),
    lambda pkg: pkg.rand(3, 4), lambda pkg: pkg.randn(2, 5),
    lambda pkg: pkg.randn(3, dtype=np.float32),
    lambda pkg: pkg.rand(2, 2, dtype=np.float16),
    lambda pkg: pkg.uniform(-2.0, 3.0, (4, 3)),
    lambda pkg: pkg.uniform(0.0, 1.0, 5, dtype=np.float32),
    lambda pkg: pkg.randn(2, 2, requires_grad=True),
    lambda pkg: pkg.empty((2, 3)).shape,
]


@pytest.mark.parametrize("k", range(len(FACTORIES)))
def test_factories_draw_numpy_stream_bit_for_bit(k):
    np.random.seed(123)
    want = FACTORIES[k](jpdn)
    after = np.random.rand()
    np.random.seed(123)
    got = FACTORIES[k](pdt)
    assert np.random.rand() == after  # the same draws consumed
    if isinstance(want, tuple):
        assert got == want
        return
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert got.dtype == want.dtype
    assert got.requires_grad == want.requires_grad
