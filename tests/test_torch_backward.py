"""The port's tape (``backward``, ``wrap_pure``/``remat_pure``, the grad
switch, the jit over tape state) against the JAX package's on the same
seeded NumPy inputs: the cases of ``test_backward.py``, the backward cases
of ``test_ops_extended.py`` and the core-tape cases of ``test_jit.py``, a
gradient check over every op, and the autograd1d/autograd2d examples.

Tolerances: float64 within 1e-12, float32 within 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydynet_tpu as jpdn
import pydynet_tpu_torch as pdt
from chip_smoke import TAPE_OPS
from pydynet_tpu.core.tensor import Graph as JGraph
from pydynet_tpu_torch.core.tensor import Graph

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

TOL = {np.dtype(np.float64): 1e-12, np.dtype(np.float32): 1e-6}


def close(got, want, tol=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = tol or TOL.get(want.dtype, 0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def grads(pkg, fn, arrays, frozen=()):
    """Values and gradients of ``fn(pkg, *Tensors)`` (a scalar loss) with
    every input not in ``frozen`` requiring grad."""
    ts = [pkg.Tensor(a, requires_grad=i not in frozen)
          for i, a in enumerate(arrays)]
    loss = fn(pkg, *ts)
    loss.backward()
    return loss.numpy(), [None if t.grad is None else np.asarray(t.grad)
                          for t in ts]


def close_scaled(got, want):
    """Within the type's tolerance of the reference's largest magnitude
    (a sum of many float32 products carries its terms' rounding)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want.astype(np.float64)).max()) <= \
        TOL[want.dtype] * scale


def check(fn, *arrays, frozen=(), cmp=close, value=True):
    got = grads(pdt, fn, arrays, frozen)
    want = grads(jpdn, fn, arrays, frozen)
    if value:
        cmp(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        assert (g is None) == (w is None)
        if w is not None:
            cmp(g, w)


# ------------------------------------------------- a gradient check per op
# chip_smoke.TAPE_OPS, the ops the card is held to the CPU with; the JAX
# twins of its pure torch functions
JAX_PURE = {
    "wrap_pure": lambda pkg, x, y: pkg.wrap_pure(
        lambda a, b: jnp.sin(a) @ b, x, y),
    "remat_pure": lambda pkg, x, y: pkg.remat_pure(
        lambda a, b: jnp.square(a @ b) @ b.T, x, y),
}


def _w(pkg, shape, seed=9):
    return pkg.Tensor(np.random.default_rng(seed).standard_normal(shape))


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("op", sorted(TAPE_OPS))
def test_gradient_matches_jax(op, dt):
    fn, shapes = TAPE_OPS[op]
    rng = np.random.default_rng(len(op))
    arrays = [rng.standard_normal(s).astype(dt) for s in shapes]

    outs = {}

    def loss(pkg, *ts):
        out = (JAX_PURE.get(op, fn) if pkg is jpdn else fn)(pkg, *ts)
        outs[pkg] = out.numpy()
        return (out * _w(pkg, out.shape).astype(dt)).sum()

    # the op's output and the gradients; the loss, a sum of many weighted
    # terms, only carries their rounding
    check(loss, *arrays, cmp=close_scaled, value=False)
    close_scaled(outs[pdt], outs[jpdn])
    if len(arrays) == 2:  # the frozen operand gets no gradient
        check(loss, *arrays, frozen=(1,), cmp=close_scaled, value=False)


# ------------------------------------------------- test_backward.py's cases
def test_backward_scalar_polynomial():
    check(lambda pkg, x: x ** 2 + 3 * x - 1, np.array(2.0))


def test_backward_retain_graph_twice_accumulates_grad():
    for pkg in (pdt, jpdn):
        x = pkg.Tensor(2.0, requires_grad=True)
        y = x * x
        y.backward(retain_graph=True)
        first = np.array(x.grad, copy=True)
        y.backward()
        assert first == 4.0 and float(x.grad) == 8.0


@pytest.mark.parametrize("pkg", [pdt, jpdn], ids=["port", "jax"])
def test_backward_exceptions_match(pkg):
    x = pkg.Tensor(np.array([1.0, 2.0]), requires_grad=True)
    with pytest.raises(ValueError, match="scalar"):
        x.backward()
    y = pkg.Tensor(2.0, requires_grad=True) * 2
    y.backward()
    with pytest.raises(ValueError, match="not in the graph"):
        y.backward()
    with pytest.raises(ValueError, match="not in the graph"):
        pkg.Tensor(2.0).backward()
    t = pkg.Tensor(np.array([[2.0]]), requires_grad=True)
    (t * 3).backward()  # size-1 tensors of any shape count as scalars
    assert np.asarray(t.grad).tolist() == [[3.0]]


def test_grad_accumulates_zero_grad_and_missing_grad():
    for pkg in (pdt, jpdn):
        x = pkg.Tensor(3.0, requires_grad=True)
        assert float(x.grad) == 0.0  # zeros before any backward
        (x * 2).backward()
        (x * 5).backward()
        assert float(x.grad) == 7.0
        x.zero_grad()
        assert float(x.grad) == 0.0
        w = pkg.Tensor(np.ones(3))
        (pkg.Tensor(np.ones(3), requires_grad=True) * w).sum().backward()
        assert w.grad is None


def test_sum_of_two_losses_single_tape():
    check(lambda pkg, x: (x * 2).sum() + (x * x).sum(), np.array([1.0, 2.0]))


def test_no_grad_blocks_tape_and_torch():
    x = pdt.Tensor(2.0, requires_grad=True)
    with pdt.no_grad():
        y = x * x
        assert not torch.is_grad_enabled() and not pdt.is_grad_enable()
        assert not pdt.Tensor(1.0, requires_grad=True).requires_grad
        with pdt.enable_grad():
            assert torch.is_grad_enabled() and pdt.is_grad_enable()
    assert not y.requires_grad
    assert torch.is_grad_enabled() and pdt.is_grad_enable()
    z = x * x
    assert z.requires_grad
    z.backward()
    pdt.set_grad_enabled(False)
    try:
        assert not torch.is_grad_enabled()
        assert not (x * x).requires_grad
    finally:
        pdt.set_grad_enabled(True)
    assert torch.is_grad_enabled()


def test_grad_mode_decorators():
    @pdt.no_grad()
    def f(t):
        return t * 2

    @pdt.enable_grad()
    def g(t):
        return t * 2

    x = pdt.Tensor(1.0, requires_grad=True)
    assert not f(x).requires_grad
    with pdt.no_grad():
        assert g(x).requires_grad


def test_chain_unary_ops_grad():
    check(lambda pkg, x: pkg.log(pkg.exp(pkg.tanh(x)) + 1), np.array(0.7))


def test_grad_dtype_follows_param_dtype():
    got = grads(pdt, lambda pkg, x, y: (x * y).sum(),
                [np.ones(3, np.float32), np.ones(3, np.float64)])
    want = grads(jpdn, lambda pkg, x, y: (x * y).sum(),
                 [np.ones(3, np.float32), np.ones(3, np.float64)])
    assert [g.dtype for g in got[1]] == [g.dtype for g in want[1]] == [
        np.float32, np.float64]


def test_maximum_ties_give_both_operands_the_gradient():
    a = np.array([1.0, 2.0, 3.0])
    b = np.array([1.0, 5.0, 3.0])
    check(lambda pkg, x, y: pkg.maximum(x, y).sum(), a, b)
    check(lambda pkg, x, y: pkg.minimum(x, y).sum(), a, b)
    check(lambda pkg, x: pkg.max(x, axis=1).sum(),
          np.array([[1.0, 3.0, 3.0], [0.0, -1.0, 2.0]]))
    _, (gx, gy) = grads(pdt, lambda pkg, x, y: pkg.maximum(x, y).sum(),
                        [a, b])
    assert gx.tolist() == [1, 0, 1] and gy.tolist() == [1, 1, 1]


def test_getitem_backward_scatter_adds_repeats():
    check(lambda pkg, x, i: x[i].sum(), np.arange(4.0),
          np.array([0, 0, 2]), frozen=(1,))


def test_wrap_pure_multi_output():
    def f(pkg, x):
        fn = (lambda a: (jnp.sin(a), jnp.cos(a))) if pkg is jpdn \
            else (lambda a: (torch.sin(a), torch.cos(a)))
        s, c = pkg.wrap_pure(fn, x)
        return s.sum() + 2 * c.sum()

    def partial(pkg, x):  # only the first output reaches the loss
        fn = (lambda a: (jnp.sin(a), jnp.cos(a))) if pkg is jpdn \
            else (lambda a: (torch.sin(a), torch.cos(a)))
        return pkg.wrap_pure(fn, x)[0].sum()

    x = np.random.default_rng(0).standard_normal(4)
    check(f, x)
    check(partial, x)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_remat_pure_matches_wrap_pure_and_jax(dt):
    rng = np.random.default_rng(0)
    a_np = rng.standard_normal((4, 5)).astype(dt)
    b_np = rng.standard_normal((5, 6)).astype(dt)

    def g(a, b):  # no tanh: XLA's float32 tanh is an approximation
        return torch.square(a @ b) @ b.T

    out = []
    for op in (pdt.wrap_pure, pdt.remat_pure):
        a, b = pdt.Tensor(a_np, requires_grad=True), \
            pdt.Tensor(b_np, requires_grad=True)
        op(g, a, b).sum().backward()
        out.append((a.grad, b.grad))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=0, atol=0)
    check(lambda pkg, a, b: pkg.remat_pure(
        (lambda p, q: jnp.square(p @ q) @ q.T) if pkg is jpdn else g,
        a, b).sum(), a_np, b_np)


def test_remat_pure_multi_output_under_jit():
    w_np = np.random.default_rng(1).standard_normal((3, 3))
    x_np = np.random.default_rng(2).standard_normal((2, 3))
    res = {}
    for pkg in (pdt, jpdn):
        w = pkg.Tensor(w_np.copy(), requires_grad=True)
        wt = torch.from_numpy(w_np) if pkg is pdt else w_np
        sin = torch.sin if pkg is pdt else jnp.sin
        cos = torch.cos if pkg is pdt else jnp.cos

        def step(x):
            s, c = pkg.remat_pure(lambda a: (sin(a @ wt), cos(a)), x)
            y = (s * c).sum() + (x @ w).sum()
            y.backward()
            return y, pkg.Tensor(w.grad, device=w.device)

        y, g = pkg.jit(step)(pkg.Tensor(x_np, requires_grad=True))
        res[pkg] = [(float(y.item()), g.numpy())]
    for (gy, gg), (wy, wg) in zip(res[pdt], res[jpdn]):
        assert abs(gy - wy) <= 1e-12 * abs(wy)
        close(gg, wg)


# -------------------------------------------------- test_jit.py's tape cases
def test_jit_gradient_descent_state_matches_jax():
    traj = {}
    for pkg in (pdt, jpdn):
        w = pkg.Tensor(np.array(5.0), requires_grad=True)

        def step(lr):
            w.zero_grad()
            loss = (w - 2.0) ** 2
            loss.backward()
            w.data -= lr * w.grad
            return loss

        jstep = pkg.jit(step, state=[w])
        traj[pkg] = [float(jstep(np.float64(0.1)).item())
                     for _ in range(20)] + [float(w.item())]
    close(traj[pdt], traj[jpdn])
    assert abs(traj[pdt][-1] - 2.0) < 0.1


def test_jit_tape_does_not_leak():
    for pkg, graph in ((pdt, Graph), (jpdn, JGraph)):
        w = pkg.Tensor(np.array(1.0), requires_grad=True)

        def step():
            w.zero_grad()
            y = w * w
            y.backward()
            w.data -= 0.01 * w.grad
            return y

        jstep = pkg.jit(step, state=[w])
        jstep()
        n = graph.size()
        for _ in range(5):
            jstep()
        assert graph.size() == n


def test_jit_pure_function_and_structures():
    @pdt.jit
    def f(a, b):
        return a * b + 2

    x = pdt.Tensor(np.arange(3, dtype=np.float32))
    out = f(x, pdt.Tensor(np.ones(3, dtype=np.float32)))
    assert isinstance(out, pdt.Tensor) and not out.requires_grad
    assert out.numpy().tolist() == [2, 3, 4] and out.dtype == np.float32

    @pdt.jit
    def g(x, mode, *, scale):
        if mode == "pair":
            return x * 2, x * scale
        return {"single": x + 1, "nested": [x * scale]}

    a, b = g(x, "pair", scale=3), g(x, "dict", scale=pdt.Tensor(np.ones(3)))
    assert isinstance(a, tuple) and isinstance(b, dict)
    assert a[1].numpy().tolist() == [0, 3, 6]
    assert b["nested"][0].numpy().tolist() == [0, 1, 2]


def test_jit_static_python_args_retrace():
    calls = []

    def f(x, k):
        calls.append(k)
        return x * k

    jf = pdt.jit(f)
    x = pdt.Tensor(np.ones(2))
    assert np.allclose(jf(x, 3).numpy(), 3)
    assert np.allclose(jf(x, 4).numpy(), 4)
    assert np.allclose(jf(x, 3).numpy(), 3)
    # the CPU route runs the step every call (nothing to capture)
    assert calls == [3, 4, 3]


def test_jit_returns_a_clone_of_state():
    w = pdt.Tensor(np.ones(2), requires_grad=True)

    def step():
        with pdt.no_grad():
            w.data += 1
        return w

    jstep = pdt.jit(step, state=[w])
    out = jstep()
    jstep()
    assert out.numpy().tolist() == [2, 2] and w.numpy().tolist() == [3, 3]
    assert not out.requires_grad and out is not w


def test_jit_foreach_over_tensors_matches_loop():
    xs = np.random.default_rng(4).standard_normal((5, 3))
    res = []
    for use_foreach in (False, True):
        w = pdt.Tensor(np.zeros(3), requires_grad=True)

        def step(x):
            w.zero_grad()
            loss = ((w - x) ** 2).sum()
            loss.backward()
            w.data -= 0.1 * w.grad
            return loss

        js = pdt.jit(step, state=[w])
        if use_foreach:
            losses = js.foreach(pdt.Tensor(xs)).numpy()
        else:
            losses = np.array([js(pdt.Tensor(xs[i])).item()
                               for i in range(5)])
        res.append((losses, w.numpy()))
    np.testing.assert_array_equal(res[0][0], res[1][0])
    np.testing.assert_array_equal(res[0][1], res[1][1])


# ------------------------------------------------------------- the examples
def test_autograd1d_matches_jax_example():
    import examples.pydynet.autograd1d as jex
    from pydynet_tpu_torch.examples import autograd1d

    traj, err = autograd1d.main(device="cpu")
    want = np.array(jex.auto_grad(1.0, 1.5, 20))
    close(traj, want)
    assert err < 1e-6
    close(traj, np.array(autograd1d.manual_grad(1.0, 1.5, 20)), 1e-6)


def test_autograd2d_through_jit_matches_jax_example():
    import examples.pydynet.autograd2d as jex
    from pydynet_tpu_torch.examples import autograd2d

    got = autograd2d.main(device="cpu")
    want = jex.main()
    close(got, want)
    assert np.allclose(got[-1], [3.0, -1.0], atol=1e-3)
    assert got.shape == (61, 2)


def test_examples_default_to_the_card():
    from pydynet_tpu_torch.examples import autograd1d, autograd2d

    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the CPU-only case")
    for main in (autograd1d.main, autograd2d.main):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            main(device=None)
    assert autograd1d.cli(["--device", "cpu"])[1] < 1e-6
