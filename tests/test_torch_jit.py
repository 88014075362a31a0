"""The port's ``jit`` (``pydynet_tpu_torch/jit.py``) against the JAX
package's, on the CPU: the cases of ``tests/test_jit.py`` that do not need
the core tape, each from the same state in both packages.

On the CPU the port's jit runs the step eagerly at every call (its CUDA-graph
route is held against this eager route in ``tests/test_torch_gpu.py``), so
these tests pin the semantics the graphs must keep: the state updated in
place, the threefry stream advanced as the JAX jit advances it, static
arguments, output trees, ``foreach`` and its argument checks. Weights cross
through ``utils/checkpoint.load_state_dict``; everything is float64, so
losses and weights are held within 1e-12 (the packages sum in other
orders).
"""
import numpy as np
import pytest
import torch

import pydynet_tpu as pdn
from pydynet_tpu import nn as jnn
from pydynet_tpu import optim as joptim
import pydynet_tpu.nn.functional as JF

import pydynet_tpu_torch as pdt
from pydynet_tpu_torch import jit, nn as tnn, optim as toptim
from pydynet_tpu_torch.nn import functional as TF
from pydynet_tpu_torch.utils.checkpoint import load_state_dict, state_dict

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

F64 = torch.float64


def close(got, want, tol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def weights_close(jnet, tnet, tol=1e-12):
    want = jnet.state_dict()
    for name, got in state_dict(tnet).items():
        close(got, want[name], tol)


def test_pure_function():
    f = jit(lambda a, b: a * b + 2)
    x, y = torch.arange(3.0), torch.ones(3)
    out = f(x, y)
    assert isinstance(out, torch.Tensor) and out.tolist() == [2, 3, 4]
    assert f(x, y).tolist() == [2, 3, 4]


def test_gradient_descent_state_matches_jax():
    jw = pdn.Tensor(np.array(5.0), requires_grad=True)
    tw = torch.tensor(5.0, dtype=F64, requires_grad=True)

    def jstep(lr):
        jw.zero_grad()
        loss = (jw - 2.0) ** 2
        loss.backward()
        jw.data -= lr * jw.grad
        return loss

    def tstep(lr):
        tw.grad = None
        loss = (tw - 2.0) ** 2
        loss.backward()
        with torch.no_grad():
            tw.sub_(lr * tw.grad)
        return loss

    js, ts = pdn.jit(jstep, state=[jw]), jit(tstep, state=[tw])
    want = [float(js(np.float64(0.1)).item()) for _ in range(20)]
    got = [float(ts(np.float64(0.1))) for _ in range(20)]
    close(got, want)
    assert want[0] > want[-1]
    close(float(tw), float(jw.item()))
    assert abs(float(tw) - 2.0) < 0.1


def test_outputs_are_detached_and_grads_do_not_leak():
    """The JAX jit returns plain tensors and drops its tape: here a call's
    outputs carry no autograd graph, and each call's gradient is that
    call's alone."""
    w = torch.tensor(1.0, dtype=F64, requires_grad=True)

    def step():
        w.grad = None
        y = w * w
        y.backward()
        with torch.no_grad():
            w.sub_(0.01 * w.grad)
        return y, w.grad

    js = jit(step, state=[w])
    for _ in range(5):
        before = float(w)
        y, g = js()
        assert not y.requires_grad and y.grad_fn is None
        close(float(g), 2 * before)


def test_rng_state_advances_like_jax():
    """Draws inside the jitted step advance the threefry stream: two calls
    differ, and each equals the JAX jit's draw bit for bit."""
    pdn.default_generator.manual_seed(0)
    pdt.default_generator.manual_seed(0)
    jdraw = pdn.jit(lambda: pdn.Tensor(pdn.default_generator.uniform((4,))))
    tdraw = jit(lambda: pdt.default_generator.uniform((4,)))
    want = [jdraw().numpy() for _ in range(3)]
    got = [tdraw().numpy() for _ in range(3)]
    assert not np.array_equal(got[0], got[1])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_static_python_args():
    """A non-tensor argument is part of the signature. On the CPU route
    the step runs at every call (the graph route runs it at a signature's
    eager call and its capture only)."""
    calls = []

    def f(x, k):
        calls.append(k)
        return x * k

    jf = jit(f)
    x = torch.ones(2, dtype=F64)
    assert jf(x, 3).tolist() == [3, 3]
    assert jf(x, 4).tolist() == [4, 4]
    assert jf(x, 3).tolist() == [3, 3]
    assert calls == [3, 4, 3]
    with pytest.raises(TypeError, match="hashable"):
        jf(x, {1, 2})


def test_nested_outputs_and_kwargs():
    @jit
    def f(x, *, scale):
        return {"y": x + 1, "pair": (x * 2, x * scale)}

    out = f(torch.ones(2), scale=torch.full((2,), 3.0))
    assert set(out) == {"y", "pair"} and isinstance(out["pair"], tuple)
    assert out["y"].tolist() == [2, 2] and out["pair"][1].tolist() == [3, 3]
    assert f(torch.ones(2), scale=torch.full((2,), 4.0))["pair"][1].tolist() \
        == [4, 4]


def test_output_structure_per_signature():
    """Two signatures with different output trees each keep their own, in
    any call order (the JAX jit's template-per-signature regression)."""
    w = torch.ones((2, 2), dtype=F64, requires_grad=True)

    def step(x, as_dict):
        y = (x @ w).sum()
        if as_dict:
            return {"loss": y, "double": y * 2.0}
        return (y, y * 3.0)

    js = jit(step, state=[w])
    x = torch.ones((2, 2), dtype=F64)
    d = js(x, True)
    t = js(x, False)
    d2 = js(x, True)
    assert isinstance(d, dict) and set(d) == {"loss", "double"}
    assert isinstance(t, tuple) and len(t) == 2 and isinstance(d2, dict)
    assert float(d2["loss"]) == float(d["loss"]) == 8.0
    assert float(t[1]) == 3.0 * float(t[0])


def bn_twins():
    np.random.seed(0)
    jnet = jnn.Sequential(jnn.Linear(4, 8), jnn.BatchNorm1d(8), jnn.Tanh(),
                          jnn.Linear(8, 2))
    tnet = torch.nn.Sequential(tnn.Linear(4, 8, dtype=F64),
                               tnn.BatchNorm1d(8, dtype=F64), tnn.Tanh(),
                               tnn.Linear(8, 2, dtype=F64))
    load_state_dict(tnet, jnet.state_dict())
    return jnet, tnet


def test_batchnorm_running_stats_advance_like_jax():
    jnet, tnet = bn_twins()
    jopt = joptim.SGD(jnet.parameters(), lr=0.01, momentum=0.0,
                      nesterov=False)
    topt = toptim.SGD(tnet.parameters(), lr=0.01, momentum=0.0,
                      nesterov=False)

    def jstep(x, y):
        jopt.zero_grad()
        loss = JF.mse_loss(jnet(x), y)
        loss.backward()
        jopt.step()
        return loss

    def tstep(x, y):
        topt.zero_grad()
        loss = TF.mse_loss(tnet(x), y)
        loss.backward()
        topt.step()
        return loss

    js, ts = pdn.jit(jstep, state=(jnet, jopt)), jit(tstep, state=(tnet, topt))
    rng = np.random.default_rng(1)
    x, y = rng.standard_normal((16, 4)) + 3.0, rng.standard_normal((16, 2))
    seen = [tnet[1].running_mean.clone()]
    for _ in range(3):
        close(float(ts(torch.from_numpy(x), torch.from_numpy(y))),
              float(js(pdn.Tensor(x), pdn.Tensor(y)).item()))
        weights_close(jnet, tnet)
        seen.append(tnet[1].running_mean.clone())
    assert all(not torch.equal(a, b) for a, b in zip(seen, seen[1:]))


def adam_build(seed, dropout):
    """Twin nets (with a Dropout(0.5) when ``dropout``) and Adam steps of
    each package, jitted, from one state and one threefry seed."""
    np.random.seed(seed)
    layers = [jnn.Linear(6, 32), jnn.Tanh()] + (
        [jnn.Dropout(0.5)] if dropout else []) + [jnn.Linear(32, 2)]
    jnet = jnn.Sequential(*layers)
    tlayers = [tnn.Linear(6, 32, dtype=F64), tnn.Tanh()] + (
        [tnn.Dropout(0.5)] if dropout else []) + [tnn.Linear(32, 2, dtype=F64)]
    tnet = torch.nn.Sequential(*tlayers)
    load_state_dict(tnet, jnet.state_dict())
    jnet.train()
    tnet.train()
    jopt = joptim.Adam(jnet.parameters(), lr=1e-2)
    topt = toptim.Adam(tnet.parameters(), lr=1e-2)
    pdn.manual_seed(seed)
    pdt.manual_seed(seed)

    def jstep(x, y):
        jopt.zero_grad()
        loss = JF.mse_loss(jnet(x), y)
        loss.backward()
        jopt.step()
        return loss

    def tstep(x, y):
        topt.zero_grad()
        loss = TF.mse_loss(tnet(x), y)
        loss.backward()
        topt.step()
        return loss

    return (jnet, pdn.jit(jstep, state=(jnet, jopt)), tnet,
            jit(tstep, state=(tnet, topt)))


@pytest.mark.parametrize("dropout", [False, True],
                         ids=["adam", "adam-dropout"])
def test_foreach_equals_the_loop_and_the_jax_foreach(dropout):
    """``foreach`` over 4 batches gives the per-call loop's losses and
    weights, and the JAX ``foreach``'s; with dropout the threefry stream is
    threaded alike, so the masks are the JAX package's."""
    rng = np.random.default_rng(2)
    Xb, Yb = rng.standard_normal((4, 16, 6)), rng.standard_normal((4, 16, 2))
    jnet, jstep, _, tloop = adam_build(11, dropout)
    want = jstep.foreach(pdn.Tensor(Xb), pdn.Tensor(Yb)).numpy()
    _, _, tnet2, tfused = adam_build(11, dropout)
    fused = tfused.foreach(torch.from_numpy(Xb), torch.from_numpy(Yb))
    _, _, tnet1, tloop = adam_build(11, dropout)
    loop = [float(tloop(torch.from_numpy(Xb[i]), torch.from_numpy(Yb[i])))
            for i in range(4)]
    assert fused.shape == (4,)
    close(fused.numpy(), loop)
    close(fused.numpy(), want.reshape(-1))
    weights_close(jnet, tnet1)
    weights_close(jnet, tnet2)
    if not dropout:  # the live state is shared between calls and foreach
        close(float(tfused(torch.from_numpy(Xb[0]),
                           torch.from_numpy(Yb[0]))),
              float(tloop(torch.from_numpy(Xb[0]), torch.from_numpy(Yb[0]))))


def test_foreach_argument_checks():
    f = jit(lambda x, y: x + y)
    x = torch.zeros(5, 3)
    with pytest.raises(ValueError, match="steps axis"):
        f.foreach(x, torch.zeros(3, 3))
    with pytest.raises(TypeError, match="tensors"):
        f.foreach(x, 2.0)
    with pytest.raises(ValueError, match="leading steps axis"):
        f.foreach(torch.zeros(()), torch.zeros(()))
    out = f.foreach(x, {"a": torch.ones(5, 3)}["a"])
    assert out.shape == (5, 3) and float(out.sum()) == 15


def test_grad_accumulation_microbatches():
    """K microbatch backward() calls accumulate into .grad and one step
    applies them: with each microloss scaled by 1/K the update equals the
    full-batch step, in the port and in the JAX package alike."""
    rng = np.random.default_rng(21)
    X, Y = rng.standard_normal((24, 6)), rng.standard_normal((24, 3))
    K = 4

    def build():
        np.random.seed(5)
        jnet = jnn.Sequential(jnn.Linear(6, 8), jnn.Tanh(), jnn.Linear(8, 3))
        tnet = torch.nn.Sequential(tnn.Linear(6, 8, dtype=F64), tnn.Tanh(),
                                   tnn.Linear(8, 3, dtype=F64))
        load_state_dict(tnet, jnet.state_dict())
        return jnet, tnet, toptim.SGD(tnet.parameters(), lr=0.1,
                                      momentum=0.0, nesterov=False)

    jnet, net1, opt1 = build()
    jopt = joptim.SGD(jnet.parameters(), lr=0.1, momentum=0.0,
                      nesterov=False)

    def jaccum(xs, ys):
        jopt.zero_grad()
        for i in range(K):
            loss = JF.mse_loss(jnet(xs[i]), ys[i]) / K
            loss.backward()
        jopt.step()
        return loss

    def accum(xs, ys):
        opt1.zero_grad()
        for i in range(K):
            loss = TF.mse_loss(net1(xs[i]), ys[i]) / K
            loss.backward()
        opt1.step()
        return loss

    _, net2, opt2 = build()

    def full(x, y):
        opt2.zero_grad()
        loss = TF.mse_loss(net2(x), y)
        loss.backward()
        opt2.step()
        return loss

    ja = pdn.jit(jaccum, state=(jnet, jopt))
    ta, tf = jit(accum, state=(net1, opt1)), jit(full, state=(net2, opt2))
    xs, ys = X.reshape(K, 6, 6), Y.reshape(K, 6, 3)
    for _ in range(3):
        ja(pdn.Tensor(xs), pdn.Tensor(ys))
        ta(torch.from_numpy(xs), torch.from_numpy(ys))
        tf(torch.from_numpy(X), torch.from_numpy(Y))
    for (name, a), b in zip(net1.named_parameters(), net2.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=name)
    weights_close(jnet, net1)


def test_lstm_trains_under_jit_like_jax():
    """test_rnn.py's jitted LSTM regression: the first steps' losses equal
    the JAX jit's, and 150 steps cut the loss tenfold."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 4, 2))
    y = x.sum((0, 2)).reshape(4, 1)
    np.random.seed(1)
    jlstm, jhead = jnn.LSTM(2, 8), jnn.Linear(8, 1)
    tlstm, thead = tnn.LSTM(2, 8, dtype=F64), tnn.Linear(8, 1, dtype=F64)
    load_state_dict(tlstm, jlstm.state_dict())
    load_state_dict(thead, jhead.state_dict())
    jopt = joptim.Adam(list(jlstm.parameters()) + list(jhead.parameters()),
                       lr=1e-2)
    topt = toptim.Adam(list(tlstm.parameters()) + list(thead.parameters()),
                       lr=1e-2)

    def jstep(bx, by):
        jopt.zero_grad()
        _, (hn, _) = jlstm(bx)
        loss = JF.mse_loss(jhead(hn[0]), by)
        loss.backward()
        jopt.step()
        return loss

    def tstep(bx, by):
        topt.zero_grad()
        _, (hn, _) = tlstm(bx)
        loss = TF.mse_loss(thead(hn[0]), by)
        loss.backward()
        topt.step()
        return loss

    js = pdn.jit(jstep, state=(jlstm, jhead, jopt))
    ts = jit(tstep, state=(tlstm, thead, topt))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    want = [float(js(pdn.Tensor(x), pdn.Tensor(y)).item()) for _ in range(5)]
    got = [float(ts(tx, ty)) for _ in range(150)]
    close(got[:5], want, 1e-10)
    assert got[-1] < got[0] * 0.1


def test_mesh_raises_naming_parallel():
    """``jit(mesh=)`` runs (it raised until the parallel package was
    ported): on a one-rank gloo mesh in this process, the state placed on
    the mesh as DTensors and the losses those of the eager step.
    ``tests/test_torch_parallel.py`` holds it against the JAX package on
    spawned ranks."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from pydynet_tpu_torch.parallel import make_mesh

    started = not dist.is_initialized()
    mesh = make_mesh({"dp": 1}, device_type="cpu")
    try:
        nets = [tnn.Linear(3, 2, dtype=F64) for _ in range(2)]
        load_state_dict(nets[1], state_dict(nets[0]))
        opts = [toptim.SGD(n.parameters(), lr=0.1) for n in nets]

        def make(net, opt):
            def step(x, y):
                opt.zero_grad()
                loss = TF.mse_loss(net(x), y)
                loss.backward()
                opt.step()
                return loss
            return step

        js = jit(make(nets[0], opts[0]), state=(nets[0], opts[0]),
                 mesh=mesh)
        eager = make(nets[1], opts[1])
        x = torch.randn(4, 3, dtype=F64)
        y = torch.randn(4, 2, dtype=F64)
        got = [float(js(x, y)) for _ in range(3)]
        want = [float(eager(x, y)) for _ in range(3)]
        assert got == want
        assert isinstance(nets[0].weight, DTensor)
        assert not isinstance(js(x, y), DTensor)  # outputs come back whole
    finally:
        if started:
            dist.destroy_process_group()
    # donate_state and batch_axis are taken
    assert jit(lambda x: x + 1, donate_state=False,
               batch_axis="dp")(torch.zeros(1)).tolist() == [1]


def test_state_must_be_modules_optimizers_generators_or_tensors():
    with pytest.raises(TypeError, match="jit state"):
        jit(lambda: 0, state=[object()])()
