"""The port's nn layers (``pydynet_tpu_torch/nn``) against their JAX twins,
on the CPU.

Each JAX layer is built from a numpy seed and its weights are carried into
the port's twin by ``utils/checkpoint.load_state_dict``; both get the same
numpy inputs. Forward outputs and the gradients of ``sum(out * w)`` for a
numpy-drawn ``w`` are held to 1e-5 (absolute and relative): both packages
compute in float32 and differ only in summation order. Ties are held too:
a tied max-pool window splits its gradient evenly in both, and
``leaky_relu`` at exactly 0 passes its gradient to both operands of its
max, as the JAX package's maximum does.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pydynet_tpu as pdn
from pydynet_tpu import nn as jnn
from pydynet_tpu.data import data_loader as jax_data_loader

import pydynet_tpu_torch as pdt
from pydynet_tpu_torch import nn as tnn
from pydynet_tpu_torch.data import data_loader
from pydynet_tpu_torch.nn import functional as F
from pydynet_tpu_torch.utils.checkpoint import load_state_dict, state_dict

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

REPO = Path(__file__).resolve().parents[1]
F32 = np.float32
TOL = dict(atol=1e-5, rtol=1e-5)


def draw(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(F32)


def twin(jmod, tmod):
    """Carry the JAX layer's weights (and buffers) into the port's."""
    load_state_dict(tmod, jmod.state_dict())
    return jmod, tmod


def run_both(jmod, tmod, x, seed=0, grad_x=True):
    """Forward both on x, backward sum(out * w); compare outputs, the
    input's gradient and every parameter's gradient by name."""
    xj = pdn.Tensor(x, requires_grad=grad_x)
    xt = torch.from_numpy(x).requires_grad_(grad_x)
    oj, ot = jmod(xj), tmod(xt)
    np.testing.assert_allclose(ot.detach().numpy(), oj.numpy(), **TOL)
    w = draw(ot.shape, seed + 100)
    (oj * pdn.Tensor(w)).sum().backward()
    (ot * torch.from_numpy(w)).sum().backward()
    if grad_x:
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(xj.grad),
                                   **TOL)
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(jmod._parameters[name].grad),
                                   err_msg=name, **TOL)
    return ot


@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    np.random.seed(0)
    jm, tm = twin(jnn.Linear(5, 7, bias=bias, dtype=F32),
                  tnn.Linear(5, 7, bias=bias))
    assert tm.weight.shape == (5, 7)  # (in, out), the JAX layout
    run_both(jm, tm, draw((4, 5), 1))
    assert tm.reset_paramters == tm.reset_parameters


def test_linear_init_law():
    """kaiming_uniform(a=sqrt(5)) with the relu gain: |w| <= sqrt(6 / in);
    the bias within 1 / sqrt(in); the same seed gives the same weights."""
    pdt.manual_seed(3)
    a = tnn.Linear(400, 300)
    pdt.manual_seed(3)
    b = tnn.Linear(400, 300)
    assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    w = a.weight.detach()
    assert float(w.abs().max()) <= np.sqrt(6 / 400)
    assert float(w.abs().max()) > 0.95 * np.sqrt(6 / 400)
    assert float(a.bias.abs().max()) <= 1 / np.sqrt(400)


def test_embedding_padding_idx():
    np.random.seed(1)
    jm, tm = twin(jnn.Embedding(10, 6, padding_idx=2, dtype=F32),
                  tnn.Embedding(10, 6, padding_idx=2))
    assert not tm.weight[2].any()
    idx = np.array([[1, 2, 9, 2], [0, 5, 5, 3]])
    oj, ot = jm(pdn.Tensor(idx)), tm(torch.from_numpy(idx))
    np.testing.assert_allclose(ot.detach().numpy(), oj.numpy(), **TOL)
    w = draw(ot.shape, 2)
    (oj * pdn.Tensor(w)).sum().backward()
    (ot * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tm.weight.grad.numpy(),
                               np.asarray(jm.weight.grad), **TOL)
    assert not tm.weight.grad[2].any()


ACTIVATIONS = {
    "sigmoid": (jnn.Sigmoid, tnn.Sigmoid, ()),
    "tanh": (jnn.Tanh, tnn.Tanh, ()),
    "relu": (jnn.ReLU, tnn.ReLU, ()),
    "leaky_relu": (jnn.LeakyReLU, tnn.LeakyReLU, (0.2,)),
    "silu": (jnn.SiLU, tnn.SiLU, ()),
    "gelu": (jnn.GELU, tnn.GELU, ()),
    "softmax_axis1": (jnn.Softmax, tnn.Softmax, (1,)),
    "softmax_all": (jnn.Softmax, tnn.Softmax, ()),
}


@pytest.mark.parametrize("name", list(ACTIVATIONS))
def test_activation(name):
    jcls, tcls, args = ACTIVATIONS[name]
    run_both(jcls(*args), tcls(*args), draw((6, 5), 3, scale=3.0))


@pytest.mark.parametrize("axis,keepdims", [(1, True), (None, False),
                                           (0, True)])
def test_log_softmax(axis, keepdims):
    import pydynet_tpu.nn.functional as JF

    x = draw((5, 5), 4, scale=2.0)
    want = JF.log_softmax(pdn.Tensor(x), axis, keepdims).numpy()
    got = F.log_softmax(torch.from_numpy(x), axis, keepdims).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_relu_passes_the_gradient_at_zero():
    """The JAX package's max gives a tie's gradient to both operands, so
    relu's gradient at exactly 0 is 1 there; the port keeps that."""
    xj = pdn.Tensor(np.array([-1.0, 0.0, 2.0], F32), requires_grad=True)
    xt = torch.tensor([-1.0, 0.0, 2.0], requires_grad=True)
    jnn.ReLU()(xj).sum().backward()
    tnn.ReLU()(xt).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(xj.grad))


def test_leaky_relu_gradient_at_zero_matches_jax():
    """At exactly 0 both operands of max(x, alpha x) tie: the JAX package
    gives each the full gradient, 1 + alpha = 1.2, not torch's half each."""
    x = np.array([[-1.0, 0.0, 2.0, 0.0], [0.0, -3.0, 0.0, 5.0]], F32)
    out = run_both(jnn.LeakyReLU(0.2), tnn.LeakyReLU(0.2), x)
    xt = torch.from_numpy(x).requires_grad_()
    F.leaky_relu(xt, 0.2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy()[x == 0], 1.2, rtol=1e-6)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.where(x > 0, x, 0.2 * x))


@pytest.mark.parametrize("kind", ["max1d", "max2d"])
def test_max_pool_ties_split_the_gradient_like_jax(kind):
    """A window of equal values (zeros, and the zero padding beside them)
    splits its gradient evenly, as jnp.max over the window does: 0.25 a
    cell for a 2x2 window, 0.5 for a 2-wide one."""
    jcls, tcls, shape = POOLS[kind]
    x = np.zeros(shape, F32)
    x[..., :1] = draw(shape[:-1] + (1,), 11)  # one untied column
    for kernel, stride, padding in ((2, 2, 0), (3, 2, 1)):
        run_both(jcls(kernel, stride, padding), tcls(kernel, stride,
                                                     padding), x)
    xt = torch.zeros((1, 1) + shape[2:], requires_grad=True)
    tcls(2, 2, 0)(xt).sum().backward()
    want = 0.25 if kind == "max2d" else 0.5
    covered = xt.grad[..., :shape[-2] // 2 * 2, :shape[-1] // 2 * 2] \
        if kind == "max2d" else xt.grad[..., :shape[-1] // 2 * 2]
    np.testing.assert_allclose(covered.numpy(), want)


@pytest.mark.parametrize("shape,x_shape", [((4, 8), (2, 4, 8)),
                                           (8, (2, 3, 8)),
                                           ((2, 4, 8), (3, 2, 4, 8))])
def test_rmsnorm_over_trailing_axes_matches_jax(shape, x_shape):
    """RMSNorm(normalized_shape) normalizes over the trailing
    len(normalized_shape) axes, as the JAX layer does (a (4, 8) norm on a
    (2, 4, 8) input once differed by 0.78), forward and gradients, with the
    same non-unit weights."""
    jm = jnn.RMSNorm(shape, dtype=F32)
    jm.weight.data = draw(jm.weight.shape, 13, 0.5, 1.0)
    jm, tm = twin(jm, tnn.RMSNorm(shape))
    assert tm.weight.shape == tuple(jm.weight.shape)
    run_both(jm, tm, draw(x_shape, 14, 2.0))


@pytest.mark.parametrize("stride,padding", [(1, 0), (1, 1), (2, 1)])
def test_conv1d(stride, padding):
    np.random.seed(5)
    jm, tm = twin(jnn.Conv1d(3, 4, 3, stride, padding, dtype=F32),
                  tnn.Conv1d(3, 4, 3, stride, padding))
    assert tm.bias.shape == (1, 4, 1)
    run_both(jm, tm, draw((2, 3, 11), 6))


@pytest.mark.parametrize("stride,padding", [(1, 0), (1, 1), (2, 1)])
def test_conv2d(stride, padding):
    np.random.seed(7)
    jm, tm = twin(jnn.Conv2d(2, 3, 3, stride, padding, dtype=F32),
                  tnn.Conv2d(2, 3, 3, stride, padding))
    assert tm.bias.shape == (1, 3, 1, 1)
    run_both(jm, tm, draw((2, 2, 9, 8), 8))


POOLS = {"max1d": (jnn.MaxPool1d, tnn.MaxPool1d, (2, 3, 11)),
         "avg1d": (jnn.AvgPool1d, tnn.AvgPool1d, (2, 3, 11)),
         "max2d": (jnn.MaxPool2d, tnn.MaxPool2d, (2, 3, 9, 8)),
         "avg2d": (jnn.AvgPool2d, tnn.AvgPool2d, (2, 3, 9, 8))}


@pytest.mark.parametrize("kernel,stride,padding", [(2, 2, 0), (3, 2, 1),
                                                   (3, 1, 1)])
@pytest.mark.parametrize("kind", list(POOLS))
def test_pool(kind, kernel, stride, padding):
    """Normal draws: no ties inside a window (see the module doc)."""
    jcls, tcls, shape = POOLS[kind]
    run_both(jcls(kernel, stride, padding), tcls(kernel, stride, padding),
             draw(shape, 9))


@pytest.mark.parametrize("kind", ["max1d", "max2d"])
def test_max_pool_zero_padding_wins_over_negatives(kind):
    """Zeros pad before the max: windows over the border of an all-negative
    input give 0, where torch's own -inf padding would give a negative."""
    jcls, tcls, shape = POOLS[kind]
    x = -np.abs(draw(shape, 10)) - 0.5
    want = jcls(3, 2, 1)(pdn.Tensor(x)).numpy()
    got = tcls(3, 2, 1)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any() and (got < 0).any()


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_losses(reduction):
    import pydynet_tpu.nn.functional as JF

    logits = draw((6, 5), 11, scale=2.0)
    target = draw((6, 5), 12)
    labels = np.random.default_rng(13).integers(0, 5, 6)
    onehot = np.eye(5, dtype=F32)[labels]
    cases = [
        (jnn.MSELoss, tnn.MSELoss, lambda a: a, target),
        (jnn.NLLLoss, tnn.NLLLoss,
         lambda a: JF.log_softmax(a, 1, True), onehot),
        (jnn.CrossEntropyLoss, tnn.CrossEntropyLoss, lambda a: a, labels),
    ]
    for jcls, tcls, jprep, y in cases:
        xj = pdn.Tensor(logits, requires_grad=True)
        xt = torch.from_numpy(logits).requires_grad_()
        tprep = (lambda a: F.log_softmax(a, 1, True)) \
            if jcls is jnn.NLLLoss else (lambda a: a)
        lj = jcls(reduction)(jprep(xj), pdn.Tensor(y))
        lt = tcls(reduction)(tprep(xt), torch.from_numpy(y))
        np.testing.assert_allclose(float(lt), float(lj.numpy()), **TOL)
        lj.backward()
        lt.backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(xj.grad),
                                   **TOL)
    with pytest.raises(ValueError, match="mean or sum"):
        tnn.MSELoss("none")


NORMS = {
    "bn1d": (lambda: jnn.BatchNorm1d(6, dtype=F32),
             lambda: tnn.BatchNorm1d(6), (8, 6), (6,)),
    "bn2d": (lambda: jnn.BatchNorm2d(3, dtype=F32),
             lambda: tnn.BatchNorm2d(3), (4, 3, 5, 5), (1, 3, 1, 1)),
    "layernorm": (lambda: jnn.LayerNorm(6, dtype=F32),
                  lambda: tnn.LayerNorm(6), (8, 6), (6,)),
    "layernorm3d": (lambda: jnn.LayerNorm((5,), dtype=F32),
                    lambda: tnn.LayerNorm((5,)), (2, 3, 5), (5,)),
}


@pytest.mark.parametrize("kind", list(NORMS))
def test_norm_three_train_steps_then_eval(kind):
    """Three train-mode steps (outputs and gradients compared, the running
    statistics after each), then eval mode; the running statistics are
    buffers, not parameters."""
    make_j, make_t, shape, stat = NORMS[kind]
    jm, tm = make_j(), make_t()
    assert {n for n, _ in tm.named_parameters()} == {"scale", "shift"}
    assert {n for n, _ in tm.named_buffers()} == {"running_mean",
                                                  "running_var"}
    assert tm.running_mean.shape == stat and tm.eps == 1e-6
    for p in (tm.scale, tm.shift):  # non-trivial affine parameters
        with torch.no_grad():
            p.copy_(torch.from_numpy(draw(stat, p.numel() + 20)))
    jm.load_state_dict(state_dict(tm))
    for step in range(3):
        jm.train()
        tm.train()
        for p in tm.parameters():
            p.grad = None
        for p in jm._parameters.values():
            p.zero_grad()
        run_both(jm, tm, draw(shape, 30 + step, scale=2.0, shift=1.0),
                 seed=step)
        for name in ("running_mean", "running_var"):
            np.testing.assert_allclose(getattr(tm, name).numpy(),
                                       jm._parameters[name].numpy(),
                                       err_msg=name, **TOL)
    jm.eval()
    tm.eval()
    x = draw(shape, 40, scale=2.0, shift=1.0)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, jm(pdn.Tensor(x)).numpy(), **TOL)


def test_dropout_law():
    """Inverted dropout: kept elements scaled by 1 / (1 - p), about 1 - p of
    them kept, the identity in eval mode; a reseeded generator repeats the
    mask, and the gradient is the mask."""
    p, n = 0.25, 20000
    drop = tnn.Dropout(p)
    x = torch.ones(n, requires_grad=True)
    pdt.manual_seed(5)
    a = drop(x)
    np.testing.assert_allclose(np.unique(a.detach().numpy()),
                               [0.0, 1 / (1 - p)], rtol=1e-6)
    kept = float((a > 0).float().mean())
    assert abs(kept - (1 - p)) < 4 * np.sqrt(p * (1 - p) / n)
    a.sum().backward()
    torch.testing.assert_close(x.grad, a.detach())
    pdt.manual_seed(5)
    assert torch.equal(drop(x), a)
    assert not torch.equal(drop(x), a)
    gen = pdt.random.Generator(9)
    first = F.dropout(x, p, generator=gen)
    assert torch.equal(F.dropout(x, p, generator=gen.manual_seed(9)), first)
    assert not torch.equal(F.dropout(x, p, generator=gen), first)
    drop.eval()
    assert drop(x) is x
    assert F.dropout(x, 0.0) is x
    with pytest.raises(ValueError, match="probability"):
        tnn.Dropout(1.0)


def test_manual_seed_seeds_numpy_and_init():
    pdt.manual_seed(11)
    a, r1 = tnn.Linear(3, 4), np.random.rand()
    pdt.manual_seed(11)
    b, r2 = tnn.Linear(3, 4), np.random.rand()
    assert r1 == r2 and torch.equal(a.weight, b.weight)


class JNet(jnn.Module):

    def __init__(self):
        super().__init__()
        self.fc = jnn.Linear(6, 4, dtype=F32)
        self.bn = jnn.BatchNorm1d(4, dtype=F32)
        self.conv = jnn.Conv2d(2, 3, 3, 1, 1, dtype=F32)
        self.seq = jnn.Sequential(jnn.Linear(4, 3, dtype=F32), jnn.ReLU(),
                                  jnn.Linear(3, 2, dtype=F32))


class TNet(torch.nn.Module):

    def __init__(self):
        super().__init__()
        self.fc = tnn.Linear(6, 4)
        self.bn = tnn.BatchNorm1d(4)
        self.conv = tnn.Conv2d(2, 3, 3, 1, 1)
        self.seq = torch.nn.Sequential(tnn.Linear(4, 3), tnn.ReLU(),
                                       tnn.Linear(3, 2))


def test_state_dict_round_trip_both_ways():
    """A JAX net with moved running statistics loads strictly into the
    port's twin, and the port's (other) weights load strictly back."""
    np.random.seed(12)
    jnet = JNet()
    jnet.bn(pdn.Tensor(draw((8, 4), 13, shift=2.0)))  # move the stats
    tnet = TNet()
    load_state_dict(tnet, jnet.state_dict())
    ours, theirs = state_dict(tnet), jnet.state_dict()
    assert set(ours) == set(theirs) and "seq.2.weight" in ours
    assert "bn.running_mean" in ours and "bn.running_var" in ours
    for name, value in theirs.items():
        np.testing.assert_array_equal(ours[name], value, err_msg=name)
    assert not np.allclose(ours["bn.running_mean"], 0)
    pdt.manual_seed(14)
    other = TNet()
    jnet.load_state_dict(state_dict(other))
    for name, value in state_dict(other).items():
        np.testing.assert_array_equal(jnet.state_dict()[name], value)


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape"])
def test_state_dict_strict_errors_match_jax(fault):
    np.random.seed(15)
    jnet, tnet = JNet(), TNet()
    state = jnet.state_dict()
    if fault == "missing":
        del state["bn.running_var"]
        err, match = KeyError, "missing"
    elif fault == "unexpected":
        state["head.weight"] = np.zeros((2, 2), F32)
        err, match = KeyError, "unexpected"
    else:
        state["fc.weight"] = np.zeros((4, 6), F32)
        err, match = ValueError, "shape mismatch"
    with pytest.raises(err, match=match):
        jnet.load_state_dict(state)
    with pytest.raises(err, match=match):
        load_state_dict(tnet, state)
    if fault != "shape":
        load_state_dict(tnet, state, strict=False)
        jnet.load_state_dict(state, strict=False)


@pytest.mark.parametrize("batch_size", [7, 10])
def test_data_loader_order_matches_jax(batch_size):
    X = np.arange(40, dtype=F32).reshape(20, 2)
    y = np.arange(20)
    batches = {}
    for name, make in (("jax", jax_data_loader), ("port", data_loader)):
        np.random.seed(16)
        loader = make(X, y, batch_size, shuffle=True)
        batches[name] = [b for _ in range(2) for b in loader]
    assert len(batches["port"]) == 2 * -(-20 // batch_size)
    for (xa, ya), (xb, yb) in zip(batches["port"], batches["jax"]):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def test_new_modules_import_no_jax():
    code = ("import sys\n"
            "import pydynet_tpu_torch.nn\n"
            "import pydynet_tpu_torch.data\n"
            "import pydynet_tpu_torch.random\n"
            "import pydynet_tpu_torch.ops.batchnorm\n"
            "import pydynet_tpu_torch.utils.checkpoint\n"
            "import pydynet_tpu_torch.examples.dropout_bn\n"
            "import pydynet_tpu_torch.examples.mnist\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'pydynet_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120, env=dict(os.environ, OMP_NUM_THREADS="1"))


def test_package_surface():
    for name in ("Linear", "Embedding", "Conv1d", "Conv2d", "BatchNorm1d",
                 "BatchNorm2d", "LayerNorm", "RMSNorm", "Dropout", "ReLU",
                 "MaxPool2d", "AvgPool1d", "MSELoss", "NLLLoss",
                 "CrossEntropyLoss", "init", "functional"):
        assert name in tnn.__all__ and hasattr(tnn, name)
    # the Module base and the containers are ported too: nothing is missing
    assert set(jnn.modules.__all__) - set(tnn.__all__) == set()
    assert callable(pdt.manual_seed)
    assert isinstance(pdt.default_generator, pdt.random.Generator)
