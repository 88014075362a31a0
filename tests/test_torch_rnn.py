"""The port's recurrent layers (``pydynet_tpu_torch/nn/modules/rnn.py``)
against the JAX package's, on the CPU: the cases of ``tests/test_rnn.py``.

Each JAX layer is built from a NumPy seed and its weights carried into the
port's twin by ``utils/checkpoint.load_state_dict``; both run the same
seeded input. Outputs, ``hn`` and ``cn`` are held within 1e-5 in float32
(the two sum the products in other orders, over a few steps of O(1)
values) and 1e-12 in float64; the gradients of the input and of every
weight within 1e-10 in float64.
"""
import numpy as np
import pytest
import torch

import pydynet_tpu as pdn
from pydynet_tpu import nn as jnn

from pydynet_tpu_torch import nn as tnn
from pydynet_tpu_torch.utils.checkpoint import load_state_dict

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

L, B, I, H = 5, 3, 4, 6
ATOL = {np.float32: 1e-5, np.float64: 1e-12}
KINDS = ("RNN", "LSTM", "GRU")
LAYOUTS = {  # name -> (num_layers, bidirectional, batch_first, input shape)
    "1-layer": (1, False, False, (L, B, I)),
    "2-layer": (2, False, False, (L, B, I)),
    "bidirectional": (1, True, False, (L, B, I)),
    "2-layer-bidirectional": (2, True, False, (L, B, I)),
    "batch_first": (2, False, True, (B, L, I)),
    "batch_first-bidirectional": (1, True, True, (B, L, I)),
    "unbatched": (2, True, False, (L, I)),
}


def twins(kind, dtype, seed=0, **kw):
    np.random.seed(seed)
    jnet = getattr(jnn, kind)(I, H, dtype=dtype, **kw)
    tnet = getattr(tnn, kind)(I, H, dtype=torch.from_numpy(
        np.zeros(1, dtype)).dtype, **kw)
    load_state_dict(tnet, jnet.state_dict())
    return jnet, tnet


def outputs(out):
    """(output, hn) or (output, (hn, cn)) as a flat list."""
    o, state = out
    return [o] + (list(state) if isinstance(state, tuple) else [state])


def as_np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.numpy())


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_forward_matches_jax(kind, layout, dtype):
    num_layers, bidir, batch_first, shape = LAYOUTS[layout]
    jnet, tnet = twins(kind, dtype, num_layers=num_layers,
                       bidirectional=bidir, batch_first=batch_first)
    x = np.random.default_rng(1).standard_normal(shape).astype(dtype)
    with pdn.no_grad():
        want = outputs(jnet(pdn.Tensor(x)))
    with torch.no_grad():
        got = outputs(tnet(torch.from_numpy(x)))
    assert len(got) == len(want) == (3 if kind == "LSTM" else 2)
    for g, w in zip(got, want):
        assert g.shape == tuple(w.shape)
        np.testing.assert_allclose(as_np(g), as_np(w), rtol=0,
                                   atol=ATOL[dtype])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("layout", ["2-layer-bidirectional", "batch_first"])
def test_gradients_match_jax_f64(kind, layout):
    """d/dx and d/dW of sum(out^2) + sum(hn) (+ sum(cn)), with a given
    initial state."""
    num_layers, bidir, batch_first, shape = LAYOUTS[layout]
    jnet, tnet = twins(kind, np.float64, num_layers=num_layers,
                       bidirectional=bidir, batch_first=batch_first)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape)
    h0 = rng.standard_normal(((2 if bidir else 1) * num_layers, B, H))
    jx = pdn.Tensor(x, requires_grad=True)
    tx = torch.from_numpy(x).requires_grad_()
    jh, th = pdn.Tensor(h0), torch.from_numpy(h0)
    if kind == "LSTM":
        jout = outputs(jnet(jx, (jh, pdn.Tensor(-h0))))
        tout = outputs(tnet(tx, (th, torch.from_numpy(-h0))))
    else:
        jout, tout = outputs(jnet(jx, jh)), outputs(tnet(tx, th))
    jloss = (jout[0] * jout[0]).sum()
    tloss = (tout[0] * tout[0]).sum()
    for j, t in zip(jout[1:], tout[1:]):
        jloss, tloss = jloss + j.sum(), tloss + t.sum()
    jloss.backward()
    tloss.backward()
    np.testing.assert_allclose(float(tloss), float(jloss.item()),
                               rtol=1e-12)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad),
                               rtol=0, atol=1e-10)
    jgrads = dict(jnet.named_parameters())
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(jgrads[name].grad), rtol=0,
                                   atol=1e-10, err_msg=name)


@pytest.mark.parametrize("kind", ["RNNCell", "LSTMCell", "GRUCell"])
def test_cells_match_jax(kind):
    """A cell's standalone step, batched and unbatched, from zeros and
    from a given state, float64."""
    np.random.seed(3)
    jcell = getattr(jnn, kind)(I, H)
    tcell = getattr(tnn, kind)(I, H, dtype=torch.float64)
    load_state_dict(tcell, jcell.state_dict())
    rng = np.random.default_rng(4)
    for shape in ((B, I), (I,)):
        x = rng.standard_normal(shape)
        h = rng.standard_normal(shape[:-1] + (H,))
        with pdn.no_grad():
            if kind == "LSTMCell":
                want = list(jcell(pdn.Tensor(x))) + list(
                    jcell(pdn.Tensor(x), (pdn.Tensor(h), pdn.Tensor(h))))
            else:
                want = [jcell(pdn.Tensor(x)), jcell(pdn.Tensor(x),
                                                    pdn.Tensor(h))]
        with torch.no_grad():
            tx, th = torch.from_numpy(x), torch.from_numpy(h)
            if kind == "LSTMCell":
                got = list(tcell(tx)) + list(tcell(tx, (th, th)))
            else:
                got = [tcell(tx), tcell(tx, th)]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), as_np(w), rtol=0,
                                       atol=1e-12)


@pytest.mark.parametrize("kind", KINDS)
def test_state_dict_names_equal_the_jax_modules(kind):
    for kw in ({}, dict(num_layers=2, bidirectional=True),
               dict(bias=False)):
        jnet, tnet = twins(kind, np.float32, **kw)
        assert list(tnet.state_dict()) == list(jnet.state_dict())
        for name, t in tnet.state_dict().items():
            assert tuple(t.shape) == tuple(jnet.state_dict()[name].shape)


def test_rnn_positional_order_and_repr():
    """(in, hidden, num_layers, nonlinearity, bias, ...), as the JAX
    package's; relu runs relu; the repr is the JAX package's."""
    rnn = tnn.RNN(4, 8, 2, "relu")
    assert rnn.nonlinearity == "relu" and rnn.has_bias
    assert all(c.nonlinearity == "relu" for c in rnn.cells)
    rnn2 = tnn.RNN(4, 8, 2, "relu", False)
    assert rnn2.nonlinearity == "relu" and not rnn2.has_bias
    assert rnn2.rnn_0.bias is None
    assert repr(rnn2) == repr(jnn.RNN(4, 8, 2, "relu", False))
    assert repr(tnn.GRU(4, 8)) == repr(jnn.GRU(4, 8))
    jnet, tnet = twins("RNN", np.float64, num_layers=2)
    tnet.rnn_0.nonlinearity = tnet.rnn_1.nonlinearity = "relu"
    jnet = jnn.RNN(I, H, 2, "relu")
    load_state_dict(tnet, jnet.state_dict())
    x = np.random.default_rng(5).standard_normal((L, B, I))
    with pdn.no_grad():
        want = jnet(pdn.Tensor(x))[0].numpy()
    with torch.no_grad():
        got = tnet(torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_sequence_layers_reject_malformed_state():
    x = torch.randn(5, 3, 4)
    with pytest.raises(AssertionError, match="Wrong hidden state input!"):
        tnn.RNN(4, 8)(x, torch.randn(1, 8))
    with pytest.raises(AssertionError, match="Wrong hidden state input!"):
        tnn.GRU(4, 8, bidirectional=True)(x, torch.randn(1, 3, 8))
    with pytest.raises(AssertionError, match="Wrong cell state input!"):
        tnn.LSTM(4, 8)(x, (torch.randn(1, 3, 8), torch.randn(1, 8)))
    with pytest.raises(AssertionError, match="Wrong hidden state input!"):
        tnn.RNNCell(4, 8)(torch.randn(3, 4), torch.randn(8))


def test_saturated_gates_give_finite_gradients():
    """Every bias at -100 drives every gate to 0 in float32: the gradients
    stay finite."""
    for cls in (tnn.LSTM, tnn.GRU):
        net = cls(4, 4)
        with torch.no_grad():
            for name, p in net.named_parameters():
                if "bias" in name:
                    p.fill_(-100.0)
        x = torch.randn(3, 2, 4, requires_grad=True)
        net(x)[0].sum().backward()
        for name, p in net.named_parameters():
            assert torch.isfinite(p.grad).all(), (cls.__name__, name)
        assert torch.isfinite(x.grad).all(), cls.__name__


def test_init_and_reset_parameters():
    """uniform(-1/sqrt(H), 1/sqrt(H)) from the port's init generator, and
    the JAX package's misspelt alias."""
    import pydynet_tpu_torch as pdt

    pdt.manual_seed(7)
    a = tnn.GRU(4, 16, num_layers=2)
    pdt.manual_seed(7)
    b = tnn.GRU(4, 16, num_layers=2)
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
        assert float(p.abs().max()) <= 0.25
    before = [p.clone() for p in a.parameters()]
    a.reset_paramters()
    assert not any(torch.equal(p, q) for p, q in zip(before,
                                                     a.parameters()))
