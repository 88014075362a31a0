"""Recurrent layers (counterparts of ``pydynet_tpu/nn/modules/rnn.py``):
``RNNCell``, ``LSTMCell``, ``GRUCell`` and the sequence layers ``RNN``,
``LSTM`` and ``GRU``.

The JAX package's contract, which is not PyTorch's (``torch.nn.GRU``,
``torch.nn.LSTM`` and cuDNN compute other functions and are not used):

* weights are (in, k H), multiplied from the right, named ``Wx``, ``Wh``
  and ``bias`` (the GRU's ``Wx1``, ``Wh1``, ``Wx2``, ``Wh2``, ``bias1`` and
  ``bias2``), and a sequence layer's cells are its children ``rnn_i``,
  ``lstm_i``, ``gru_i`` and, for the reverse direction, ``rrnn_i``,
  ``rlstm_i`` and ``rgru_i``, so the JAX state-dict names load as they are
  (``utils/checkpoint.load_state_dict``);
* the LSTM's fused 4H projection splits into f, i, o, g in that order; the
  GRU takes a 2H (z, r) projection, then the candidate ``tanh(x Wx2 + (r *
  h) Wh2 + b2)`` and ``(1 - z) h + z candidate``;
* the two directions of a bidirectional layer are independent chains, so
  its deeper layers take ``hidden_size`` inputs, not 2H;
* ``batch_first`` swaps ``hn`` (and ``cn``) too; an unbatched (L, in)
  input is taken; ``RNN``'s positional order is ``(input_size,
  hidden_size, num_layers, nonlinearity, bias, ...)``; a malformed state
  raises ``AssertionError("Wrong hidden state input!")`` (``cell`` for the
  LSTM's c); init is uniform in +-1/sqrt(H) from ``nn.init``.

The gates use ``torch.sigmoid``, whose gradient stays finite at a
saturated gate. Time is a plain Python loop over the cell's step; the
reverse direction runs the same loop backwards and keeps its outputs in the
original order. Under ``jit`` on a GPU the whole loop, forward and
backward, is one captured graph.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .. import init
from .module import Module


def _rnn_step(x, h, Wx, Wh, b, nonlinearity):
    lin = x @ Wx + h @ Wh
    if b is not None:
        lin = lin + b
    return torch.tanh(lin) if nonlinearity == "tanh" else lin.clamp_min(0.0)


def _lstm_step(x, h, c, Wx, Wh, b, H):
    lin = x @ Wx + h @ Wh
    if b is not None:
        lin = lin + b
    sig = torch.sigmoid(lin[..., :3 * H])
    f, i, o = sig[..., :H], sig[..., H:2 * H], sig[..., 2 * H:]
    c = f * c + i * torch.tanh(lin[..., 3 * H:])
    return o * torch.tanh(c), c


def _gru_step(x, h, Wx1, Wh1, Wx2, Wh2, b1, b2, H):
    lin1 = x @ Wx1 + h @ Wh1
    if b1 is not None:
        lin1 = lin1 + b1
    zr = torch.sigmoid(lin1)
    z, r = zr[..., :H], zr[..., H:]
    lin2 = x @ Wx2 + (r * h) @ Wh2
    if b2 is not None:
        lin2 = lin2 + b2
    return (1 - z) * h + z * torch.tanh(lin2)


class _Cell(Module):
    """Weights made empty on ``device``, each filled uniform in
    +-1/sqrt(hidden_size), in the order of ``_weights``."""

    _weights: tuple = ()  # (name, columns as a multiple of hidden_size)
    _biases: tuple = ()

    def __init__(self, input_size: int, hidden_size: int, bias: bool,
                 device, dtype) -> None:
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.has_bias = bias
        kw = dict(device=device, dtype=dtype)
        for name, k in self._weights:
            rows = input_size if name.startswith("Wx") else hidden_size
            setattr(self, name, nn.Parameter(
                torch.empty((rows, k * hidden_size), **kw)))
        for name, k in self._biases:
            setattr(self, name, nn.Parameter(
                torch.empty(k * hidden_size, **kw)) if bias else None)
        self.reset_parameters()

    def reset_parameters(self):
        bound = math.sqrt(1 / self.hidden_size)
        for name, _ in self._weights + (self._biases if self.has_bias
                                        else ()):
            init.uniform_(getattr(self, name), -bound, bound)

    reset_paramters = reset_parameters  # the JAX package's spelling

    def init_hidden(self, x):
        assert x.dim() in {1, 2}
        shape = (self.hidden_size,) if x.dim() == 1 \
            else (x.shape[0], self.hidden_size)
        w = getattr(self, self._weights[0][0])
        return torch.zeros(shape, dtype=w.dtype, device=w.device)

    def __repr__(self) -> str:
        return "{}({}, {}, bias={})".format(type(self).__name__,
                                            self.input_size,
                                            self.hidden_size, self.has_bias)


class RNNCell(_Cell):
    _weights = (("Wx", 1), ("Wh", 1))
    _biases = (("bias", 1),)

    def __init__(self, input_size: int, hidden_size: int, bias: bool = True,
                 nonlinearity: str = "tanh", device=None, dtype=None) -> None:
        if nonlinearity not in ("tanh", "relu"):
            raise ValueError(f"nonlinearity must be tanh or relu, got "
                             f"{nonlinearity!r}")
        self.nonlinearity = nonlinearity
        super().__init__(input_size, hidden_size, bias, device, dtype)

    def step(self, x, h):
        return _rnn_step(x, h, self.Wx, self.Wh, self.bias,
                         self.nonlinearity)

    def forward(self, x, h=None):
        if h is None:
            h = self.init_hidden(x)
        else:
            assert (x.dim() == 1 and tuple(h.shape) == (self.hidden_size,)) \
                or (x.dim() == 2 and tuple(h.shape) == (x.shape[0],
                                                        self.hidden_size)), \
                "Wrong hidden state input!"
        return self.step(x, h)

    def __repr__(self) -> str:
        return "{}({}, {}, bias={}, nonlinearity={})".format(
            type(self).__name__, self.input_size, self.hidden_size,
            self.has_bias, self.nonlinearity)


class LSTMCell(_Cell):
    _weights = (("Wx", 4), ("Wh", 4))
    _biases = (("bias", 4),)

    def __init__(self, input_size: int, hidden_size: int, bias: bool = True,
                 device=None, dtype=None) -> None:
        super().__init__(input_size, hidden_size, bias, device, dtype)

    def step(self, x, hc):
        return _lstm_step(x, hc[0], hc[1], self.Wx, self.Wh, self.bias,
                          self.hidden_size)

    def forward(self, x, hx=None):
        if hx is None:
            hx = (self.init_hidden(x), self.init_hidden(x))
        return self.step(x, hx)


class GRUCell(_Cell):
    _weights = (("Wx1", 2), ("Wh1", 2), ("Wx2", 1), ("Wh2", 1))
    _biases = (("bias1", 2), ("bias2", 1))

    def __init__(self, input_size: int, hidden_size: int, bias: bool = True,
                 device=None, dtype=None) -> None:
        super().__init__(input_size, hidden_size, bias, device, dtype)

    def step(self, x, h):
        return _gru_step(x, h, self.Wx1, self.Wh1, self.Wx2, self.Wh2,
                         self.bias1, self.bias2, self.hidden_size)

    def forward(self, x, h=None):
        if h is None:
            h = self.init_hidden(x)
        return self.step(x, h)


def _run(cell, x, state, reverse: bool):
    """One (layer, direction): the cell's step over x's leading time axis,
    backwards for ``reverse``. Returns the outputs (h at each step, in the
    original order, stacked) and the last state."""
    ys = [None] * x.shape[0]
    steps = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
    for t in steps:
        state = cell.step(x[t], state)
        ys[t] = state[0] if isinstance(state, tuple) else state
    return torch.stack(ys), state


class _RNNBase(Module):
    _cell_cls = None
    _prefix = None

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bias: bool = True, batch_first: bool = False,
                 bidirectional: bool = False, device=None, dtype=None,
                 **cell_kwargs) -> None:
        super().__init__()
        assert num_layers > 0
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.has_bias = bias
        self.batch_first = batch_first
        self.bidirectional = bidirectional
        # the directions are independent chains: a deeper layer's input is
        # its own direction's hidden state
        in_sizes = [input_size] + [hidden_size] * (num_layers - 1)
        kw = dict(cell_kwargs, device=device, dtype=dtype)
        self.cells = []
        self.rcells = []
        for prefix, cells in (("", self.cells), ("r", self.rcells)):
            if prefix and not bidirectional:
                break
            for i in range(num_layers):
                cell = self._cell_cls(in_sizes[i], hidden_size, bias, **kw)
                setattr(self, f"{prefix}{self._prefix}_{i}", cell)
                cells.append(cell)

    def reset_parameters(self):
        for cell in self.cells + self.rcells:
            cell.reset_parameters()

    reset_paramters = reset_parameters

    def init_hidden(self, x):
        assert x.dim() in {2, 3}
        d = 2 if self.bidirectional else 1
        shape = (d * self.num_layers,) + tuple(x.shape[1:-1]) \
            + (self.hidden_size,)
        w = next(self.cells[0].parameters())
        return torch.zeros(shape, dtype=w.dtype, device=w.device)

    def _check_state(self, x, h, what: str = "hidden"):
        d = 2 if self.bidirectional else 1
        want = (d * self.num_layers,) + tuple(x.shape[1:-1]) \
            + (self.hidden_size,)
        assert tuple(h.shape) == want, f"Wrong {what} state input!"

    def _layers(self, x, states):
        """Every layer of both directions from ``states[i]`` (forward
        layer i) and ``states[i + num_layers]`` (reverse). Returns the
        output and the last states in that order."""
        last, rlast = [], []
        xf = xr = x
        for i in range(self.num_layers):
            xf, s = _run(self.cells[i], xf, states[i], False)
            last.append(s)
            if self.bidirectional:
                xr, s = _run(self.rcells[i], xr, states[i + self.num_layers],
                             True)
                rlast.append(s)
        out = torch.cat([xf, xr], dim=-1) if self.bidirectional else xf
        return out, last + rlast

    def __repr__(self) -> str:
        return ("{}({}, {}, num_layers={}, bias={}, batch_first={}, "
                "bidirectional={})").format(type(self).__name__,
                                            self.input_size, self.hidden_size,
                                            self.num_layers, self.has_bias,
                                            self.batch_first,
                                            self.bidirectional)


class _SingleState(_RNNBase):
    """RNN and GRU: one state tensor h."""

    def forward(self, x, h=None):
        batched_first = self.batch_first and x.dim() == 3
        if batched_first:
            x = x.transpose(0, 1)
        if h is None:
            h = self.init_hidden(x)
        else:
            self._check_state(x, h)
        out, last = self._layers(x, [h[i] for i in range(h.shape[0])])
        hn = torch.stack(last)
        if batched_first:  # the JAX package swaps hn too
            out, hn = out.transpose(0, 1), hn.transpose(0, 1)
        return out, hn


class RNN(_SingleState):
    _cell_cls = RNNCell
    _prefix = "rnn"

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, nonlinearity: str = "tanh",
                 bias: bool = True, batch_first: bool = False,
                 bidirectional: bool = False, device=None,
                 dtype=None) -> None:
        self.nonlinearity = nonlinearity
        super().__init__(input_size, hidden_size, num_layers, bias,
                         batch_first, bidirectional, device, dtype,
                         nonlinearity=nonlinearity)

    def __repr__(self) -> str:
        return ("{}({}, {}, num_layers={}, nonlinearity={}, bias={}, "
                "batch_first={}, bidirectional={})").format(
                    type(self).__name__, self.input_size, self.hidden_size,
                    self.num_layers, self.nonlinearity, self.has_bias,
                    self.batch_first, self.bidirectional)


class GRU(_SingleState):
    _cell_cls = GRUCell
    _prefix = "gru"


class LSTM(_RNNBase):
    _cell_cls = LSTMCell
    _prefix = "lstm"

    def forward(self, x, hx=None):
        batched_first = self.batch_first and x.dim() == 3
        if batched_first:
            x = x.transpose(0, 1)
        if hx is None:
            h = c = self.init_hidden(x)
        else:
            h, c = hx
            self._check_state(x, h)
            self._check_state(x, c, "cell")
        out, last = self._layers(x, [(h[i], c[i])
                                     for i in range(h.shape[0])])
        hn = torch.stack([s[0] for s in last])
        cn = torch.stack([s[1] for s in last])
        if batched_first:
            out, hn, cn = (t.transpose(0, 1) for t in (out, hn, cn))
        return out, (hn, cn)
