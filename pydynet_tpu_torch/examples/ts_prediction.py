"""GRU time-series prediction (counterpart of
``examples/pydynet/ts_prediction.py``):

    python -m pydynet_tpu_torch.examples.ts_prediction [--epochs 50]
        [--device cuda|cpu]

A GRU (1 -> 32, ``batch_first``) and a linear head predict the next value
of ``sin(pi t) + cos(2 pi t) / 2``, sampled every 0.05 over [0, 100), from
its previous ``TIME_STEP`` (40) values. The windows are split 80/20 by
``default_rng(42)``; each epoch is one full-batch Adam step (lr 0.01) on
``MSELoss`` and one test loss, both through ``jit`` (``jtrain`` and
``jeval``, one a mode), so on the card an epoch's step is one CUDA-graph
replay with the 40 time steps and their backward inside it. ``--device
cuda`` (the default) raises without a GPU.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
from torch import nn

from .. import manual_seed
from ..device import resolve
from ..jit import jit
from ..nn import GRU, Linear, MSELoss
from ..optim import Adam
from ..nn.modules.module import Module

TIME_STEP = 40
INPUT_SIZE = 1
H_SIZE = 32
EPOCHS = 50


def windowize(y, input_len, horizon=1, stride=1, step=1):
    """The (N, input_len, 1) windows of ``y`` and the (N, horizon) values
    after each, float32 tensors."""
    y = np.asarray(y)
    max_i = len(y) - (input_len + horizon) * step + step
    idx_inputs, idx_targets = [], []
    for i in range(0, max_i, stride):
        idx_inputs.append(i + np.arange(0, input_len * step, step))
        idx_targets.append(i + input_len * step +
                           np.arange(0, horizon * step, step))
    X = y[np.array(idx_inputs)]
    Y = y[np.array(idx_targets)]
    return (torch.from_numpy(X[..., np.newaxis].astype(np.float32)),
            torch.from_numpy(Y.astype(np.float32)))


def f(t):
    return np.sin(np.pi * t) + 0.5 * np.cos(2 * np.pi * t)


class RNN(Module):

    def __init__(self):
        super().__init__()
        self.rnn = GRU(input_size=INPUT_SIZE, hidden_size=H_SIZE,
                       num_layers=1, batch_first=True)
        self.out = Linear(H_SIZE, 1)

    def forward(self, x, h_state=None):
        _, h_state = self.rnn(x, h_state)
        return self.out(h_state[:, self.rnn.num_layers - 1, :])


def train_test_split(X, y, test_size=0.2, seed=42):
    n = len(X)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    cut = int(n * (1 - test_size))
    tr, te = torch.from_numpy(perm[:cut]), torch.from_numpy(perm[cut:])
    return X[tr], X[te], y[tr], y[te]


def data():
    """(X_train, X_test, Y_train, Y_test) of the example's signal."""
    X, Y = windowize(f(np.arange(0, 100, .05)), input_len=TIME_STEP)
    return train_test_split(X, Y)


def train_step(model, optimizer, criterion, bx, by):
    """One Adam step on (bx, by); returns the loss."""
    loss = criterion(model(bx), by)
    optimizer.zero_grad()
    loss.backward()
    optimizer.step()
    return loss


def eval_step(model, criterion, bx, by):
    return criterion(model(bx), by)


def steps(model, optimizer, criterion=None):
    """``(jtrain, jeval)``: the train and eval steps of ``model`` through
    ``jit``."""
    criterion = criterion or MSELoss()
    jtrain = jit(lambda bx, by: train_step(model, optimizer, criterion, bx,
                                           by), state=(model, optimizer))
    jeval = jit(lambda bx, by: eval_step(model, criterion, bx, by),
                state=(model,))
    return jtrain, jeval


def main(epochs: int = EPOCHS, device=None) -> float:
    """Train ``epochs`` epochs; returns the final test loss."""
    device = resolve(device)
    manual_seed(0)
    X_train, X_test, Y_train, Y_test = (t.to(device) for t in data())
    rnn = RNN().to(device)
    optimizer = Adam(rnn.parameters(), lr=0.01)
    jtrain, jeval = steps(rnn, optimizer)

    first_loss = None
    for step in range(epochs):
        rnn.train()
        train_loss = jtrain(X_train, Y_train)
        if first_loss is None:
            first_loss = float(train_loss)
        rnn.eval()
        with torch.no_grad():
            test_loss = jeval(X_test, Y_test)
        if step % 10 == 0 or step == epochs - 1:
            print(f"epoch {step:3d}: train={float(train_loss):.5f} "
                  f"test={float(test_loss):.5f}")

    final = float(test_loss)
    print(f"loss {first_loss:.4f} -> {final:.4f}")
    assert final < first_loss
    return final


def cli(argv=None) -> float:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--epochs", type=int, default=EPOCHS)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)
    return main(args.epochs, args.device)


if __name__ == "__main__":
    cli()
