"""2-D gradient descent through the tape and the jit (counterpart of
``examples/pydynet/autograd2d.py``):

    python -m pydynet_tpu_torch.examples.autograd2d [--device cuda|cpu]

Minimizes the bowl f(x, y) = (x-3)^2 + 2(y+1)^2 from (-4, 4) with lr 0.1.
The update step (``w.zero_grad()``, ``loss.backward()``,
``w.data -= lr * w.grad``) goes through ``jit``: on the card its second call
captures one CUDA graph and every later step replays it. ``--device cuda``
is the default and raises without a GPU.
"""
from __future__ import annotations

import argparse

import numpy as np

from .. import Tensor
from ..device import Device, resolve
from ..jit import jit


def build(lr: float = 0.1, device=None):
    """``(w, jstep)``: the point and its jitted update step, on ``device``
    (a ``Device``)."""
    w = Tensor(np.array([-4.0, 4.0]), requires_grad=True, device=device)
    target = Tensor(np.array([3.0, -1.0]), device=device)
    coef = Tensor(np.array([1.0, 2.0]), device=device)

    def step():
        w.zero_grad()
        loss = (coef * (w - target) ** 2).sum()
        loss.backward()
        w.data -= lr * w.grad
        return loss

    return w, jit(step, state=[w])


def main(n_iter: int = 60, lr: float = 0.1, device=None):
    """Descend ``n_iter`` steps; returns the (n_iter + 1, 2) trajectory."""
    w, jstep = build(lr, Device(resolve(device)))
    trajectory = [w.numpy()]
    for _ in range(n_iter):
        loss = jstep()
        trajectory.append(w.numpy())

    print("final point:", np.round(w.numpy(), 5), "loss:",
          float(loss.item()))
    assert np.allclose(w.numpy(), [3.0, -1.0], atol=1e-3)
    return np.array(trajectory)


def cli(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)
    return main(device=args.device)


if __name__ == "__main__":
    cli()
