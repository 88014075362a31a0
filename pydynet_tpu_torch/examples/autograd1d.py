"""1-D gradient descent through the tape (counterpart of
``examples/pydynet/autograd1d.py``):

    python -m pydynet_tpu_torch.examples.autograd1d [--device cuda|cpu]
        [--plot out.png]

Minimizes f(x) = log((x-7)^2 + 6) from x = 1 with lr 1.5, once by
``Tensor.backward()`` and once by the hand-derived gradient, and compares
the two trajectories (float64). ``--device cuda`` is the default and raises
without a GPU. ``--plot`` saves the curve where matplotlib is installed.
"""
from __future__ import annotations

import argparse

import numpy as np

from .. import Tensor, log
from ..device import Device, resolve


def auto_grad(x0: float, lr: float, n_iter: int, device=None):
    """The trajectory by the tape, on ``device`` (a ``Device``)."""
    xs = [x0]
    x = Tensor(float(x0), requires_grad=True, device=device)
    for _ in range(n_iter):
        x.zero_grad()
        y = log((x - 7) ** 2 + 6)
        y.backward()
        with x.device:
            x.data -= lr * x.grad
        xs.append(x.item())
    return xs


def manual_grad(x: float, lr: float, n_iter: int):
    xs = [x]
    for _ in range(n_iter):
        x -= lr * 2 * (x - 7) / ((x - 7) ** 2 + 6)
        xs.append(x)
    return xs


def main(device=None, plot: str = None, n_iter: int = 20):
    """Run both descents; returns ``(trajectory, max |auto - manual|)``."""
    device = Device(resolve(device))
    x1 = np.array(auto_grad(1.0, 1.5, n_iter, device))
    x2 = np.array(manual_grad(1.0, 1.5, n_iter))
    err = np.abs(x1 - x2).max()
    print("autograd trajectory :", np.round(x1[-5:], 5))
    print("manual trajectory   :", np.round(x2[-5:], 5))
    print(f"max |auto - manual| = {err:.2e}")
    assert err < 1e-6
    if plot:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib is not installed: no plot")
        else:
            xg = np.linspace(0, 10, 101)
            plt.figure(figsize=(6, 3))
            plt.plot(xg, np.log((xg - 7) ** 2 + 6), lw=0.7)
            plt.scatter(x1, np.log((x1 - 7) ** 2 + 6), color="red",
                        marker="^")
            plt.title("Gradient descent by AutoGrad")
            plt.savefig(plot)
            print(f"saved {plot}")
    return x1, err


def cli(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--plot", default=None)
    args = parser.parse_args(argv)
    return main(args.device, args.plot)


if __name__ == "__main__":
    cli()
