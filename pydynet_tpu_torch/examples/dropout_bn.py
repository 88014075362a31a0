"""Dropout / BatchNorm comparison on face classification (counterpart of
``examples/pydynet/dropout_bn.py``):

    python -m pydynet_tpu_torch.examples.dropout_bn [--epochs 20]
        [--batch-size 40] [--device cuda|cpu] [--seed 42]

Three 4096-512-128-40 MLPs, plain, with dropout (p 0.05) and with two
``BatchNorm1d`` layers, train on the same batches with ONE backward over the
sum of their losses, then one Adam step each (lr 5e-5). On a GPU the
BatchNorm layers run the fused train-mode kernel (K8, ``ops/batchnorm.py``),
twice a step. ``--device cuda`` is the default and raises without a GPU.

The data is the JAX example's synthetic Olivetti-shaped set (400 faces of
4096 pixels, 40 classes, from ``default_rng(0)``), bit for bit: the JAX
example fetches the real faces through sklearn when it can, which needs the
network, and the port never fetches anything. The split and the batches
follow NumPy's global stream from ``--seed`` as there. PyTorch's TF32
settings are left as they are and printed.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
from torch import nn

from .. import manual_seed
from ..data import data_loader
from ..device import resolve
from ..nn import functional as F
from ..nn import BatchNorm1d, CrossEntropyLoss, Dropout, Linear
from ..optim import Adam

DTYPE = np.float32


def load_faces():
    """The JAX example's synthetic faces: (400, 4096) float32 in [0, 1] and
    their int64 classes, 10 a class."""
    rng = np.random.default_rng(0)
    protos = rng.uniform(0, 1, (40, 4096)).astype(DTYPE)
    y = np.repeat(np.arange(40), 10).astype(np.int64)
    X = protos[y] + 0.25 * rng.standard_normal((400, 4096)).astype(DTYPE)
    return np.clip(X, 0, 1), y


class DNN(nn.Module):

    def __init__(self) -> None:
        super().__init__()
        self.fc1 = Linear(4096, 512)
        self.fc2 = Linear(512, 128)
        self.fc3 = Linear(128, 40)

    def forward(self, x):
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.fc3(x)


class DNN_dropout(DNN):

    def __init__(self) -> None:
        super().__init__()
        self.dropout = Dropout(p=0.05)

    def forward(self, x):
        x = F.relu(self.dropout(self.fc1(x)))
        x = F.relu(self.dropout(self.fc2(x)))
        return self.fc3(x)


class DNN_BN(DNN):

    def __init__(self) -> None:
        super().__init__()
        self.bn1 = BatchNorm1d(512)
        self.bn2 = BatchNorm1d(128)

    def forward(self, x):
        x = F.relu(self.bn1(self.fc1(x)))
        x = F.relu(self.bn2(self.fc2(x)))
        return self.fc3(x)


def train_step(nets, optims, loss_fn, bx, by):
    """Each net's loss on the batch, ONE backward over their sum, then each
    optimizer's step. Returns the losses, detached, on the device."""
    losses = [loss_fn(net(bx), by) for net in nets]
    for opt in optims:
        opt.zero_grad()
    sum(losses).backward()
    for opt in optims:
        opt.step()
    return [loss.detach() for loss in losses]


@torch.no_grad()
def accuracies(nets, X, y):
    """Each net's test accuracy on (X, y), in eval mode."""
    for net in nets:
        net.eval()
    return [float((net(X).argmax(-1).cpu().numpy() == y).mean())
            for net in nets]


def train(epochs: int = 20, batch_size: int = 40, device=None,
          seed: int = 42):
    """Train the three nets. Returns ``(nets, losses, accs)``: the nets,
    each epoch's mean train losses of the three and the last epoch's test
    accuracies."""
    device = resolve(device)
    manual_seed(seed)  # NumPy's global stream too: the split and batches
    print(f"device {device}; TF32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32}")

    X, y = load_faces()
    cut = int(0.8 * len(X))
    perm = np.random.permutation(len(X))
    train_X, test_X = X[perm[:cut]], X[perm[cut:]]
    train_y, test_y = y[perm[:cut]], y[perm[cut:]]

    nets = [DNN().to(device), DNN_dropout().to(device), DNN_BN().to(device)]
    optims = [Adam(n.parameters(), lr=5e-5) for n in nets]
    loss_fn = CrossEntropyLoss()
    train_loader = data_loader(train_X, train_y, batch_size, True)
    test_Xd = torch.from_numpy(test_X).to(device)
    history, accs = [], None
    for epoch in range(epochs):
        for net in nets:
            net.train()
        total, n = torch.zeros(3, device=device), 0
        for bx, by in train_loader:
            ls = train_step(nets, optims, loss_fn,
                            torch.from_numpy(bx).to(device),
                            torch.from_numpy(by).to(device))
            total += torch.stack(ls)
            n += 1
        history.append((total / n).tolist())
        accs = accuracies(nets, test_Xd, test_y)
        print("epoch {:2d}: mean losses=({:.4f}, {:.4f}, {:.4f}) "
              "test_acc=(plain={:.3f}, dropout={:.3f}, bn={:.3f})".format(
                  epoch, *history[-1], *accs))
    return nets, history, accs


def main(epochs: int = 20, batch_size: int = 40, device=None,
         seed: int = 42):
    """Train and return the three test accuracies (plain, dropout, bn)."""
    return train(epochs, batch_size, device, seed)[2]


def cli(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--batch-size", type=int, default=40)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)
    return main(args.epochs, args.batch_size, args.device, args.seed)


if __name__ == "__main__":
    cli()
