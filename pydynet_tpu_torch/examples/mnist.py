"""MNIST classification with an MLP or a LeNet-style ConvNet (counterpart of
``examples/pydynet/mnist.py``):

    python -m pydynet_tpu_torch.examples.mnist [--network conv|mlp]
        [--epochs 20] [--batch-size 256] [--lr 1e-4] [--device cuda|cpu]
        [--seed 42] [--data DIR] [--synthetic]

The JAX example's flags, networks and per-epoch report; its ``--no-cuda``
is ``--device cpu`` here, and ``--device cuda`` (the default) raises without
a GPU. The MNIST gz files are read from ``--data`` when they are there;
otherwise, or with ``--synthetic``, the JAX example's synthetic MNIST-shaped
set (4096 train and 1024 test images from ``default_rng(0)``) is used. The
epoch's training data stays on the device and is permuted there by the
``np.random.permutation`` the JAX example draws each epoch, so the batches
are its batches. Adam, cross-entropy; PyTorch's TF32 settings are left as
they are and printed.
"""
from __future__ import annotations

import argparse
import gzip
import time
from os.path import exists, join

import numpy as np
import torch
from torch import nn

from .. import manual_seed
from ..device import resolve
from ..nn import functional as F
from ..nn import Conv2d, Linear
from ..optim import Adam

DTYPE = np.float32


class MNISTDataset:

    def __init__(self, root) -> None:
        self.root = root
        self.paths = {
            "train_x": join(root, "train-images-idx3-ubyte.gz"),
            "train_y": join(root, "train-labels-idx1-ubyte.gz"),
            "test_x": join(root, "t10k-images-idx3-ubyte.gz"),
            "test_y": join(root, "t10k-labels-idx1-ubyte.gz"),
        }

    def available(self):
        return all(exists(p) for p in self.paths.values())

    @staticmethod
    def _read_images(path):
        with gzip.open(path, "r") as f:
            f.read(16)
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return (data / 255.0).reshape(-1, 1, 28, 28)

    @staticmethod
    def _read_labels(path):
        with gzip.open(path, "r") as f:
            f.read(8)
            return np.frombuffer(f.read(), dtype=np.uint8).astype(np.int64)

    def load(self, split):
        return (self._read_images(self.paths[f"{split}_x"]),
                self._read_labels(self.paths[f"{split}_y"]))


def synthetic_mnist(n_train=4096, n_test=1024, seed=0):
    """Class-conditional gaussian blobs in image space, the JAX example's
    set bit for bit: ((x, y) train, (x, y) test), x float64 in [0, 1]."""
    rng = np.random.default_rng(seed)
    protos = rng.uniform(0, 1, size=(10, 1, 28, 28))

    def make(n):
        y = rng.integers(0, 10, n)
        x = protos[y] + 0.35 * rng.standard_normal((n, 1, 28, 28))
        return np.clip(x, 0, 1), y.astype(np.int64)

    return make(n_train), make(n_test)


class Flatten(nn.Module):

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class MLP(nn.Module):

    def __init__(self) -> None:
        super().__init__()
        self.layer1 = nn.Sequential(Flatten(), Linear(28 * 28, 1024))
        self.layer2 = Linear(1024, 1024)
        self.layer3 = Linear(1024, 10)

    def forward(self, x):
        z1 = F.relu(self.layer1(x))
        z2 = F.relu(self.layer2(z1))
        return self.layer3(z2)


class ConvNet(nn.Module):

    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(1, 20, 3, 1, 1)
        self.conv2 = Conv2d(20, 50, 3, 1, 1)
        self.fc1 = Linear(7 * 7 * 50, 500)
        self.fc2 = Linear(500, 10)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.conv2(x))
        x = F.max_pool2d(x, 2, 2)
        x = x.reshape(-1, 7 * 7 * 50)
        x = F.relu(self.fc1(x))
        return self.fc2(x)


def train_step(net, optimizer, bx, by):
    """One Adam step on a batch; returns the loss, detached, on the
    device."""
    loss = F.cross_entropy_loss(net(bx), by)
    optimizer.zero_grad()
    loss.backward()
    optimizer.step()
    return loss.detach()


def train_epoch(net, optimizer, X, y, batch_size: int):
    """One epoch over (X, y), already on the device and in the epoch's
    order: full batches, then the remainder. Returns (last loss, steps)."""
    net.train()
    loss, steps = None, 0
    for i in range(0, len(X), batch_size):
        loss = train_step(net, optimizer, X[i:i + batch_size],
                          y[i:i + batch_size])
        steps += 1
    return loss, steps


@torch.no_grad()
def accuracy(net, X, y, batch_size: int) -> float:
    """Test accuracy of ``net`` in eval mode over (X, y) on its device."""
    net.eval()
    right = sum((net(X[i:i + batch_size]).argmax(-1)
                 == y[i:i + batch_size]).sum()
                for i in range(0, len(X), batch_size))
    return int(right) / len(X)


def load_data(args):
    """((train_x, train_y), (test_x, test_y)) as float32 images and int64
    classes: the gz files when present and not ``--synthetic``."""
    dataset = MNISTDataset(args.data)
    if dataset.available() and not args.synthetic:
        train, test = dataset.load("train"), dataset.load("test")
    else:
        print("MNIST files not found -> synthetic MNIST-shaped data")
        train, test = synthetic_mnist()
    return [(x.astype(DTYPE), y) for x, y in (train, test)]


def main(argv=None) -> float:
    parser = argparse.ArgumentParser(description="MNIST MLP / ConvNet")
    parser.add_argument("--network", choices=["mlp", "conv"], default="conv")
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--test-batch-size", type=int, default=1024)
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--data", type=str,
                        default="./examples/data/MNIST/raw")
    parser.add_argument("--synthetic", action="store_true",
                        help="force the synthetic dataset")
    args = parser.parse_args(argv)

    device = resolve(args.device)
    manual_seed(args.seed)  # NumPy's global stream too: the epoch order
    net = {"mlp": MLP, "conv": ConvNet}[args.network]().to(device)
    print(net)
    print(f"device {device}; TF32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32}")
    optimizer = Adam(net.parameters(), lr=args.lr)
    (train_x, train_y), (test_x, test_y) = load_data(args)
    Xd, yd = (torch.from_numpy(a).to(device) for a in (train_x, train_y))
    Xt, yt = (torch.from_numpy(a).to(device) for a in (test_x, test_y))
    acc = None
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        perm = torch.from_numpy(np.random.permutation(len(train_x))).to(
            device)
        loss, steps = train_epoch(net, optimizer, Xd[perm], yd[perm],
                                  args.batch_size)
        loss = float(loss)  # waits for the epoch's last step
        train_time = time.perf_counter() - t0
        acc = accuracy(net, Xt, yt, args.test_batch_size)
        print("epoch {:2d}: loss={:.6f} test_acc={:.4f} "
              "({:.2f}s/epoch, {:.1f} steps/s)".format(
                  epoch, loss, acc, train_time, steps / train_time))
    return acc


if __name__ == "__main__":
    main()
