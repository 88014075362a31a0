"""Transformer text classification on CoLA (counterpart of
``examples/pydynet/transformer.py``):

    python -m pydynet_tpu_torch.examples.transformer [--epochs 10]
        [--lr 5e-4] [--batch-size 128] [--data DIR] [--samples 2048]
        [--device cuda|cpu]

A 1-layer encoder (dim 512, 4 heads, ``forward_expansion`` 2) over word
embeddings plus a fixed sinusoidal position table, self-attention with an
additive -1e9 mask at padding, and a tanh score on the first position
against +-1 labels with squared error; Adam. The attention is plain
products and a softmax, as in the JAX example (not
``scaled_dot_product_attention``, whose rounding differs), and LayerNorm is
the JAX package's (``nn.LayerNorm``).

CoLA's ``in_domain_train.tsv`` is read from ``--data`` when it is there;
otherwise the JAX example's synthetic CoLA-shaped set (``--samples``
sentences from ``default_rng(0)``) is used, bit for bit. Nothing is
fetched. On the card the training split stays on the device: each epoch is
permuted there, its full batches go through ``jtrain.foreach`` and a
trailing partial batch through one more call, each step a CUDA-graph
replay. On the CPU the batches come from ``data_loader``. ``--device
cuda`` (the default) raises without a GPU.
"""
from __future__ import annotations

import argparse
import time
from os.path import exists, join

import numpy as np
import torch
from torch import nn

from .. import manual_seed
from ..data import data_loader
from ..device import resolve
from ..jit import jit
from ..nn import Embedding, LayerNorm, Linear, ReLU
from ..optim import Adam
from ..nn.modules.module import Module, ModuleList, Sequential

DTYPE = torch.float32


def load_cola(path):
    """CoLA's tokenized training split at ``path``: (ids (N, L) int64, 0
    padding; labels (N,)), or None without the file."""
    tsv = join(path, "in_domain_train.tsv")
    if not exists(tsv):
        return None
    with open(tsv, "r", encoding="utf-8") as f:
        lines = f.readlines()
    sens, ys, vocab, max_len = [], [], {}, 0
    for line in lines:
        parts = line.split("\t")
        y = int(parts[1])
        words = parts[-1][:-1].split()
        for w in words:
            vocab.setdefault(w, len(vocab) + 1)
        max_len = max(max_len, len(words))
        sens.append(words)
        ys.append(y)
    X = np.zeros((len(lines), max_len), dtype=np.int64)
    for i, words in enumerate(sens):
        for j, w in enumerate(words):
            X[i, j] = vocab[w]
    return X, np.array(ys)


def synthetic_cola(n=2048, vocab=1000, max_len=45, seed=0):
    """Label = whether the sequence contains any token from a 'good' set
    among its first four."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(4, max_len, n)
    X = np.zeros((n, max_len), dtype=np.int64)
    y = np.zeros(n, dtype=np.int64)
    good = set(range(1, vocab, 7))
    for i, L in enumerate(lengths):
        row = rng.integers(1, vocab, L)
        X[i, :L] = row
        y[i] = int(any(int(t) in good for t in row[:4]))
    return X, y


def sinusoidal_positional_encoding(max_len: int, d_model: int):
    position = np.arange(max_len)[:, np.newaxis]
    div_term = np.exp(np.arange(0, d_model, 2) * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return torch.from_numpy(pe.astype(np.float32))


@torch.no_grad()
def construct_mask(x, padding_idx=0):
    """(B, L) ids -> additive (B, 1, 1, L) float32 mask, -1e9 at
    padding."""
    return (x == padding_idx)[:, None, None, :].to(DTYPE) * -1e9


class SelfAttention(Module):

    def __init__(self, embed_size, heads):
        super().__init__()
        self.embed_size = embed_size
        self.heads = heads
        self.head_dim = embed_size // heads
        assert self.head_dim * heads == embed_size
        for name in "QKVO":
            setattr(self, name, Linear(embed_size, embed_size, bias=False))

    def forward(self, values, keys, query, mask):
        N, L, _ = query.shape
        shape = (N, L, self.heads, self.head_dim)
        q = self.Q(query).reshape(shape)
        k = self.K(keys).reshape(shape)
        v = self.V(values).reshape(shape)
        s = torch.einsum("blhd,bmhd->bhlm", q, k) * (1.0 / self.head_dim**0.5)
        p = torch.softmax(s + mask, dim=-1)
        out = torch.einsum("bhlm,bmhd->blhd", p, v)
        return self.O(out.reshape(N, L, -1))


class TransformerBlock(Module):

    def __init__(self, embed_size, heads, dropout, forward_expansion):
        super().__init__()
        self.attention = SelfAttention(embed_size, heads)
        self.norm1 = LayerNorm(embed_size)
        self.norm2 = LayerNorm(embed_size)
        self.feed_forward = Sequential(
            Linear(embed_size, forward_expansion * embed_size),
            ReLU(),
            Linear(forward_expansion * embed_size, embed_size),
        )

    def forward(self, value, key, query, mask):
        attention = self.attention(value, key, query, mask)
        x = self.norm1(attention + query)
        return self.norm2(self.feed_forward(x) + x)


class Transformer(Module):

    def __init__(self, embed_size, num_layers, heads, forward_expansion,
                 dropout, vocab_size, max_length):
        super().__init__()
        self.embed_size = embed_size
        self.word_embedding = Embedding(vocab_size, embed_size, padding_idx=0)
        self.position_embedding = nn.Parameter(
            sinusoidal_positional_encoding(max_length, embed_size),
            requires_grad=False)
        self.layers = ModuleList([
            TransformerBlock(embed_size, heads, dropout, forward_expansion)
            for _ in range(num_layers)
        ])
        self.fc_out = Linear(embed_size, 1)

    def forward(self, x, mask):
        out = self.word_embedding(x) + self.position_embedding
        for layer in self.layers:
            out = layer(out, out, out, mask)
        return self.fc_out(out[:, 0, :])


def build(vocab_size: int, max_length: int, lr: float, device):
    """The example's net (dim 512, 1 layer, 4 heads, expansion 2) on
    ``device`` and its Adam over the trainable parameters."""
    net = Transformer(embed_size=512, num_layers=1, heads=4,
                      forward_expansion=2, dropout=0.0,
                      vocab_size=vocab_size, max_length=max_length).to(device)
    return net, Adam([p for p in net.parameters() if p.requires_grad], lr=lr)


def train_step(net, optimizer, bx, by):
    """One Adam step on ids ``bx`` and +-1 labels ``by``; returns the
    loss. The padding mask is built inside the step."""
    score = torch.tanh(net(bx, construct_mask(bx))).reshape(-1)
    loss = torch.mean(torch.square(score - by))
    optimizer.zero_grad()
    loss.backward()
    optimizer.step()
    return loss


def eval_step(net, bx):
    return torch.tanh(net(bx, construct_mask(bx))).reshape(-1)


def steps(net, optimizer):
    """``(jtrain, jeval)``: the train and eval steps through ``jit``."""
    jtrain = jit(lambda bx, by: train_step(net, optimizer, bx, by),
                 state=(net, optimizer))
    jeval = jit(lambda bx: eval_step(net, bx), state=(net,))
    return jtrain, jeval


def device_epoch(jtrain, Xd, yd, batch_size: int):
    """One epoch with the training split on the device: permuted there by
    NumPy's next permutation, the full batches through ``jtrain.foreach``,
    then the rest in one call. Returns the last loss."""
    n = len(Xd)
    n_full = (n // batch_size) * batch_size
    with torch.no_grad():
        perm = torch.from_numpy(np.random.permutation(n)).to(Xd.device)
        Xp, yp = Xd[perm], yd[perm]
    loss = None
    if n_full:
        loss = jtrain.foreach(
            Xp[:n_full].reshape(n_full // batch_size, batch_size, -1),
            yp[:n_full].reshape(n_full // batch_size, batch_size))[-1]
    if n_full < n:
        loss = jtrain(Xp[n_full:], yp[n_full:])
    return loss


def main(argv=None) -> float:
    """Train; returns the last epoch's test accuracy."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--data", type=str,
                        default="examples/data/CoLA/tokenized")
    parser.add_argument("--samples", type=int, default=2048,
                        help="synthetic-fallback dataset size (the reference "
                             "benchmark config is 8551)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)

    device = resolve(args.device)
    manual_seed(42)  # NumPy's global stream too: the split and the epochs

    data = load_cola(args.data)
    if data is None:
        print("CoLA tsv not found -> synthetic CoLA-shaped data")
        data = synthetic_cola(n=args.samples)
    X, y = data
    y = y.astype(np.float64)
    y[y == 0] = -1

    cut = int(0.8 * len(X))
    perm = np.random.permutation(len(X))
    train_X, test_X = X[perm[:cut]], X[perm[cut:]]
    train_y, test_y = y[perm[:cut]], y[perm[cut:]]

    net, optimizer = build(int(X.max()) + 1, X.shape[1], args.lr, device)
    jtrain, jeval = steps(net, optimizer)
    B = args.batch_size
    if device.type == "cuda":
        Xd = torch.from_numpy(train_X).to(device)
        yd = torch.from_numpy(train_y.astype(np.float32)).to(device)
    loader = data_loader(train_X, train_y, B, shuffle=True)
    test_Xd = torch.from_numpy(test_X).to(device)
    acc = None
    for epoch in range(args.epochs):
        t_epoch = time.time()
        net.train()
        if device.type == "cuda":
            loss = device_epoch(jtrain, Xd, yd, B)
        else:
            for bx, by in loader:
                loss = jtrain(torch.from_numpy(bx),
                              torch.from_numpy(by.astype(np.float32)))
        net.eval()
        with torch.no_grad():
            score = jeval(test_Xd).cpu().numpy()
        acc = float((np.sign(score) == test_y).mean())
        print(f"epoch {epoch:2d}: loss={float(loss):.4f} test_acc={acc:.4f} "
              f"({time.time() - t_epoch:.3f}s)")
    return acc


if __name__ == "__main__":
    main()
