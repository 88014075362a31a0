"""Seeding and the sampler's key stream (counterpart of
``pydynet_tpu/random.py`` and of the ``jax.random`` calls the JAX package's
sampled decode makes).

Two sources of randomness:

* ``torch.Generator``s, one default generator per device, made on first
  use. The init functions of ``nn/init.py`` draw from the CPU's, and dropout
  from that of its input's device. :func:`manual_seed` seeds them all and
  NumPy's global stream, which the data loader's shuffling reads
  (``data.py``). Their bits differ from the JAX package's, so tests hold
  such an op by its law, or feed both packages the same numpy draws.
* A threefry2x32 key stream that reproduces ``jax.random``'s bits for the
  calls the sampled decode makes (:func:`PRNGKey`, :func:`split`,
  :func:`fold_in`, :func:`bits`, :func:`uniform`, :func:`gumbel`,
  :func:`categorical`), under JAX's defaults as the JAX package runs them:
  64-bit seeds (the package turns x64 on) and the partitionable threefry
  (``jax_threefry_partitionable``). A key is a (2,) int64 tensor, or a
  (B, 2) stack of per-row keys, on the device of the draw, holding two
  uint32 words; the 32-bit arithmetic is int64 masked to ``0xFFFFFFFF``,
  because CUDA tensors lack full uint32 operations. Every function is
  elementwise tensor code, so a key stream stays on the device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_seed = 0
_generators: dict = {}  # torch.device -> its default torch.Generator


def default_generator(device=None) -> torch.Generator:
    """The default generator of ``device`` (the CPU when not given), seeded
    with the last :func:`manual_seed` (0 before any) when first made."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    gen = _generators.get(dev)
    if gen is None:
        gen = _generators[dev] = torch.Generator(device=dev)
        gen.manual_seed(_seed)
    return gen


def manual_seed(seed: int) -> torch.Generator:
    """Seed NumPy's global stream and every device's default generator
    (those made later too). Returns the CPU's."""
    global _seed
    _seed = int(seed)
    np.random.seed(_seed)
    for gen in _generators.values():
        gen.manual_seed(_seed)
    return default_generator()


# ------------------------------ threefry2x32 ------------------------------
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA  # the key schedule's third word: k0 ^ k1 ^ this


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 block of ``jax.random`` on uint32 words held
    in int64 tensors (any broadcastable shapes): keys ``k0, k1``, counters
    ``x0, x1``. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with x64 on: the seed widened to 64 bits,
    its high and low words (``PRNGKey(-3)`` is ``[0xFFFFFFFF,
    0xFFFFFFFD]``). A (2,) int64 tensor on ``device`` (the CPU when not
    given)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([seed >> 32, seed & _M32], dtype=torch.int64,
                        device=device)


def _words(key):
    """A key's two words, shaped to broadcast against a draw's trailing
    counter axis: (1,) for one key, (B, 1) for per-row keys."""
    return key[..., 0:1], key[..., 1:2]


def split(key, num: int = 2):
    """``jax.random.split(key, num)`` of the partitionable threefry: key i
    is threefry of ``key`` over the counters ``(i >> 32, i & 0xFFFFFFFF)``.
    A (2,) key gives (num, 2); per-row (B, 2) keys give (B, num, 2), as
    ``vmap(split)`` does."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    k0, k1 = _words(key)
    y0, y1 = threefry2x32(k0, k1, i >> 32, i & _M32)
    return torch.stack([y0, y1], dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)`` for int32 ``data``: threefry of
    ``key`` over ``(0, data & 0xFFFFFFFF)`` (the high word is 0 even for a
    negative ``data``). ``data`` may be an int or a (B,) tensor, which
    gives (B, 2) keys, as ``vmap(fold_in, (None, 0))`` does."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def bits(key, shape):
    """``jax.random.bits(key, shape)`` as uint32 words in int64: the xor of
    threefry's two outputs over the flattened index of ``shape``. Per-row
    (B, 2) keys draw ``shape`` (whose last axis is the counter's) for each
    row from its own key: (B, *shape)."""
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    k0, k1 = _words(key)
    y0, y1 = threefry2x32(k0, k1, i >> 32, i & _M32)
    return (y0 ^ y1).reshape(key.shape[:-1] + tuple(shape))


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa of
    a float in [1, 2), minus 1, then ``max(minval, u * (maxval - minval) +
    minval)``."""
    f = ((bits(key, shape) >> 9) | 0x3F800000).to(torch.int32)
    u = f.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    span = torch.tensor(maxval, dtype=torch.float32, device=key.device) - lo
    return torch.maximum(lo, u * span + lo)


_TINY = float(np.finfo(np.float32).tiny)


def gumbel(key, shape):
    """``jax.random.gumbel`` in float32 and its default ``"low"`` mode:
    ``-log(-log(uniform(key, shape, tiny, 1)))``."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key, logits):
    """``jax.random.categorical(key, logits, axis=-1)``: the argmax of
    ``gumbel + logits`` over the last axis, ties to the lowest index. One
    (2,) key draws the whole (..., V) array at once (its counters run over
    the flattened index); per-row (B, 2) keys draw row b of (B, V) logits
    from key b over 0..V-1, as ``vmap(categorical)`` does."""
    shape = tuple(logits.shape) if key.dim() == 1 else tuple(logits.shape[1:])
    return torch.argmax(gumbel(key, shape) + logits, dim=-1)
