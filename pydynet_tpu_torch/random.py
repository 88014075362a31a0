"""Seeding, JAX's threefry ``Generator`` and the sampler's key stream
(counterpart of ``pydynet_tpu/random.py`` and of the ``jax.random`` calls
the JAX package makes).

Two sources of randomness:

* ``torch.Generator``s, one a device, made on first use
  (:func:`torch_generator`). The init functions of ``nn/init.py`` and
  ``Llama.reset_parameters`` draw from the CPU's; their bits differ from the
  JAX package's NumPy draws, so weights cross between the packages through
  ``utils/checkpoint.py`` or ``models/llama/convert.py``.
* A threefry2x32 key stream that reproduces ``jax.random``'s bits
  (:func:`PRNGKey`, :func:`split`, :func:`fold_in`, :func:`bits`,
  :func:`uniform`, :func:`normal`, :func:`gumbel`, :func:`categorical`)
  under JAX's defaults as the JAX package runs them: 64-bit seeds (the
  package turns x64 on) and the partitionable threefry
  (``jax_threefry_partitionable``). A key is a (2,) int64 tensor, or a
  (B, 2) stack of per-row keys, on the device of the draw, holding two
  uint32 words; the 32-bit arithmetic is int64 masked to ``0xFFFFFFFF``,
  because CUDA tensors lack full uint32 operations. Every function is
  elementwise tensor code, so a key stream stays on the device.
  :class:`Generator` is the JAX package's ``random.Generator`` on it: a key
  split once a draw, and ``default_generator``, the one dropout draws from
  (``nn.functional.dropout``), so a dropout mask is the JAX package's bit
  for bit when the draws come in the same order.

The name ``default_generator`` means what it means in the JAX package: the
threefry :class:`Generator` instance. The per-device ``torch.Generator``
that an earlier version of this module returned under that name is
:func:`torch_generator`; what ``nn/init.py`` draws is unchanged.
:func:`manual_seed` seeds NumPy's global stream (the data loader's
shuffling, ``data.py``), every ``torch.Generator`` of this module and
``default_generator``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_seed = 0
_generators: dict = {}  # torch.device -> its torch.Generator


def torch_generator(device=None) -> torch.Generator:
    """The ``torch.Generator`` of ``device`` (the CPU when not given),
    seeded with the last :func:`manual_seed` (0 before any) when first
    made."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    gen = _generators.get(dev)
    if gen is None:
        gen = _generators[dev] = torch.Generator(device=dev)
        gen.manual_seed(_seed)
    return gen


def manual_seed(seed: int) -> "Generator":
    """Seed NumPy's global stream, every device's ``torch.Generator``
    (those made later too) and ``default_generator``. Returns
    ``default_generator``, as the JAX package's ``manual_seed`` does."""
    global _seed
    _seed = int(seed)
    np.random.seed(_seed)
    for gen in _generators.values():
        gen.manual_seed(_seed)
    return default_generator.manual_seed(_seed)


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


# 16-bit types: (mantissa bits, the bits of 1.0); JAX draws 8 random bits
# for a mantissa narrower than 8 (bfloat16), else 16 (its ``_uniform``)
_HALF = {torch.bfloat16: (7, 0x3F80), torch.float16: (10, 0x3C00)}


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
            dtype=torch.float32):
    """``jax.random.uniform``: random mantissa bits under the exponent of
    1.0, minus 1, then ``max(minval, u * (maxval - minval) + minval)`` in
    ``dtype``. float32 takes the top 23 of the 32 bits :func:`bits` draws;
    ``torch.float64``, JAX's default type under x64 (the speculative
    sampler's draw), the top 52 of the 64 bits ``(y0 << 32) | y1`` of
    threefry's two words; bfloat16 the top 7 of the low 8 bits and float16
    the top 10 of the low 16 (JAX truncates the 32-bit draw). Over [0, 1)
    the last step is exact; over another range its rounding is XLA's on
    the CPU (checked there against JAX)."""
    shape = tuple(shape)
    if dtype == torch.float64:
        n = math.prod(shape)
        i = torch.arange(n, dtype=torch.int64, device=key.device)
        k0, k1 = _words(key)
        y0, y1 = threefry2x32(k0, k1, i >> 32, i & _M32)
        f = ((y0 << 20) | (y1 >> 12)) | 0x3FF0000000000000
        u = f.view(torch.float64).reshape(key.shape[:-1] + shape) - 1.0
    elif dtype in _HALF:
        nmant, one = _HALF[dtype]
        width = 8 if nmant < 8 else 16
        b = bits(key, shape) & ((1 << width) - 1)
        u = ((b >> (width - nmant)) | one).to(torch.int16).view(dtype) - 1.0
    elif dtype == torch.float32:
        f = ((bits(key, shape) >> 9) | 0x3F800000).to(torch.int32)
        u = f.view(torch.float32) - 1.0
    else:
        raise TypeError(f"uniform draws floating types, got {dtype}")
    if minval == 0.0 and maxval == 1.0:  # u * 1 + 0, at least 0: u itself
        return u
    # 0-d operands filled on the device: no copy from the host
    lo = torch.full((), minval, dtype=dtype, device=key.device)
    span = torch.full((), maxval, dtype=dtype, device=key.device) - lo
    # XLA contracts u * span + lo into one rounding (a fused multiply-add)
    # in float16/32/64 and rounds each op in bfloat16
    v = u * span + lo if dtype == torch.bfloat16 else torch.addcmul(lo, u,
                                                                   span)
    return torch.maximum(lo, v)


def normal(key, shape, dtype=torch.float32):
    """``jax.random.normal``: ``sqrt(2) * erfinv(u)`` of ``u`` uniform in
    [nextafter(-1, 0), 1) in ``dtype``. ``erfinv`` is PyTorch's, which may
    round an ulp away from XLA's."""
    npt = {torch.float64: np.float64, torch.float32: np.float32}[dtype]
    lo = float(np.nextafter(npt(-1.0), npt(0.0)))
    u = uniform(key, shape, lo, 1.0, dtype)
    return torch.erfinv(u) * torch.full((), math.sqrt(2), dtype=dtype,
                                        device=key.device)


def bernoulli(key, p, shape):
    """``jax.random.bernoulli`` (its default ``"low"`` mode): ``uniform(key,
    shape) < p`` in p's type: a tensor's own, float64 for a Python number
    (JAX's type for it under x64, as the JAX package runs)."""
    dtype = p.dtype if isinstance(p, torch.Tensor) else torch.float64
    return uniform(key, shape, dtype=dtype) < p


class Generator:
    """The JAX package's threefry ``Generator`` (``pydynet_tpu/random.py:
    20-82``): a key from ``PRNGKey(seed)``, split at every draw; the first
    half stays as the state, the second draws. The key lives on the device
    of the last draw (the CPU at first): a draw on another device moves it
    there once, so a stream of draws on the card copies nothing from the
    host.

    The key is one buffer: a draw and :meth:`manual_seed` write the new key
    into it in place, so a CUDA graph that captured draws (``jit``) reads
    and advances the same key at every replay. Only a move to another
    device makes a new buffer, and that is refused during a capture."""

    def __init__(self, seed: int = 0) -> None:
        self._state = PRNGKey(seed)

    def manual_seed(self, seed: int) -> "Generator":
        self._state.copy_(PRNGKey(seed))
        return self

    @property
    def state(self) -> torch.Tensor:
        """The current key, (2,) int64 words."""
        return self._state

    def next_key(self, device=None) -> torch.Tensor:
        """Split the state on ``device`` (the state's own when not given):
        keep the first key, written into the state's buffer, and return the
        second."""
        if device is not None:
            self._move(torch.device(device))
        keys = split(self._state)
        self._state.copy_(keys[0])
        return keys[1]

    def _move(self, dev: torch.device) -> None:
        """Put the key on ``dev`` (a new buffer), unless it is there."""
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if self._state.device == dev:
            return
        if torch.cuda.is_available() \
                and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"Generator key on {self._state.device} drawn on {dev} "
                "during a CUDA graph capture: a capture cannot move it; "
                "draw once on that device before capturing")
        self._state = self._state.to(dev)

    def uniform(self, shape, dtype=torch.float32, minval: float = 0.0,
                maxval: float = 1.0, device=None) -> torch.Tensor:
        return uniform(self.next_key(device), shape, minval, maxval, dtype)

    def normal(self, shape, dtype=torch.float32, device=None):
        return normal(self.next_key(device), shape, dtype)

    def bernoulli(self, p, shape, device=None):
        return bernoulli(self.next_key(device), p, shape)


default_generator = Generator(0)


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
