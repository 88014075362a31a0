"""Seeding (counterpart of ``pydynet_tpu/random.py``).

The JAX package threads a jax.random key through its compiled steps; the
port runs eagerly, so its randomness comes from ``torch.Generator``s: one
default generator per device, made on first use. The init functions of
``nn/init.py`` draw from the CPU's, and dropout from that of its input's
device. :func:`manual_seed` seeds them all and NumPy's global stream, which
the data loader's shuffling reads (``data.py``). The bits differ from the
JAX package's threefry bits from the same seed, so tests hold a random op
by its law, or feed both packages the same numpy draws.
"""
from __future__ import annotations

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
