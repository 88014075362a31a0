"""Weights between the JAX package's Llama and this port's Llama.

``params_from_tpu({name: p.numpy() for name, p in
jax_model._parameters.items()})`` gives a ``state_dict`` for
``Llama.load_state_dict``: the non-persistent scratch (``cache_k``,
``cache_v``, ``freqs_*``) is skipped and each Linear weight goes from the
JAX package's (in, out) layout to torch's (out, in). Both packages then
compute the same function from the same numbers. ``params_to_tpu`` is the
reverse: a state of this port (a ``state_dict`` or ``named_parameters``) as
NumPy arrays in the JAX package's layout, for ``Tensor.data`` or
``Llama.load_state_dict`` there.
"""
from __future__ import annotations

import numpy as np
import torch

_SKIP = ("cache_k", "cache_v", "freqs_cos", "freqs_sin")


def swap_linear(name: str, a):
    """``a`` with its two axes swapped if ``name`` is a Linear weight (every
    2-D weight but the embedding table), else as it is: (in, out) <->
    (out, in)."""
    return a.T if a.ndim == 2 and name != "tok_embedding.weight" else a


def params_from_tpu(params: dict) -> dict:
    state = {}
    for name, value in params.items():
        if name.rsplit(".", 1)[-1] in _SKIP:
            continue
        a = swap_linear(name, np.asarray(value))
        state[name] = torch.from_numpy(np.ascontiguousarray(a))
    return state


def params_to_tpu(state: dict) -> dict:
    """``{name: float array}`` in the JAX package's layout from this port's
    ``{name: tensor}``."""
    return {name: np.ascontiguousarray(
                swap_linear(name, t.detach().cpu().numpy()))
            for name, t in state.items()}
