"""Weights from the JAX package's Llama into this port's Llama.

``params_from_tpu({name: p.numpy() for name, p in
jax_model._parameters.items()})`` gives a ``state_dict`` for
``Llama.load_state_dict``: the non-persistent scratch (``cache_k``,
``cache_v``, ``freqs_*``) is skipped and each Linear weight goes from the
JAX package's (in, out) layout to torch's (out, in). Both packages then
compute the same function from the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

_SKIP = ("cache_k", "cache_v", "freqs_cos", "freqs_sin")


def params_from_tpu(params: dict) -> dict:
    state = {}
    for name, value in params.items():
        if name.rsplit(".", 1)[-1] in _SKIP:
            continue
        a = np.asarray(value)
        # every 2-D weight but the embedding table is a Linear weight
        if a.ndim == 2 and name != "tok_embedding.weight":
            a = a.T
        state[name] = torch.from_numpy(np.ascontiguousarray(a))
    return state
