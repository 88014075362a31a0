"""State dicts as NumPy by dotted name: the bridge that carries weights
between the port and the JAX package (``pydynet_tpu/utils/checkpoint.py``).

:func:`state_dict` gives every parameter and persistent buffer of a module
(running statistics included) by its dotted name as a NumPy array, as the
JAX package's ``state_dict`` does; :func:`load_state_dict` takes such a dict
with the JAX package's rules: a shape that differs raises ``ValueError``, and
under ``strict`` a missing or an unexpected name raises ``KeyError``. The
port's layers keep the JAX package's names and layouts, so
``load_state_dict(port_net, jax_net.state_dict())`` copies a JAX net into
its twin and ``jax_net.load_state_dict(state_dict(port_net))`` the reverse.
A module's decode-weight snapshots (``Llama._weights_cache``) are dropped on
load, as there, so a model decodes the weights it was given.
"""
from __future__ import annotations

import numpy as np
import torch


def state_dict(module: torch.nn.Module) -> dict:
    """Dotted name -> NumPy copy of every parameter and persistent
    buffer."""
    return {name: t.detach().cpu().numpy()
            for name, t in module.state_dict().items()}


@torch.no_grad()
def load_state_dict(module: torch.nn.Module, state: dict,
                    strict: bool = True) -> torch.nn.Module:
    """Copy ``state`` (dotted name -> array) into the module's parameters
    and persistent buffers, each cast to its tensor's type and device."""
    own = module.state_dict(keep_vars=True)
    missing = []
    for name, t in own.items():
        if name not in state:
            if strict:
                missing.append(name)
            continue
        value = np.asarray(state[name])
        if tuple(value.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for '{name}': checkpoint has "
                             f"{tuple(value.shape)}, parameter is "
                             f"{tuple(t.shape)}")
        t.copy_(torch.tensor(value))
    if missing:
        raise KeyError(f"missing parameters in state dict: {missing[:5]}...")
    if strict:
        unexpected = [k for k in state if k not in own]
        if unexpected:
            raise KeyError(
                f"unexpected entries in state dict: {unexpected[:5]}"
                f"{'...' if len(unexpected) > 5 else ''} — pass "
                "strict=False to load the intersection")
    cache = getattr(module, "_weights_cache", None)
    if isinstance(cache, dict):
        cache.clear()
    return module
