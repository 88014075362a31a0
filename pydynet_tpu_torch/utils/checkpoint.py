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

:func:`save_checkpoint` writes the JAX package's training-state ``.npz``
(:func:`state_blob`): ``model.<name>`` for the state, ``opt.lr``,
``opt.<buffer>.<i>`` for the optimizer's ``v``, ``m`` and ``G`` buffers by
parameter index, ``opt.t`` for Adam's step counter, ``step`` and
``extra.<key>``; :func:`load_checkpoint` restores one, strictly by default.
Weights that the port keeps in torch's (out, in) layout (a
``torch.nn.Linear``'s, as the Llama's, and the adapters of a
:class:`~pydynet_tpu_torch.nn.LoRALinear` wrapping one) are written and
read transposed, with their optimizer buffers, in the JAX package's (in,
out) layout (``models/llama/convert.swap_linear``'s rule), so one file
resumes training in either package.
"""
from __future__ import annotations

import os

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


def _torch_layout(module: torch.nn.Module) -> set:
    """Dotted names of the weights held in torch's (out, in) layout: a
    ``torch.nn.Linear``'s weight, and the weight and adapters of a LoRA
    layer wrapping one."""
    from ..nn.modules.lora import LoRALinear

    names = set()
    for path, m in module.named_modules():
        pre = path + "." if path else ""
        if type(m) is torch.nn.Linear:
            names.add(pre + "weight")
        elif isinstance(m, LoRALinear) and m.torch_layout:
            names.update(pre + n for n in ("weight", "lora_A", "lora_B"))
    return names


def _jax_layout(name: str, a: np.ndarray, swap: set) -> np.ndarray:
    """``a`` in the JAX package's layout (and back: a transpose is its own
    inverse)."""
    return np.ascontiguousarray(a.T) if name in swap else a


def _buffers(module, optimizer):
    """``(key, buffer, dotted name of its parameter or None)`` for each
    optimizer buffer the checkpoint holds."""
    names = {id(p): n for n, p in module.named_parameters()}
    for buf_name in ("v", "m", "G"):
        bufs = getattr(optimizer, buf_name, None)
        if isinstance(bufs, list):
            for i, (b, p) in enumerate(zip(bufs, optimizer.params)):
                yield f"opt.{buf_name}.{i}", b, names.get(id(p))


def state_blob(module, optimizer=None, step: int = None,
               leaf=None) -> dict:
    """The training state as the JAX package lays it out: dotted name ->
    ``leaf(name, tensor)``, where ``name`` is the dotted name of the
    parameter a tensor belongs to (None for ``opt.lr``, ``opt.t`` and
    ``step``). The default leaf is a NumPy copy in the JAX package's layout
    (module docstring); the sharded checkpoint passes the live tensors, in
    the port's own layout, with their placements: the same key set."""
    if leaf is None:
        swap = _torch_layout(module)

        def leaf(name, t):
            return _jax_layout(name, t.detach().cpu().numpy(), swap)

    blob = {f"model.{k}": leaf(k, t)
            for k, t in module.state_dict(keep_vars=True).items()}
    if optimizer is not None:
        # float64, as ``np.asarray(optimizer.lr)`` in the JAX package
        blob["opt.lr"] = leaf(None, optimizer._lr_tensor.double())
        for key, b, name in _buffers(module, optimizer):
            blob[key] = leaf(name, b)
        if hasattr(optimizer, "_t_tensor"):
            blob["opt.t"] = leaf(None, optimizer._t_tensor)
    if step is not None:
        blob["step"] = leaf(None, torch.tensor(step))
    return blob


def save_checkpoint(path: str, module, optimizer=None, step: int = None,
                    extra: dict = None) -> None:
    """Write :func:`state_blob` and ``extra`` (scalars or arrays, read back
    by :func:`read_extra` or ``load_checkpoint(with_extra=True)``) to an
    ``.npz`` at exactly ``path``."""
    blob = state_blob(module, optimizer, step)
    for k, v in (extra or {}).items():
        blob[f"extra.{k}"] = np.asarray(v)
    # a file object: np.savez appends '.npz' to an extensionless path
    with open(path, "wb") as f:
        np.savez(f, **blob)


def _resolve(path: str) -> str:
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        return path + ".npz"  # written by np.savez's own suffix
    return path


def _extra(blob) -> dict:
    out = {}
    for k in blob.files:
        if k.startswith("extra."):
            v = blob[k]
            out[k[len("extra."):]] = v.item() if v.ndim == 0 else v
    return out


def read_extra(path: str) -> dict:
    """The ``extra`` dict a checkpoint was saved with, 0-d arrays as Python
    scalars."""
    with np.load(_resolve(path)) as blob:
        return _extra(blob)


@torch.no_grad()
def load_checkpoint(path: str, module, optimizer=None, strict: bool = True,
                    with_extra: bool = False):
    """Restore a checkpoint of either package into ``module`` and
    ``optimizer``. Returns the saved step (``None`` when there is none), or
    ``(step, extra)`` with ``with_extra``. ``strict`` (the default) raises
    ``KeyError`` for a missing or an unexpected model entry; an optimizer
    buffer of another shape than its checkpoint entry raises
    ``ValueError`` (the buffers are matched by index, so an optimizer over
    another parameter set would take the wrong ones)."""
    with np.load(_resolve(path)) as blob:
        swap = _torch_layout(module)
        load_state_dict(module, {
            k[len("model."):]: _jax_layout(k[len("model."):], blob[k], swap)
            for k in blob.files if k.startswith("model.")}, strict=strict)
        if optimizer is not None:
            if "opt.lr" in blob.files:
                optimizer.lr = float(blob["opt.lr"])
            for key, b, name in _buffers(module, optimizer):
                if key not in blob.files:
                    continue
                value = _jax_layout(name, blob[key], swap)
                if tuple(value.shape) != tuple(b.shape):
                    raise ValueError(
                        f"shape mismatch for optimizer moment '{key}': "
                        f"checkpoint has {tuple(value.shape)}, buffer is "
                        f"{tuple(b.shape)} — was the optimizer built over a "
                        "different parameter set?")
                b.copy_(torch.from_numpy(value))
            if hasattr(optimizer, "_t_tensor") and "opt.t" in blob.files:
                optimizer._t_tensor.fill_(float(blob["opt.t"]))
        step = int(blob["step"]) if "step" in blob.files else None
        if with_extra:
            return step, _extra(blob)
        return step
