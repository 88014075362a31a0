"""NaN trapping and finiteness checks (counterpart of
``pydynet_tpu/utils/debug.py``).

``debug_nans`` is a ``TorchDispatchMode``: every aten op runs, and the first
whose floating-point output holds a NaN raises ``FloatingPointError`` naming
the op, as ``jax_debug_nans`` does. It reads every output back to the host,
so it cannot run inside a CUDA graph's capture (the jit's second call on a
GPU): there it raises ``RuntimeError`` before the op is recorded."""
from __future__ import annotations

import contextlib

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

_state = {"enabled": False, "mode": None}


class _NanMode(TorchDispatchMode):

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not _state["enabled"]:
            return func(*args, **(kwargs or {}))
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "debug_nans reads every op's output back to the host and "
                "cannot run inside a CUDA graph capture; leave it off for "
                "the jit's captured calls")
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Trap NaNs at the op that produced them; the previous setting returns
    on exit, so ``debug_nans(False)`` inside ``debug_nans()`` turns the trap
    off for its block only."""
    prev = _state["enabled"]
    _state["enabled"] = bool(enable)
    push = enable and _state["mode"] is None
    if push:
        _state["mode"] = _NanMode()
        _state["mode"].__enter__()
    try:
        yield
    finally:
        if push:
            mode, _state["mode"] = _state["mode"], None
            mode.__exit__(None, None, None)
        _state["enabled"] = prev


def check_finite(module, raise_on_fail: bool = True):
    """Names of the parameters (and ``<name>.grad`` of their gradients)
    holding a non-finite value; raises ``FloatingPointError`` listing them
    unless ``raise_on_fail`` is False."""
    from ..parallel.mesh import full

    bad = []
    for name, p in module.named_parameters():
        if not bool(torch.isfinite(full(p.detach())).all()):
            bad.append(name)
        if p.grad is not None and \
                not bool(torch.isfinite(full(p.grad)).all()):
            bad.append(name + ".grad")
    if bad and raise_on_fail:
        raise FloatingPointError(f"non-finite values in: {bad}")
    return bad
