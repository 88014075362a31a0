"""Sharded checkpoints on ``torch.distributed.checkpoint`` (counterpart of
``pydynet_tpu/utils/sharded_checkpoint.py``, which stores through Orbax).

The state keeps ``utils.checkpoint``'s dotted-name layout (``model.<name>``,
``opt.lr``, ``opt.<buffer>.<i>``, ``opt.t``, ``step``: :func:`state_blob`
with ``leaf=``), with the live tensors as its leaves, so a DTensor's
placement rides into the checkpoint:

* each rank writes its own blocks, in parallel, with no gather;
* a restore reads into the target tensors' current placements (each rank
  reads the bytes it owns), in place, so a jitted step (its CUDA graph)
  resumes without a resharding pass;
* ``async_save=True`` returns at once, the state staged, with an object
  whose ``wait_until_finished()`` waits for the write.

Call every function from every rank of the mesh. An Orbax directory (the
JAX package's) and a DCP directory cannot be read by each other: what the
two packages share is the key set, not the file format (the ``.npz``
checkpoint of ``utils.checkpoint`` crosses packages).
"""
from __future__ import annotations

import os

import torch


def _train_state(module, optimizer=None, step: int = None):
    from .checkpoint import state_blob

    return state_blob(module, optimizer, step, leaf=lambda name, t: t.detach())


class _Pending:
    """An asynchronous save in flight."""

    def __init__(self, future):
        self._future = future

    def wait_until_finished(self):
        self._future.result()

    def close(self):
        self.wait_until_finished()


def _save(path, state, async_save):
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    if async_save:
        return _Pending(dcp.async_save(state, checkpoint_id=path))
    dcp.save(state, checkpoint_id=path)
    return None


def save_sharded(path: str, module, optimizer=None, step: int = None,
                 async_save: bool = False):
    """Write the training state as a DCP checkpoint directory; with
    ``async_save`` return an object with ``wait_until_finished()`` (the
    state is staged before the call returns, so training may go on)."""
    return _save(path, _train_state(module, optimizer, step), async_save)


def save_sharded_tree(path: str, tree, async_save: bool = False):
    """Save a dict of (possibly DTensor) tensors, such as the
    ``parallel.llama_spmd`` parameters; the same async contract."""
    return _save(path, dict(tree), async_save)


def _saved_keys(path):
    import torch.distributed.checkpoint as dcp

    return set(dcp.FileSystemReader(path).read_metadata()
               .state_dict_metadata)


def load_sharded_tree(path: str, like):
    """A :func:`save_sharded_tree` checkpoint read into tensors shaped and
    placed as those of ``like`` (a dict of live tensors); returns the new
    dict."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    out = {k: torch.empty_like(v) for k, v in like.items()}
    dcp.load(out, checkpoint_id=path)
    return out


@torch.no_grad()
def load_sharded(path: str, module, optimizer=None, strict: bool = True):
    """Restore a :func:`save_sharded` directory in place into the module's
    (and the optimizer's) tensors, each in its current placement. Returns
    the saved step, or None. ``strict`` raises ``KeyError`` for a parameter
    the checkpoint lacks."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    saved = _saved_keys(path)
    live = _train_state(module, optimizer, step=0)
    for k in live:
        if k.startswith("model.") and strict and k not in saved:
            raise KeyError(f"missing parameter in checkpoint: {k!r}")
    state = {k: v for k, v in live.items() if k in saved}
    dcp.load(state, checkpoint_id=path)
    if optimizer is not None and "opt.lr" in state:
        optimizer._lr_tensor.copy_(state["opt.lr"])
    cache = getattr(module, "_weights_cache", None)
    if isinstance(cache, dict):
        cache.clear()
    return int(state["step"]) if "step" in state else None
