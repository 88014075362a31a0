"""Pipeline parallelism (GPipe) over a ``pp`` mesh axis (counterpart of
``pydynet_tpu/parallel/pipeline.py``).

The layer stack is split into P contiguous stages, stage p's weights on the
rank at ring position p of ``pp``, and microbatches stream through the ring:
at each of the ``M + P - 1`` ticks every stage runs its layers on what the
previous stage sent it the tick before, and the ring shift
(``_comm.shift``, an autograd function whose backward is the reverse shift,
the transpose JAX's AD gives ``ppermute``) carries the outputs on. The
backward pipeline falls out of autograd in reverse tick order.

Composes with ``dp`` (the microbatches' rows) and ``tp``: with a ``tp`` axis
each layer is Megatron-sharded inside its stage (query heads and ffn
columns, output and down rows) and the two all-reduces a block are written
out (``_layer_body_tp``), grouped-query KV heads included: group-sharded when
``Hkv % tp == 0``, else whole on every tp rank, each reading the groups of
its query heads.
"""
from __future__ import annotations

import torch

from . import _comm as C
from .llama_spmd import (LAYER_KEYS, _Axis, _causal_mask, _embed, _ids,
                         _layer, _like, _rms, layer_dense)
from .mesh import P, as_mesh, local, shard


def pipeline_apply(stage_fn, stage_params, x_mb, *, axis: str = "pp",
                   n_stages: int, mesh=None):
    """Run microbatches ``x_mb`` (M, ...) through ``n_stages`` stages.

    ``stage_params`` are this rank's stage's parameters and ``stage_fn(
    params, x) -> y`` keeps the shape. The GPipe schedule: at tick t stage 0
    injects microbatch t, stage p runs what stage p-1 produced at t-1, and
    the last stage emits microbatch t-(P-1). The result is collected on the
    last stage and summed over the axis (the other stages hold zeros), so
    it is the same on every rank. ``mesh`` names the ring's mesh (None:
    one stage, no communication)."""
    ax = _Axis(None if mesh is None else as_mesh(mesh), axis)
    M = x_mb.shape[0]
    Pn, p = n_stages, ax.index
    dev = x_mb.device
    # every rank runs the same ops (selects, not Python branches), so each
    # rank's backward issues the same shifts in the same order
    first = torch.tensor(p == 0, device=dev)
    state = torch.zeros_like(x_mb[0])
    acc = torch.zeros_like(x_mb)
    for t in range(M + Pn - 1):
        inp = torch.where(first, x_mb[min(t, M - 1)], state)
        out = stage_fn(stage_params, inp)
        oidx = torch.tensor([min(max(t - (Pn - 1), 0), M - 1)], device=dev)
        write = torch.tensor(p == Pn - 1 and t >= Pn - 1, device=dev)
        acc = torch.where(write, acc.index_copy(0, oidx, out[None].to(
            acc.dtype)), acc)
        if t < M + Pn - 2:  # the last tick's shift would carry nothing read
            state = C.shift(out, ax.group)
    return C.reduce(acc, ax.group)


_TP_COL = ("wq", "wk", "wv", "gate", "up")
_TP_ROW = ("wo", "down")


def _kv_sharded(cfg, tp_size: int) -> bool:
    hkv = cfg.get("n_kv_heads") or cfg["n_heads"]
    return hkv % tp_size == 0


def _tp_stage_specs(cfg=None, tp_size: int = 1):
    """Specs of the stage-stacked (P, N/P, ...) layer parameters with tp."""
    kv_shard = cfg is None or _kv_sharded(cfg, tp_size)
    spec = {}
    for k in LAYER_KEYS:
        if k in _TP_COL:
            if k in ("wk", "wv") and not kv_shard:
                spec[k] = P("pp")
            else:
                spec[k] = P("pp", None, None, "tp")
        elif k in _TP_ROW:
            spec[k] = P("pp", None, "tp", None)
        else:
            spec[k] = P("pp")
    return spec


def prepare_pp_params(params, mesh, n_stages: int, cfg=None):
    """A ``llama_spmd.init_params``-layout dict -> stage-stacked parameters
    placed on the mesh (head-split and tp-sharded when the mesh has ``tp``),
    ready for :func:`make_pp_train_step`. ``cfg`` is needed for a
    grouped-query layout under tp (the KV heads' placement)."""
    mesh = as_mesh(mesh)
    if mesh.axis_size("tp") > 1:
        if cfg is None and params["wk"].shape[-1] != params["wq"].shape[-1]:
            raise ValueError(
                "GQA layout detected (narrow wk): pass cfg= to "
                "prepare_pp_params so kv heads can be placed across tp")
        params = stack_stages(params, n_stages)
        specs = _tp_stage_specs(cfg, mesh.axis_size("tp"))
        return {k: shard(v, mesh, *specs.get(k, P()))
                for k, v in params.items()}
    return shard_stage_params(stack_stages(params, n_stages), mesh)


def stack_stages(params, n_stages: int, pp_keys=LAYER_KEYS):
    """Reshape layer-stacked (N, ...) parameters to (P, N/P, ...)."""
    out = dict(params)
    for k in pp_keys:
        v = params[k]
        N = v.shape[0]
        assert N % n_stages == 0, (k, N, n_stages)
        out[k] = v.reshape((n_stages, N // n_stages) + tuple(v.shape[1:]))
    return out


def shard_stage_params(params, mesh, pp_keys=LAYER_KEYS):
    """Stage axis over ``pp``, the rest replicated."""
    out = {}
    for k, v in params.items():
        spec = ("pp",) + (None,) * (v.ndim - 1) if k in pp_keys else ()
        out[k] = shard(v, mesh, *spec)
    return out


def _layer_body(h, W, cos, sin, mask, cfg):
    """One pre-norm layer on whole weights (the llama_spmd math)."""
    return layer_dense(h, W, cos, sin, mask, cfg)


def _layer_body_tp(h, W, cos, sin, mask, cfg, tp, kv_shard: bool = True):
    """One layer on this tp rank's blocks with the two all-reduces of the
    block written out (``tp`` an axis of ``llama_spmd._Axis``). Whole KV
    weights (``kv_shard`` False) are replicated over tp, so their gradient
    is summed over it."""
    if not kv_shard:
        W = dict(W, wk=C.copy(W["wk"], tp.group), wv=C.copy(W["wv"],
                                                            tp.group))
    return _layer(h, W, cos, sin, mask, cfg, tp, kv_shard)


def _enter(x, *axes):
    """``x``, replicated over ``axes``, entering code whose gradient is
    partial on each of their ranks: the gradient is summed over them."""
    for ax in axes:
        x = C.copy(x, ax.group)
    return x


def pp_forward_logits(params, tokens, cfg, mesh, microbatches: int,
                      n_stages: int):
    """Full-sequence causal forward -> (B, L, V) logits with the layer stack
    pipelined over ``pp``, rows over ``dp`` and, with a ``tp`` axis, each
    layer tp-sharded. ``params`` from :func:`prepare_pp_params`. The
    embedding, the final norm and the head run replicated outside the
    pipeline (they are small here)."""
    mesh = as_mesh(mesh)
    pp, dp, tp = (_Axis(mesh, a) for a in ("pp", "dp", "tp"))
    W = {k: local(v) for k, v in params.items()}
    B, L = tokens.shape
    M = microbatches
    assert B % M == 0, (B, M)
    ids = _ids(tokens, W["tok"].device)
    # the embedding enters the pipeline on every stage and is read by the
    # first: its gradient is summed over pp; the rows split over dp. The
    # RoPE tables and the stage weights are read by rank-specific code:
    # their gradients are summed over the axes that replicate them
    h = C.copy(_embed(W["tok"], ids, _Axis(None, "tp")), pp.group)
    cos, sin = (_enter(W[t][:L], pp, tp, dp) for t in ("cos", "sin"))
    mask = _causal_mask(L, h.dtype, h.device)
    if tp.size > 1:
        assert cfg["n_heads"] % tp.size == 0, (cfg["n_heads"], tp.size)
        kv_shard = _kv_sharded(cfg, tp.size)

        def body(h, Wl):
            return _layer_body_tp(h, Wl, cos, sin, mask, cfg, tp, kv_shard)
    else:
        def body(h, Wl):
            return _layer_body(h, Wl, cos, sin, mask, cfg)

    stage = {k: _enter(W[k][0], dp) for k in LAYER_KEYS}  # (N/P, ...)

    def stage_fn(Ws, hmb):
        for i in range(Ws["wq"].shape[0]):
            hmb = body(hmb, {k: v[i] for k, v in Ws.items()})
        return hmb

    h_mb = h.reshape((M, B // M) + tuple(h.shape[1:]))
    h_mb = C.split(h_mb, 1, dp.group)  # rows over dp
    h_mb = pipeline_apply(stage_fn, stage, h_mb, n_stages=n_stages,
                          mesh=mesh)
    h_mb = C.gather(h_mb, 1, dp.group)
    h = h_mb.reshape((B,) + tuple(h_mb.shape[2:]))
    h = _rms(h, W["norm"])
    return h @ W["head_w"] + W["head_b"]


def make_pp_train_step(mesh, cfg, lr: float = 1e-3, microbatches: int = 4):
    """``step(params, tokens, targets) -> (params, loss)``: one SGD step of
    the pipelined forward's mean cross-entropy over :func:`prepare_pp_params`
    parameters. ``mesh`` has a ``pp`` axis (its size divides n_layers) and
    may have ``dp`` and ``tp``."""
    mesh = as_mesh(mesh)
    n_stages = mesh.shape["pp"]
    assert cfg["n_layers"] % n_stages == 0, (cfg["n_layers"], n_stages)

    def step(params, tokens, targets):
        W = {k: local(v).detach().requires_grad_(local(v).is_floating_point())
             for k, v in params.items()}
        with torch.enable_grad():
            logits = pp_forward_logits(W, tokens, cfg, mesh, microbatches,
                                       n_stages)
            logp = torch.log_softmax(logits, dim=-1)
            tgt = _ids(targets, logits.device)
            loss = torch.mean(-torch.take_along_dim(logp, tgt[..., None],
                                                    dim=-1))
            keys = [k for k in W if W[k].requires_grad]
            grads = torch.autograd.grad(loss, [W[k] for k in keys],
                                        allow_unused=True)
        new = dict(params)
        with torch.no_grad():
            for k, g in zip(keys, grads):
                g = torch.zeros_like(W[k]) if g is None else g
                new[k] = _like(W[k] - lr * g, params[k])
        return new, loss.detach()

    return step
