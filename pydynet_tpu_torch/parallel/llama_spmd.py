"""SPMD Llama over a ``(dp, tp)`` mesh: the sharded train step, decode and
the weight-only quantized serving forward (counterpart of
``pydynet_tpu/parallel/llama_spmd.py``).

The batch rides ``dp``; every weight matrix is Megatron-sharded over ``tp``:
q/k/v and gate/up by output columns (whole heads, whole ffn columns), the
output and down projections by input rows, the embedding and the head by
vocabulary. The parameters are a dict of DTensors (:func:`shard_params`),
each rank computing on its local blocks with the collectives the JAX
package leaves to GSPMD written out (``parallel/_comm.py``): one all-reduce
after each row-parallel product, a gradient all-reduce where a replicated
activation enters the sharded products, an all-gather of the vocabulary
for the logits, and the gradients summed over ``dp`` before the update.

Every rank passes the same global arguments (tokens ``(B, L)``, with ``B``
divisible by ``dp``) and gets the same global result (``parallel/mesh.py``).
A dict of plain tensors is the one-device case: no mesh, no collectives.

The per-matrix layout keeps every tp block a whole block of heads (a fused
q|k|v matrix would split across its boundaries). Under grouped-query
attention with fewer KV heads than tp ranks (``Hkv % tp != 0``), wk and wv
stay column-sharded as the JAX package shards them and are gathered whole
for the product, each rank reading the KV groups of its query heads.

``quantize_params`` serves weight-only int8/int4 with plain products,
``(x @ q) * scale`` with the per-output-channel scale commuted out of the
contraction, and int4 as two half-K products of the ``ops/quant`` nibble
layout: this lane is weight-only and plain by design, not the W8A8 kernels
of ``ops/gemv_quant`` (K5-K7). A row-parallel int4 block pairs the
activation's columns ``[r0, r1)`` and ``[K/2 + r0, K/2 + r1)``, so that
product gathers its activation first.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..models.llama.model import _rope_pure as _rope
from ..ops.decode_step import quantize_kv
from ..ops.quant import quantize_int4, quantize_int8, unpack_int4
from . import _comm as C
from .mesh import (P, as_mesh, from_local, full, local, mesh_of,
                   named_sharding, shard)


def config(vocab_size=32000, dim=288, n_heads=6, ffn_dim=768, n_layers=6,
           max_seq_len=1024, n_kv_heads=None):
    return dict(vocab_size=vocab_size, dim=dim, n_heads=n_heads,
                ffn_dim=ffn_dim, n_layers=n_layers, max_seq_len=max_seq_len,
                n_kv_heads=n_kv_heads or n_heads)


def _kv_dim(cfg):
    return cfg.get("n_kv_heads", cfg["n_heads"]) * \
        (cfg["dim"] // cfg["n_heads"])


# per-layer (leading layer-axis) parameter names, one array per matrix
LAYER_KEYS = ("wq", "wk", "wv", "wo", "gate", "up", "down",
              "in_norm", "post_norm")
_QUANT_MATS = ("wq", "wk", "wv", "wo", "gate", "up", "down")
_ROW = ("wo", "down")  # row-parallel: an all-reduce after the product


class _Axis:
    """One mesh axis as this rank sees it: its group (None at size 1), size
    and this rank's index."""

    def __init__(self, mesh, name):
        self.group = None if mesh is None else mesh.group(name)
        self.size = 1 if mesh is None else mesh.axis_size(name)
        self.index = 0 if mesh is None else mesh.axis_index(name)


def _kv_sharded(cfg, tp_size: int) -> bool:
    """Each tp rank owns whole KV heads (``Hkv % tp == 0``): its Hkv/tp
    heads serve exactly its H/tp query heads."""
    hkv = cfg.get("n_kv_heads") or cfg["n_heads"]
    return hkv % tp_size == 0


def init_params(rng: np.random.RandomState, cfg, dtype=torch.float32):
    """Layer-stacked parameters drawn from ``rng`` in the JAX package's
    order (so one seed gives both packages the same weights), as host
    tensors: :func:`shard_params` places them on the mesh."""
    V, D, F, N = (cfg["vocab_size"], cfg["dim"], cfg["ffn_dim"],
                  cfg["n_layers"])
    Dkv = _kv_dim(cfg)
    s = 0.02

    def w(*shape):
        return torch.as_tensor(rng.standard_normal(shape) * s).to(dtype)

    hd = D // cfg["n_heads"]
    inv_freq = 1.0 / (10000**(np.arange(0, hd, 2)[:hd // 2] / hd))
    freqs = np.outer(np.arange(cfg["max_seq_len"]), inv_freq)
    return {
        "tok": w(V, D),
        "cos": torch.as_tensor(np.cos(freqs)).to(dtype),
        "sin": torch.as_tensor(np.sin(freqs)).to(dtype),
        "norm": torch.ones((D,), dtype=dtype),
        "head_w": w(D, V),
        "head_b": torch.zeros((V,), dtype=dtype),
        "wq": w(N, D, D),
        "wk": w(N, D, Dkv),
        "wv": w(N, D, Dkv),
        "wo": w(N, D, D),
        "gate": w(N, D, F),
        "up": w(N, D, F),
        "down": w(N, F, D),
        "in_norm": torch.ones((N, D), dtype=dtype),
        "post_norm": torch.ones((N, D), dtype=dtype),
    }


def params_to_torch(params, dtype=None):
    """A parameter dict of arrays (NumPy, or the JAX package's) as host
    tensors, cast to ``dtype`` when given; the pipeline's stage stacks and
    the MoE dict convert the same way."""
    out = {}
    for k, v in params.items():
        t = torch.as_tensor(np.asarray(v))
        out[k] = t.to(dtype) if dtype is not None and t.is_floating_point() \
            else t
    return out


def quantize_params(params, quant="int8"):
    """The weight-only quantized parameter dict: every layer matrix and the
    head become ``<k>_q``/``<k>_s`` pairs in the ``ops/quant`` layouts
    (contraction axis quantized, per-output-channel float32 scales; int4
    packs the contraction axis), with ``q4`` marking int4. Key presence is
    the switch :func:`forward_tokens` takes. Sharded parameters are gathered
    first; :func:`shard_params` places the result."""
    if quant not in ("int8", "int4"):
        raise ValueError(f"unsupported quant mode: {quant!r}")
    qfn = quantize_int4 if quant == "int4" else quantize_int8
    out = {k: full(v) for k, v in params.items()}
    for k in _QUANT_MATS:
        out[k + "_q"], out[k + "_s"] = qfn(out.pop(k), axis=1)
    out["head_q"], out["head_s"] = qfn(out.pop("head_w"), axis=0)
    if quant == "int4":
        out["q4"] = torch.ones((), dtype=torch.int8)
    return out


def _ax(mesh, name: str):
    """Axis name if the mesh has it, else None (replicated)."""
    return name if name in mesh.axis_names else None


def param_shardings(mesh, params=None):
    """Megatron-style shardings per parameter (replicated where the mesh
    has no ``tp`` axis). With ``params`` the table is filtered to its keys,
    which gives a :func:`quantize_params` dict its shardings: ``<k>_q``
    shards as the dense ``<k>``, ``<k>_s`` on the output axis where the
    dense one shards it."""
    mesh = as_mesh(mesh)
    tp = _ax(mesh, "tp")
    dense = {
        "tok": P(tp, None),            # vocab-sharded embedding
        "cos": P(),
        "sin": P(),
        "norm": P(),
        "head_w": P(None, tp),         # column-parallel lm head
        "head_b": P(tp),
        "wq": P(None, None, tp),       # column-parallel: whole query heads
        "wk": P(None, None, tp),
        "wv": P(None, None, tp),
        "wo": P(None, tp, None),       # row-parallel output proj
        "gate": P(None, None, tp),
        "up": P(None, None, tp),
        "down": P(None, tp, None),
        "in_norm": P(),
        "post_norm": P(),
    }
    if params is None:
        return {k: named_sharding(mesh, *spec) for k, spec in dense.items()}
    specs = dict(dense)
    for k in _QUANT_MATS:
        specs[k + "_q"] = dense[k]
        specs[k + "_s"] = P(None, None, dense[k][2])
    specs["head_q"] = dense["head_w"]
    specs["head_s"] = P(None, tp)
    specs["q4"] = P()
    return {k: named_sharding(mesh, *specs[k]) for k in params}


def shard_params(params, mesh):
    """The parameters as DTensors on the mesh (each rank cuts its blocks
    from its own global copy)."""
    sh = param_shardings(mesh, params)
    return {k: shard(v, mesh, *sh[k].spec) for k, v in params.items()}


# ------------------------------ the math ---------------------------------- #
def _rms(x, w):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + 1e-6) * w


def _qmm(x, q, s, q4):
    """``x @ dequant(q, s)`` with the scale commuted out of the
    contraction; int4 as the two half-K products of the nibble layout."""
    if q4:
        lo, hi = unpack_int4(q)
        K2 = q.shape[-2]
        y = x[..., :K2] @ lo.to(x.dtype) + x[..., K2:] @ hi.to(x.dtype)
    else:
        y = x @ q.to(x.dtype)
    return y * s.squeeze(-2).to(x.dtype)


def _wmm(x, W, name, q4, tp=None):
    """``x @ W[name]`` on this rank's blocks (quantized when ``W`` holds
    ``<name>_q``). A row-parallel int4 block gathers its activation: its
    packed rows pair the columns ``[r0, r1)`` and ``[K/2 + r0, K/2 + r1)``."""
    if name + "_q" not in W:
        return x @ W[name]
    q, s = W[name + "_q"], W[name + "_s"]
    if q4 and name in _ROW and tp is not None and tp.size > 1:
        xf = C.gather(x, -1, tp.group)
        K2l = q.shape[-2]
        r0, K2 = tp.index * K2l, K2l * tp.size
        lo, hi = unpack_int4(q)
        y = (xf[..., r0:r0 + K2l] @ lo.to(x.dtype)
             + xf[..., K2 + r0:K2 + r0 + K2l] @ hi.to(x.dtype))
        return y * s.squeeze(-2).to(x.dtype)
    return _qmm(x, q, s, q4)


def _kv_heads(k, v, g, Hl, kv_shard, tp):
    """The K/V heads this rank's ``Hl`` query heads read: each of its own
    KV heads repeated to its group, or (KV heads whole on every rank) the
    groups of its block of query heads."""
    if g == 1:
        return k, v
    if kv_shard:
        return k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    idx = (tp.index * Hl + torch.arange(Hl, device=k.device)) // g
    return k.index_select(2, idx), v.index_select(2, idx)


def _layer(h, W, cos, sin, mask, cfg, tp=None, kv_shard=True):
    """One pre-norm layer on this rank's blocks ``W``: q/k/v and gate/up
    column blocks, wo/down row blocks, each row-parallel product
    all-reduced over ``tp`` (an ``_Axis``; None: one device). ``kv_shard``
    False means wk/wv are whole here. ``cos``/``sin`` enter rank-specific
    code: a caller that trains passes them through ``_comm.copy``."""
    B, L, _ = h.shape
    H = cfg["n_heads"]
    hd = cfg["dim"] // H
    g = H // (cfg.get("n_kv_heads") or H)
    grp = None if tp is None else tp.group
    Hl = W["wq"].shape[-1] // hd if "wq" in W else H // (tp.size if tp else 1)
    q4 = "q4" in W
    hn = C.copy(_rms(h, W["in_norm"]), grp)
    q = _wmm(hn, W, "wq", q4).reshape(B, L, Hl, hd)
    k = _wmm(hn, W, "wk", q4).reshape(B, L, -1, hd)
    v = _wmm(hn, W, "wv", q4).reshape(B, L, -1, hd)
    q, k = _rope(q, cos, sin), _rope(k, cos, sin)
    k, v = _kv_heads(k, v, g, Hl, kv_shard, tp)
    s = torch.einsum("blhd,bmhd->bhlm", q, k) / math.sqrt(hd)
    p = torch.softmax(s + mask, dim=-1)
    att = torch.einsum("bhlm,bmhd->blhd", p, v).reshape(B, L, Hl * hd)
    z = h + C.reduce(_wmm(att, W, "wo", q4, tp), grp)
    zn = C.copy(_rms(z, W["post_norm"]), grp)
    gate, up = _wmm(zn, W, "gate", q4), _wmm(zn, W, "up", q4)
    return z + C.reduce(_wmm((gate * torch.sigmoid(gate)) * up, W, "down",
                             q4, tp), grp)


def layer_dense(h, W, cos, sin, mask, cfg):
    """One pre-norm transformer layer on whole weights ``W`` (one device):
    the math every sharded path splits."""
    return _layer(h, W, cos, sin, mask, cfg)


def _embed(tok, ids, tp):
    """Rows of a vocabulary-sharded table: each rank looks up the ids in its
    block, zero elsewhere, and the all-reduce makes the rows whole."""
    if tp.size == 1:
        return tok[ids]
    Vl = tok.shape[0]
    rel = ids - tp.index * Vl
    ok = (rel >= 0) & (rel < Vl)
    e = tok[rel.clamp(0, Vl - 1)] * ok[..., None].to(tok.dtype)
    return C.reduce(e, tp.group)


def _whole_kv(W, cfg, tp, keys=("wk", "wv")):
    """``W`` with wk/wv (or their quantized pairs) whole on every rank when
    the KV heads are not sharded (``Hkv % tp != 0``)."""
    if tp.size == 1 or _kv_sharded(cfg, tp.size):
        return W
    W = dict(W)
    for k in keys:
        for name in (k, k + "_q", k + "_s"):
            if name in W:
                W[name] = C.gather_sum(W[name], -1, tp.group)
    return W


def _causal_mask(L, dtype, device):
    r = torch.arange(L, device=device)
    return torch.zeros((L, L), dtype=dtype, device=device).masked_fill(
        r[:, None] < r[None, :], float("-inf"))


def _rows(x, dp):
    """This rank's block of rows of a global batch."""
    if dp.size == 1:
        return x
    n = x.shape[0] // dp.size
    return x[dp.index * n:(dp.index + 1) * n]


def _ids(tokens, device):
    return torch.as_tensor(np.asarray(tokens) if not isinstance(
        tokens, torch.Tensor) else tokens, device=device).long()


def _hidden_local(W, ids, cfg, tp, remat=False):
    """The final hidden states (B_l, L, D) of this rank's rows."""
    L = ids.shape[1]
    grp = tp.group
    h = _embed(W["tok"], ids, tp)
    cos, sin = C.copy(W["cos"][:L], grp), C.copy(W["sin"][:L], grp)
    mask = _causal_mask(L, h.dtype, h.device)
    W = _whole_kv(W, cfg, tp)
    kv_shard = _kv_sharded(cfg, tp.size)
    for i in range(cfg["n_layers"]):
        Wi = {k: W[k][i] for k in LAYER_KEYS}
        if remat:
            h = checkpoint(_layer, h, Wi, cos, sin, mask, cfg, tp, kv_shard,
                           use_reentrant=False)
        else:
            h = _layer(h, Wi, cos, sin, mask, cfg, tp, kv_shard)
    return _rms(h, W["norm"])


def _head(W, h, tp):
    """Logits over the whole vocabulary from a column-sharded head."""
    logits = C.copy(h, tp.group) @ W["head_w"] + W["head_b"]
    return C.gather(logits, -1, tp.group)


def forward_logits(params, tokens, cfg, remat: bool = False):
    """Full-sequence causal forward -> (B, L, V) logits, the same on every
    rank. ``remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, non-reentrant): O(B·L·D) activation memory
    instead of O(n_layers·B·L·D), for one more forward."""
    mesh = mesh_of(params)
    tp, dp = _Axis(mesh, "tp"), _Axis(mesh, "dp")
    W = {k: local(v) for k, v in params.items()}
    ids = _rows(_ids(tokens, W["tok"].device), dp)
    logits = _head(W, _hidden_local(W, ids, cfg, tp, remat), tp)
    return C.gather(logits, 0, dp.group)


def _loss_local(W, tokens, targets, cfg, tp, dp, remat=False):
    dev = W["tok"].device
    ids, tgt = _ids(tokens, dev), _ids(targets, dev)
    logits = _head(W, _hidden_local(W, _rows(ids, dp), cfg, tp, remat), tp)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.take_along_dim(logp, _rows(tgt, dp)[..., None], dim=-1)
    return C.reduce(nll.sum() / tgt.numel(), dp.group)


def loss_fn(params, tokens, targets, cfg, remat: bool = False):
    """Mean next-token cross-entropy over the global batch, the same value
    on every rank. Its gradient on a rank covers that rank's rows: the
    train step sums the gradients over ``dp``."""
    mesh = mesh_of(params)
    W = {k: local(v) for k, v in params.items()}
    return _loss_local(W, tokens, targets, cfg, _Axis(mesh, "tp"),
                       _Axis(mesh, "dp"), remat)


def _like(new, old):
    """``new`` (a local block) placed as ``old`` is."""
    from torch.distributed.tensor import DTensor

    if isinstance(old, DTensor):
        return DTensor.from_local(new, old.device_mesh, old.placements,
                                  run_check=False, shape=old.shape,
                                  stride=old.stride())
    return new


def make_train_step(mesh, cfg, lr: float = 1e-3, remat: bool = False):
    """``step(params, tokens, targets) -> (params, loss)``: one SGD step of
    :func:`loss_fn` over the mesh, batch rows over ``dp``, weights over
    ``tp``; every floating parameter (the RoPE tables too, as in the JAX
    package) steps by its gradient, summed over ``dp``. ``remat`` as in
    :func:`forward_logits`. The new parameters keep the old placements; the
    loss is a plain 0-d tensor, the same on every rank. ``mesh=None`` is one
    device, on a dict of plain tensors."""
    mesh = None if mesh is None else as_mesh(mesh)
    tp, dp = _Axis(mesh, "tp"), _Axis(mesh, "dp")

    def step(params, tokens, targets):
        W = {k: local(v).detach().requires_grad_(local(v).is_floating_point())
             for k, v in params.items()}
        with torch.enable_grad():
            loss = _loss_local(W, tokens, targets, cfg, tp, dp, remat)
            keys = [k for k in W if W[k].requires_grad]
            grads = torch.autograd.grad(loss, [W[k] for k in keys],
                                        allow_unused=True)
        new = dict(params)
        with torch.no_grad():
            for k, g in zip(keys, grads):
                g = torch.zeros_like(W[k]) if g is None else g
                C.all_reduce_(g, dp.group)
                new[k] = _like(W[k] - lr * g, params[k])
        return new, loss.detach()

    return step


# ------------------------------ decoding ---------------------------------- #
def cache_shardings(mesh, cfg=None, kv_quant=None):
    """KV caches (N, B, S, Hkv, hd): batch over dp, heads over tp (the head
    axis replicated when ``Hkv % tp != 0``). ``kv_quant="int8"`` gives the
    pair of shardings of the (int8 data, (N, B, S, Hkv) scales) caches."""
    mesh = as_mesh(mesh)
    tp = mesh.shape.get("tp", 1)
    hkv = (cfg or {}).get("n_kv_heads")
    head = _ax(mesh, "tp") \
        if (hkv is None or tp <= 1 or hkv % tp == 0) else None
    data = named_sharding(mesh, None, _ax(mesh, "dp"), None, head, None)
    if kv_quant:
        return data, named_sharding(mesh, None, _ax(mesh, "dp"), None, head)
    return data


def empty_caches(mesh, cfg, batch: int, dtype=torch.float32, kv_quant=None):
    """Zeroed caches for ``batch`` rows as DTensors over
    :func:`cache_shardings` (int8 pairs with ``kv_quant``)."""
    mesh = as_mesh(mesh)
    N, S, H = cfg["n_layers"], cfg["max_seq_len"], cfg["n_heads"]
    hd = cfg["dim"] // H
    shape = (N, batch, S, cfg.get("n_kv_heads") or H, hd)
    dev = mesh.device

    def zeros(sh, shp, dt):
        return from_local(torch.zeros(sh.shard_shape(shp), dtype=dt,
                                      device=dev), sh, shp)

    if kv_quant:
        sd, ss = cache_shardings(mesh, cfg, kv_quant)
        return tuple((zeros(sd, shape, torch.int8),
                      zeros(ss, shape[:-1], torch.float32))
                     for _ in range(2))
    sh = cache_shardings(mesh, cfg)
    return zeros(sh, shape, dtype), zeros(sh, shape, dtype)


def _local_cache(c):
    return tuple(local(x) for x in c) if isinstance(c, tuple) else local(c)


def _forward_tokens_local(W, ck, cv, tokens, pos, cfg, tp, starts=None,
                          win=None):
    """This rank's rows ``tokens`` (B_l, L) at absolute ``pos`` over its
    cache blocks (written in place at rows [pos, pos + L), clamped into the
    cache); returns float32 logits (B_l, V) over the whole vocabulary at the
    last position."""
    B, L = tokens.shape
    H, D, S = cfg["n_heads"], cfg["dim"], cfg["max_seq_len"]
    if win is None or win > S:
        win = S
    q4 = "q4" in W
    hd = D // H
    g = H // (cfg.get("n_kv_heads") or H)
    kv_shard = _kv_sharded(cfg, tp.size)
    grp = tp.group
    h = _embed(W["tok"], tokens, tp)
    start = min(int(pos), S - L)  # dynamic_update_slice's clamp
    cos, sin = W["cos"][start:start + L], W["sin"][start:start + L]
    dev = h.device
    qpos = int(pos) + torch.arange(L, device=dev)[:, None]
    jpos = torch.arange(win, device=dev)[None, :]
    allowed = jpos <= qpos
    if starts is not None:
        allowed = (allowed[None] & (jpos[None] >= starts[:, None, None]))[
            :, None]
    mask = torch.zeros(allowed.shape, device=dev).masked_fill(
        ~allowed, float("-inf"))
    kvq = isinstance(ck, tuple)
    W = _whole_kv(W, cfg, tp)
    layer_keys = [k for k in W if k in ("in_norm", "post_norm")
                  or k.removesuffix("_q").removesuffix("_s") in _QUANT_MATS]
    Hl = (W["wq"].shape[-1] if "wq" in W else W["wq_s"].shape[-1]) // hd
    for i in range(cfg["n_layers"]):
        Wi = {k: W[k][i] for k in layer_keys}
        hn = _rms(h, Wi["in_norm"])
        q = _wmm(hn, Wi, "wq", q4).reshape(B, L, Hl, hd)
        k = _wmm(hn, Wi, "wk", q4).reshape(B, L, -1, hd)
        v = _wmm(hn, Wi, "wv", q4).reshape(B, L, -1, hd)
        q, k = _rope(q, cos, sin), _rope(k, cos, sin)
        if kvq:
            for c, x in ((ck, k), (cv, v)):
                c[0][i, :, start:start + L], c[1][i, :, start:start + L] = \
                    quantize_kv(x)
            kk, vv = ((c[0][i, :, :win].float()
                       * c[1][i, :, :win, :, None]).to(h.dtype)
                      for c in (ck, cv))
        else:
            ck[i, :, start:start + L] = k
            cv[i, :, start:start + L] = v
            kk, vv = ck[i, :, :win], cv[i, :, :win]
        kk, vv = _kv_heads(kk, vv, g, Hl, kv_shard, tp)
        s = torch.einsum("blhd,bmhd->bhlm", q.float(),
                         kk.float()) / math.sqrt(hd)
        p = torch.softmax(s + mask, dim=-1).to(h.dtype)
        att = torch.einsum("bhlm,bmhd->blhd", p, vv).reshape(B, L, Hl * hd)
        z = h + C.reduce(_wmm(att, Wi, "wo", q4, tp), grp)
        zn = _rms(z, Wi["post_norm"])
        gate, up = _wmm(zn, Wi, "gate", q4), _wmm(zn, Wi, "up", q4)
        h = z + C.reduce(_wmm((gate * torch.sigmoid(gate)) * up, Wi, "down",
                              q4, tp), grp)
    hl = _rms(h, W["norm"])[:, -1]
    if "head_q" in W:
        logits = _qmm(hl, W["head_q"], W["head_s"], q4).float()
    else:
        logits = (hl @ W["head_w"]).float()
    return C.gather(logits + W["head_b"].float(), -1, grp)


def forward_tokens(params, ck, cv, tokens, pos, cfg, starts=None,
                   win=None, emit_logits=False):
    """Cache-threaded forward of ``tokens`` (B, L) at absolute ``pos``:
    returns ``(next_token (B,), ck, cv)``, or with ``emit_logits`` the
    float32 logits (B, V), the same on every rank. ``ck``/``cv`` are
    DTensors over :func:`cache_shardings` (or plain tensors on one device),
    written in place; ``(data, scale)`` pairs are the int8 KV cache, the
    fresh rows quantized by ``ops.decode_step.quantize_kv`` and the window
    read dequantized. ``starts`` (B,) lower-bounds each row's attention
    (the server's slot recycling), ``win`` bounds the read to cache rows
    [0, win). A :func:`quantize_params` dict runs the quantized products."""
    mesh = mesh_of(params)
    tp, dp = _Axis(mesh, "tp"), _Axis(mesh, "dp")
    W = {k: local(v) for k, v in params.items()}
    dev = W["tok"].device
    ids = _rows(_ids(tokens, dev), dp)
    st = None if starts is None else _rows(
        torch.as_tensor(starts, device=dev), dp)
    logits = _forward_tokens_local(W, _local_cache(ck), _local_cache(cv),
                                   ids, pos, cfg, tp, st, win)
    logits = C.gather(logits, 0, dp.group)
    if emit_logits:
        return logits, ck, cv
    return torch.argmax(logits, dim=-1).to(torch.int32), ck, cv


def make_decode_fns(mesh, cfg):
    """``(prefill, decode)`` over the mesh: ``prefill(params, ck, cv,
    tokens, pos) -> (tok, ck, cv)`` and ``decode(params, ck, cv, last_tok,
    pos, n_steps) -> (ck, cv, toks (n_steps, B))``, greedy."""

    @torch.no_grad()
    def prefill(params, ck, cv, tokens, pos):
        return forward_tokens(params, ck, cv, tokens, pos, cfg)

    @torch.no_grad()
    def decode(params, ck, cv, last_tok, pos, n_steps):
        tok, toks = last_tok, []
        for i in range(n_steps):
            tok, ck, cv = forward_tokens(params, ck, cv, tok[:, None],
                                         pos + i, cfg)
            toks.append(tok)
        return ck, cv, torch.stack(toks)

    return prefill, decode


def generate(params, prompt, max_new_tokens: int, mesh, cfg,
             dtype=torch.float32):
    """Greedy generation over the mesh: (B, max_new_tokens) int32 ids as a
    NumPy array on every rank, rows over ``dp``, products over ``tp``.
    Raises ``ValueError`` when the prompt and the new tokens would pass
    ``max_seq_len`` (the cache writes would clamp to its end)."""
    S = cfg["max_seq_len"]
    prompt = np.asarray(prompt)
    B, L = prompt.shape
    if L + max_new_tokens - 1 > S:
        raise ValueError(
            f"prompt length {L} + max_new_tokens {max_new_tokens} - 1 "
            f"exceeds max_seq_len {S}")
    ck, cv = empty_caches(mesh, cfg, B, dtype)
    prefill, decode = make_decode_fns(mesh, cfg)
    tok, ck, cv = prefill(params, ck, cv, prompt, 0)
    first = tok.cpu().numpy()[:, None]
    if max_new_tokens == 1:
        return first
    ck, cv, toks = decode(params, ck, cv, tok, L, max_new_tokens - 1)
    return np.concatenate([first, toks.cpu().numpy().T], axis=1)
