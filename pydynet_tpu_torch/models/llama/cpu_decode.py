"""The NumPy BLAS decode lane: ``generate(fused="numpy")`` (counterpart of
``pydynet_tpu/models/llama/cpu_decode.py``).

A B=1 greedy or sampled decode as a NumPy loop on the host, whose matvecs
are straight BLAS GEMV calls with no dispatch layer: on a CPU the decode is
memory-bound, every token streaming the f32 weights through one core, and
this is the reference's own design. ``generate(fused=None)`` takes it for
a B=1, f32-native model on the CPU with no ``quant``, ``kv_quant`` or
``dtype``, as the JAX package does; ``fused="numpy"`` asks for it anywhere
(a model on the card gives float32 host copies of its weights).

* Matrices are stored (out, in) C-contiguous and applied as ``W @ x``; the
  port's ``Llama._weights`` snapshot is already in that layout.
* QKV and gate/up are fused into single GEMVs; the RMS-norm gains are
  folded into the columns of the matrix that consumes the normed vector,
  so a norm is ``x / rms`` with no scaling pass.
* Head-major KV caches, (N, Hkv, S, hd): attention is two batched GEMVs
  over contiguous views, and GQA folds the query-head group into the batch
  axis, so no K/V repeat is made.
* RoPE rotates interleaved (2i, 2i+1) pairs.

The arithmetic is the JAX module's, operation for operation, so both
packages' lanes give the same bits on the same weights. Sampling draws
through the port's :class:`~.model.Sampler` on CPU tensors: the threefry
key stream of ``PRNGKey(seed)`` split once a token, the repetition penalty
over the prompt's and the drawn tokens, temperature, the top-k and top-p
filters, a Gumbel draw; it is the JAX package's key stream bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


def _f32(x):
    return x if x.dtype == np.float32 else x.astype(np.float32)


def build_np_weights(model):
    """NumPy decode-weight snapshot, laid out for single-core BLAS: every
    matrix (out, in) C-contiguous float32 on the host, the RMS-norm gains
    folded into the columns of the matrix that consumes the normed vector.
    Built from ``model._weights()`` (LoRA updates and the layer stacking
    ride along); ``generate`` caches it under the ``("numpy",)`` key."""
    raw = {k: v.detach().float().cpu().numpy()
           for k, v in model._weights(None).items()}
    N = model.n_layers

    def c(a):
        return np.ascontiguousarray(a)

    w = {
        "tok": raw["tok"],
        "cos": raw["cos"],
        "sin": raw["sin"],
        # the gains scale the input axis: the columns of (out, in)
        "wqkv": c(raw["wqkv"]) * raw["in_norm"][:, None, :],
        "wo": c(raw["wo"]),
        "wgu": c(raw["wgu"]) * raw["post_norm"][:, None, :],
        "down": c(raw["down"]),
        "head_w": c(raw["head_w"]) * raw["norm"][None, :],
        "head_b": raw["head_b"],
    }
    assert all(w[k].flags.c_contiguous
               for k in ("wqkv", "wo", "wgu", "down", "head_w"))
    assert w["wqkv"].shape[0] == N
    return w


def _inv_rms(x):
    x32 = _f32(x)
    return 1.0 / np.sqrt(np.mean(x32 * x32) + 1e-6)


def _rope(x, cos, sin):
    """x (heads, hd); cos/sin (hd//2,): interleaved-pair rotation."""
    xr = x[..., 0::2]
    xi = x[..., 1::2]
    out = np.empty_like(x)
    out[..., 0::2] = xr * cos - xi * sin
    out[..., 1::2] = xr * sin + xi * cos
    return out


class _State:
    """Head-major KV caches, (N, Hkv, S, hd): the [i, :, :pos+1] slices are
    views whose batched matmuls need no copy."""

    def __init__(self, model, dtype):
        N, S = model.n_layers, model.max_seq_len
        Hkv, hd = model.n_kv_heads, model.head_dim
        self.k = np.zeros((N, Hkv, S, hd), dtype)
        self.v = np.zeros((N, Hkv, S, hd), dtype)


def _advance(model, w, st, tok, pos, want_logits):
    """One token through all layers; returns f32 logits (V,) or None."""
    N = model.n_layers
    H, Hkv, hd = model.n_heads, model.n_kv_heads, model.head_dim
    g = H // Hkv
    D = H * hd
    Dkv = Hkv * hd
    F = model.ffn_dim
    scale = 1.0 / np.sqrt(hd)

    h = w["tok"][tok]
    cos = w["cos"][pos]
    sin = w["sin"][pos]
    m = pos + 1
    for i in range(N):
        # in_norm gain is folded into wqkv's columns
        qkv = w["wqkv"][i] @ (h * _inv_rms(h))     # (D+2*Dkv,) GEMV
        q = _rope(qkv[:D].reshape(H, hd), cos, sin)
        k = _rope(qkv[D:D + Dkv].reshape(Hkv, hd), cos, sin)
        st.k[i, :, pos] = k
        st.v[i, :, pos] = qkv[D + Dkv:].reshape(Hkv, hd)
        kk = st.k[i, :, :m]                        # (Hkv, m, hd) view
        vv = st.v[i, :, :m]
        # scores: fold the query-head group into the batch axis, so GQA
        # needs no K/V repeat.  (Hkv, m, hd) @ (Hkv, hd, g) -> (Hkv, m, g)
        qg = q.reshape(Hkv, g, hd)
        s = _f32(kk @ qg.transpose(0, 2, 1)) * scale
        s -= s.max(axis=1, keepdims=True)
        p = np.exp(s)
        p /= p.sum(axis=1, keepdims=True)
        # (Hkv, g, m) @ (Hkv, m, hd) -> (Hkv, g, hd) == (H, hd)
        att = (p.transpose(0, 2, 1).astype(h.dtype, copy=False)
               @ vv).reshape(D)
        z = h + w["wo"][i] @ att
        gu = w["wgu"][i] @ (z * _inv_rms(z))       # (2F,) GEMV
        gate, up = gu[:F], gu[F:]
        with np.errstate(over="ignore"):           # exp(-x)->inf is exact 0
            ff = (gate / (1.0 + np.exp(-gate))) * up
        h = z + w["down"][i] @ ff
    if not want_logits:
        return None
    hn = _f32(h * _inv_rms(h))
    return w["head_w"] @ hn + w["head_b"]


def _make_sampler(model, temperature, top_k, top_p, seed,
                  repetition_penalty, prompt_ids):
    """Per-token draw for the lane: the port's :class:`~.model.Sampler` at
    B=1 on the CPU, the prompt's tokens marked seen when a repetition
    penalty is on, one key split a token."""
    from .model import Sampler

    s = Sampler(1, model.vocab_size, torch.device("cpu"), temperature,
                top_k, top_p, seed, repetition_penalty)
    s.mark_prompt(np.asarray(prompt_ids)[None])

    def sample(logits):
        return int(s.draw(torch.from_numpy(_f32(logits))[None])[0])

    return sample


def numpy_decode(model, w, input_ids, total, temperature=None, top_k=None,
                 top_p=None, seed=0, repetition_penalty=None):
    """Decode generator: yields np int token ids (host scalars), starting
    with the token after the prompt, until the sequence reaches ``total``
    (``Llama.generate``'s total-length contract). Greedy by default;
    ``temperature > 0`` samples through :func:`_make_sampler`. B == 1
    only."""
    ids = [int(t) for t in np.asarray(input_ids).reshape(-1)]
    L = len(ids)
    if temperature is not None and temperature > 0:
        pick = _make_sampler(model, temperature, top_k, top_p, seed,
                             repetition_penalty, ids)
    else:
        def pick(logits):
            return int(np.argmax(logits))
    st = _State(model, w["tok"].dtype)
    for pos, tok in enumerate(ids):           # prefill, one token at a time
        logits = _advance(model, w, st, tok, pos, pos == L - 1)
    tok = pick(logits)
    yield tok
    for pos in range(L, total - 1):
        logits = _advance(model, w, st, tok, pos, True)
        tok = pick(logits)
        yield tok
