"""Prompt-lookup speculative decoding on the scan lane (the port of
``pydynet_tpu/models/llama/speculative.py``).

The next ``K`` tokens are drafted by an n-gram lookup over the stream so far
(the text is its own draft model), all K are verified in one teacher-forced
(1, K + 1) forward, and the longest verified prefix is kept with the token
the verifier gives after it. Greedy, every emitted token is the target's
argmax at its own position, so the stream is ``generate(fused=False)``'s;
sampled, the accept/residual rule of :func:`spec_accept_extra` emits each
token from the filtered sampling distribution.

Cache discipline: the verify forward writes K + 1 KV rows at [n - 1,
n + K - 1]. Rows past the accepted prefix hold rejected tokens' KV, but the
next iteration starts at n' = n + a + 1 <= n + K and rewrites every such
row before a query can attend it (a query at position p reads rows <= p,
and the forward that computes p writes them). The same holds for the
``seq`` buffer.

The JAX package runs the loop as one ``lax.while_loop`` on the device; here
it is a Python loop that reads the accepted count back once an iteration.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import random as prandom
from .model import Sampler, bucket_prompt, filter_logits


def lookup_draft_rows(seq, n, K: int, g: int):
    """For every row of a (B, S) token buffer at its own position ``n``
    (B,) on the device, the K tokens that followed the most recent
    strictly-earlier occurrence of the row's trailing g-gram
    ``seq[b, n - g:n]`` (the JAX package's ``lookup_draft``, vmapped as its
    speculative server does): the gram's start clamped into the buffer and
    the draft's start clipped to [0, S - K], as ``dynamic_slice`` clamps
    them. Without an earlier occurrence the draft is the window at [0, K)
    or wherever the clip puts it: verification rejects a bad draft, so it
    changes only the speed. Returns (B, K) drafts, computed with no read
    back to the host."""
    B, S = seq.shape
    dev = seq.device
    n = n.long()[:, None]
    g0 = torch.clamp(n - g, 0, S - g)
    gram = seq.gather(1, g0 + torch.arange(g, device=dev))          # (B, g)
    pidx = torch.arange(S, device=dev)
    # wins[b, p, i] = seq[b, (p + i) % S], jnp.roll's windows
    wins = seq[:, (pidx[:, None] + torch.arange(g, device=dev)) % S]
    match = (wins == gram[:, None]).all(-1) & (pidx <= n - g - 1)  # (B, S)
    pstar = torch.where(match, pidx, -1).amax(1, keepdim=True)
    dstart = torch.clamp(pstar + g, 0, S - K)
    return seq.gather(1, dstart + torch.arange(K, device=dev))


def lookup_draft(seq, n: int, K: int, g: int):
    """:func:`lookup_draft_rows` for one (S,) buffer at a host position
    ``n``: (K,) tokens on ``seq``'s device."""
    return lookup_draft_rows(seq[None], torch.full((1,), n, device=seq.device),
                             K, g)[0]


def spec_accept_extra(logits, draft, key, temperature, top_k=None,
                      top_p=None):
    """One speculative-sampling step with a deterministic draft (the JAX
    package's ``spec_accept_extra``): ``logits`` (K + 1, V) float32 at the
    positions n..n + K, ``draft`` (K,), ``key`` a (2,) threefry key.
    Returns ``(toks (K + 1,), a)``: ``toks[:a]`` are the accepted drafts and
    ``toks[a]`` the extra token, drawn from the residual at the first
    rejection (the filtered distribution without the rejected draft token)
    or from the bonus row when all K are accepted; ``a`` a 0-d tensor.

    Draft j is accepted while ``u_j < p_j(draft_j)``, u from
    ``uniform(kacc, (K,))`` in float64 (JAX's default type under x64, which
    the JAX package runs), so every emitted token follows the filtered
    sampling distribution."""
    K = draft.shape[0]
    V = logits.shape[-1]
    dev = logits.device
    f = filter_logits(logits, temperature, top_k, top_p)        # (K + 1, V)
    logp = f - torch.logsumexp(f, -1, keepdim=True)
    kacc, kres = prandom.split(key)
    u = prandom.uniform(kacc, (K,), dtype=torch.float64)
    ar = torch.arange(K, device=dev)
    p_draft = torch.exp(logp[ar, draft.long()])
    a = torch.cumprod((u < p_draft.double()).to(torch.int32), 0).sum()
    row = logp.index_select(0, a.reshape(1))[0]
    da = draft[torch.clamp(a, max=K - 1)]
    row = torch.where((a < K) & (torch.arange(V, device=dev) == da),
                      float("-inf"), row)
    extra = prandom.categorical(kres, row).to(draft.dtype)
    toks = torch.cat([draft, draft.new_zeros(1)])
    # rows past a are never final (rewritten before they are read)
    toks = torch.where(torch.arange(K + 1, device=dev) < a, toks, extra)
    return toks, a


@torch.no_grad()
def generate_speculative(model, input_ids, max_new_tokens: int, *,
                         draft_k: int = 7, ngram: int = 3, dtype=None,
                         temperature: float = 0.0, top_k: int = None,
                         top_p: float = None, seed: int = 0):
    """Generation with prompt-lookup speculation at B=1 on the scan lane's
    float weights (``generate(fused=False)``'s snapshot). Returns ``(tokens,
    stats)``: the (total - L,) int64 array of generated ids, equal greedy to
    ``generate(fused=False)``'s stream, and ``{"iterations",
    "accepted_drafts", "tail_tokens", "tokens", "tokens_per_dispatch"}``.
    ``max_new_tokens`` bounds the total length, prompt included.

    ``temperature > 0`` verifies by :func:`spec_accept_extra`, the key
    stream threaded as the JAX package threads it: ``PRNGKey(seed)`` draws
    the prefill token (split once), one split of what is left feeds the
    loop (split once an iteration), and the remainder the tail of plain
    steps after it (split once a step), so the stream is the JAX package's
    for the same seed up to rounding at near-ties. It is equal in law to
    ``generate(temperature=...)``'s, not token for token."""
    ids = np.asarray(input_ids)
    if ids.ndim != 2 or ids.shape[0] != 1:
        raise ValueError("speculative decoding takes one prompt (B=1)")
    L = ids.shape[1]
    S = model.max_seq_len
    K, g = int(draft_k), int(ngram)
    if not (1 <= g < S and 1 <= K <= S - 2):
        raise ValueError(f"draft_k={K}, ngram={g} outside the cache "
                         f"(max_seq_len {S})")
    total = min(max_new_tokens, S)
    if total <= L:
        return np.zeros((0,), np.int64), {
            "iterations": 0, "accepted_drafts": 0, "tokens": 0,
            "tokens_per_dispatch": 0.0}
    sampling = temperature is not None and temperature > 0
    w = model._weights(dtype)
    dev = model.device
    ck, cv = model._empty_caches(1, w["tok"].dtype)
    sampler = (Sampler(1, model.vocab_size, dev, temperature, top_k, top_p,
                       seed) if sampling else None)
    ids_pad, last_idx = bucket_prompt(ids, L, S)
    tok = model.prefill(w, ck, cv, ids_pad, last_idx, sampler=sampler)
    seq = torch.zeros(S, dtype=torch.int64, device=dev)
    seq[:L] = torch.as_tensor(ids[0], dtype=torch.int64, device=dev)
    seq[L] = tok[0]
    if sampling:
        sampler.key, key = prandom.split(sampler.key)
    n, it, acc = L + 1, 0, 0
    while n + K + 1 <= total:
        draft = lookup_draft(seq, n, K, g)
        toks_in = torch.cat([seq[n - 1:n], draft])[None]   # (1, K + 1)
        logits = model.forward_logits_one(w, ck, cv, toks_in, n - 1,
                                          all_positions=True)
        if sampling:
            key, sub = prandom.split(key)
            toks, a = spec_accept_extra(logits[0], draft, sub,
                                        sampler.temperature, top_k, top_p)
        else:
            # toks[j]: the target's greedy token for position n + j
            toks = logits[0].argmax(-1)
            a = torch.cumprod((draft == toks[:K]).to(torch.int32), 0).sum()
        # all K + 1 land in seq; only [n, n + a] are final
        seq[n:n + K + 1] = toks
        a = int(a)  # the loop's one read back an iteration
        n, it, acc = n + a + 1, it + 1, acc + a
    rem = total - n  # fewer than K + 1 left: plain steps from the last token
    if rem > 0:
        toks = model.decode_chunk_plain(w, ck, cv, seq[n - 1:n], n - 1, rem,
                                        sampler=sampler)
        seq[n:n + rem] = toks[:, 0]
    out = seq[L:total].cpu().numpy().astype(np.int64)
    dispatches = it + max(rem, 0) + 1  # and the prefill
    stats = {"iterations": it, "accepted_drafts": acc,
             "tail_tokens": max(rem, 0), "tokens": int(total - L),
             "tokens_per_dispatch": float(total - L) / max(dispatches, 1)}
    return out, stats
