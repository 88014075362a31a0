"""Llama (stories15M to Llama-2-7B geometry) in PyTorch: the port of
``pydynet_tpu/models/llama/model.py``.

The module tree and dotted parameter names are the JAX package's
(``layers.{i}.attention.Q.weight``, ..., ``lm_head.bias``); Linear weights
are torch's (out, in). Four ways through the model:

* the eager module path, ``model(ids, start_pos)``, with the per-module KV
  caches the reference keeps in eval mode (used by
  ``utils.fidelity.greedy_truth``);
* the training path (``finetune_step``/``finetune_steps``): the module path
  in train mode, no caches, causal attention at ``start_pos == 0`` through
  ``nn.functional.scaled_dot_product_attention`` and the flash kernels (K3
  forward, K4 backward on a GPU), the JAX package's cross-entropy and its
  optimizers (``optim``);
* the scan lane (``generate(fused=False)``, the JAX package's XLA
  ``lax.scan`` lane): a dense prefill and a per-token decode over
  layer-stacked weights, any batch. A long prompt's prefill (on either
  lane, ``flash_prefill``) takes its attention through the flash forward
  (K3) instead of the dense (L, L) scores. With ``quant="int8"`` or
  ``"int4"`` its four layer matmuls and the head, and with
  ``"int8-head"`` the head, run
  through ``ops.gemv_quant`` (the quantized-matmul kernels K5-K7 on a GPU):
  every layer product through ``qmatmul_stacked`` on the stacked weights
  with a device layer index, the head through ``qmatmul``.
  ``kv_quant="int8"`` keeps its caches as (int8 rows, per-(row, head)
  float32 scales) pairs, with any weight format. Beam search
  (``generate_beam``) and prompt-lookup speculative decoding
  (``generate_speculative``, ``speculative.py``) run on this lane;
* the fused lane: the same dense prefill, then one call per token of
  ``ops.decode_step.fused_decode_token`` at B=1 or
  ``fused_decode_token_batched`` at B>1, which launch the hand-written CUDA
  kernel chains on a GPU (weights f32/bf16, optionally the int8 head, or
  int8 or int4 layers and head, the prefill token staying on the float
  weights as in the JAX package; ``kv_quant="int8"`` takes the batched
  kernel's int8 KV cache, at B=1 too; any B). A grouped-query model
  decodes on the kernels' narrow cache, (N, [B,] S, Hkv * hd), or with
  int8/int4 layers on the expanded (MHA) layout, as in the JAX package.

LoRA adapters (``add_lora``, ``nn/modules/lora.py``) run in the module
path's forward as a low-rank term; every decode snapshot (``_weights``,
``_weights_xq``, and the fused lane's, built on ``_weights``) folds each
unmerged adapter's ``A B * scaling`` into its weight, the array
``merge_lora`` stores, so every lane decodes alike before and after a
merge. ``forward_logits_one``'s per-row positions serve the speculative
server (``serve_spec.py``).

``fused=None`` routes: the NumPy BLAS lane (``cpu_decode.py``) for a B=1
float32 model on the CPU with no ``quant``, ``kv_quant`` or ``dtype``, as
the JAX package does; the fused lane wherever the port's fused kernels
take the model, weight format and batch; else the scan lane where the JAX
package's rule (``_tpu_fused_supported``, its ``_fused_decode_supported``)
sends the model there, as it does a Llama-2-7B model with int8 or int4
weights; else it raises, naming the ROADMAP.md item that would port the
missing kernel. ``fused=True``, ``False`` and ``"numpy"`` ask for a lane.
float32, bfloat16 and float16 run on every lane (``check_dtype``).

Semantics kept from the JAX package: interleaved RoPE pairs; bucketed
prefill read at ``last_idx - 1``; decoding starts at ``pos = L`` on the
prefill token; ``max_new_tokens`` bounds the total length, capped at
``max_seq_len``. bf16 rounds differently per lane, as there: the scan lane
rounds per layer in bf16, the fused lane keeps the residual in f32.

Sampling (``generate(temperature > 0)``) runs on either lane: the fused
lane's kernels emit the float32 logits (their ``emit_logits`` mode) and the
sampling stage below draws from them, from the JAX package's threefry key
stream, so a sampled stream is the JAX package's for the same seed up to
float rounding at near-ties.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ... import random as prandom
from ...device import resolve
from ...nn.functional import scaled_dot_product_attention
from ...nn.modules.loss import CrossEntropyLoss
from ...nn.modules.norm import RMSNorm, rms_norm
from ...nn.utils import clip_grad_norm_
from ...ops import decode_step as dsk
from ...ops import flash_attention as fa
from ...ops import gemv_quant as gq
from ...ops.quant import quantize_int4, quantize_int8
from ...nn.modules.module import Module, ModuleList

# tokens decoded between two reads back to the host
DECODE_CHUNK = 512
QUANTS = (None, "int8-head", "int8", "int4")
# the shortest (padded) prompt whose prefill attention takes the flash
# forward (K3) on a GPU: chip_smoke.py's long-prompt phase times the 7B
# geometry's int8 prefill on both routes at padded lengths 256 to 4,096 on
# an H100, and flash was the faster at every one of them (PERF.md)
FLASH_PREFILL_MIN = 256
# the scan lane's matrices: stacked (L, K, N) name -> the per-layer modules
# concatenated along the output axis, as in ``_weights``
_LAYER_MATS = {"wqkv": ("attention.Q", "attention.K", "attention.V"),
               "wo": ("attention.O",), "wgu": ("ffn.gate", "ffn.up"),
               "down": ("ffn.down",)}


def compute_cos_sin_cache(head_dim: int, max_seq_len: int, base: int = 10000):
    """Interleaved-pair RoPE tables, each (max_seq_len, head_dim // 2)
    float32, computed exactly as the JAX package does for a float32 model
    (NumPy, frequencies rounded to float32 before cos/sin)."""
    inv_freq = 1.0 / (base**(np.arange(0, head_dim, 2)[:head_dim // 2] /
                             head_dim))
    freqs = np.outer(np.arange(max_seq_len), inv_freq).astype(np.float32)
    return torch.from_numpy(np.cos(freqs)), torch.from_numpy(np.sin(freqs))


def _rope_pure(x, cos, sin):
    """Rotate interleaved (real, imag) feature pairs. x (..., L, H, hd);
    cos/sin (L, hd // 2), broadcast over heads."""
    xr, xi = x[..., 0::2], x[..., 1::2]
    cos, sin = cos[..., None, :], sin[..., None, :]
    return torch.stack([xr * cos - xi * sin, xr * sin + xi * cos],
                       dim=-1).reshape(x.shape)


# ------------------------------- sampling ---------------------------------
# The JAX package's sampling stage (``pydynet_tpu/models/llama/model.py:
# 86-233``) is XLA code around its decode kernels, so here it is plain torch
# on the device: the repetition penalty, temperature, the top-k and nucleus
# cutoffs by a sort-free radix select, and a Gumbel draw from the threefry
# key stream of ``random.py``, which reproduces ``jax.random``'s bits. Every
# scalar that reaches a device tensor is a Python number or a tensor already
# on the device, so a step copies nothing from the host.
_M32 = 0xFFFFFFFF


def _radix_cutoff(logits, weight, thresh, strict: bool):
    """Exact per-row threshold select without a sort (the JAX package's
    ``_radix_cutoff``). Returns (B, 1) float32: the largest value ``c``
    present in each (B, V) float32 ``logits`` row such that
    ``sum(weight * (logits >= c)) >= thresh`` (``> thresh`` when
    ``strict``), or -inf when no value qualifies (keep everything). With
    ``weight = 1`` and ``thresh = k`` it is the k-th largest value,
    duplicates counted; with ``weight = probs`` and ``thresh = top_p``
    (strict) it is the nucleus cutoff, ties kept. ``thresh`` is a Python
    number or a (B, 1) float32 tensor.

    A 4-bit-at-a-time descent over the monotone keys of the float32 bit
    patterns (the int32 view lifted to int64 and masked to 32 bits): 8
    rounds of 16 compare-and-sum passes over the row."""
    bits = logits.float().contiguous().view(torch.int32).to(torch.int64) \
        & _M32
    keys = torch.where(bits >> 31 == 0, bits | 0x80000000, ~bits & _M32)
    nib = torch.arange(16, dtype=torch.int64, device=logits.device)
    base = torch.zeros(logits.shape[0], 1, dtype=torch.int64,
                       device=logits.device)
    for shift in range(28, -1, -4):
        cand = base | (nib << shift)                           # (B, 16)
        mass = torch.where(keys[:, :, None] >= cand[:, None, :],
                           weight[:, :, None], 0.0).sum(1)
        ok = mass > thresh if strict else mass >= thresh  # non-increasing
        # the largest qualifying nibble; none -> 0 (the keep-all case)
        j = (ok.sum(1, keepdim=True) - 1).clamp_(min=0)
        base = cand.gather(1, j)
    fmass = torch.where(keys >= base, weight, 0.0).sum(1, keepdim=True)
    vbits = torch.where(base >> 31 != 0, base & 0x7FFFFFFF, ~base & _M32)
    vbits = torch.where(vbits >= 1 << 31, vbits - (1 << 32), vbits)
    val = vbits.to(torch.int32).view(torch.float32)
    dead = fmass <= thresh if strict else fmass < thresh
    return torch.where(dead, float("-inf"), val)


def _divisor(x, like):
    """``x`` as a float32 divisor on ``like``'s device: a tensor is used as
    it is; a Python number becomes a float32 tensor, so the quotient is a
    true division as in jnp (a Python scalar divisor is a product with its
    reciprocal on a GPU)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _penalize(logits, seen, repetition_penalty):
    """HF repetition penalty on the ``seen`` tokens: positive logits divided
    by the penalty, negative multiplied."""
    rp = _divisor(repetition_penalty, logits)
    pen = torch.where(logits > 0, logits / rp, logits * rp)
    return torch.where(seen, pen, logits)


def filter_logits(logits, temperature, top_k=None, top_p=None, seen=None,
                  repetition_penalty=None):
    """The filtering stage of :func:`sample_logits` (the JAX package's
    ``filter_logits``): (B, V) float32 logits -> temperature-scaled logits
    with every filtered-out token at -inf. ``temperature`` and
    ``repetition_penalty`` are Python numbers or float32 tensors on the
    device; ``top_k``/``top_p`` Python numbers or None. Both filters mask
    the logits below an exact per-row cutoff (:func:`_radix_cutoff`); every
    token equal to the cutoff is kept, and the nucleus rule is strict, so
    ``top_p = 0`` keeps the best token alone."""
    if repetition_penalty is not None and seen is not None:
        logits = _penalize(logits, seen, repetition_penalty)
    t = _divisor(temperature, logits)
    logits = logits / torch.clamp(t, min=1e-6)
    if top_k is not None:
        kth = _radix_cutoff(logits, torch.ones_like(logits),
                            float(int(top_k)), strict=False)
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p is not None:
        probs = torch.exp(logits - torch.logsumexp(logits, -1, keepdim=True))
        cutoff = _radix_cutoff(logits, probs, float(top_p), strict=True)
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    return logits


def sample_logits(logits, key, temperature, top_k=None, top_p=None,
                  seen=None, repetition_penalty=None):
    """Next-token ids (B,) from (B, V) float32 logits (the JAX package's
    ``sample_logits``): :func:`filter_logits`, then one Gumbel draw with
    the (2,) threefry ``key`` over the whole (B, V) array
    (``random.categorical``)."""
    logits = filter_logits(logits, temperature, top_k, top_p, seen,
                           repetition_penalty)
    return prandom.categorical(key, logits)


def filter_logits_per_row(logits, temperature, top_k, top_p, seen=None,
                          repetition_penalty=None):
    """:func:`filter_logits` with per-row (B,) tensor parameters on the
    device (the server's per-request sampling): ``temperature`` float32
    (rows <= 0 clamp to 1e-6 here and take the exact argmax in
    :func:`sample_logits_per_row`), ``top_k`` int (V keeps all), ``top_p``
    float32 (1.0 keeps all: ``p >= 1`` is an explicit off-switch, since
    rounding can push the total mass an ulp past 1)."""
    if repetition_penalty is not None and seen is not None:
        logits = _penalize(logits, seen, repetition_penalty[:, None])
    logits = logits / torch.clamp(temperature, min=1e-6)[:, None]
    kth = _radix_cutoff(logits, torch.ones_like(logits),
                        top_k.float()[:, None], strict=False)
    logits = torch.where(logits < kth, float("-inf"), logits)
    probs = torch.exp(logits - torch.logsumexp(logits, -1, keepdim=True))
    cutoff = _radix_cutoff(logits, probs, top_p.float()[:, None], strict=True)
    cutoff = torch.where(top_p[:, None] >= 1.0, float("-inf"), cutoff)
    return torch.where(logits < cutoff, float("-inf"), logits)


def sample_logits_per_row(logits, key, temperature, top_k, top_p, seen=None,
                          repetition_penalty=None):
    """:func:`sample_logits` with per-row (B,) parameters: rows with
    ``temperature > 0`` draw from the filtered distribution, the others
    take the exact argmax of ``logits`` (ties to the lowest index, as the
    greedy kernels). ``key`` is one (2,) key for the whole array or (B, 2)
    per-row keys, each row drawing from its own (``vmap(categorical)``), so
    a served request's stream depends only on its prompt, parameters and
    key."""
    greedy = torch.argmax(logits, dim=-1)
    f = filter_logits_per_row(logits, temperature, top_k, top_p, seen,
                              repetition_penalty)
    return torch.where(temperature > 0, prandom.categorical(key, f), greedy)


def _mark_seen(seen, toks):
    """``seen[b, toks[b]] = True`` for every row, in place (the JAX
    package's functional ``_mark_seen``); returns ``seen``."""
    seen[torch.arange(seen.shape[0], device=seen.device), toks.long()] = True
    return seen


class Sampler:
    """The sampled decode's state for ``generate``, on the model's device:
    the threefry key (``PRNGKey(seed)``), the temperature and repetition
    penalty as float32 device tensors, and the (B, V) ``seen`` marks of the
    repetition penalty. :meth:`draw` splits the key as the JAX package's
    scans do (``key, sub = split(key)``), draws with ``sub`` through
    :func:`sample_logits` and marks the drawn tokens, so the port's sampled
    stream is the JAX package's for the same seed, token for token wherever
    no two perturbed scores are within the two frameworks' rounding."""

    def __init__(self, batch: int, vocab: int, device, temperature: float,
                 top_k=None, top_p=None, seed: int = 0,
                 repetition_penalty=None):
        self.key = prandom.PRNGKey(seed, device)
        self.temperature = torch.tensor(float(temperature),
                                        dtype=torch.float32, device=device)
        self.top_k, self.top_p = top_k, top_p
        self.rep = None if repetition_penalty is None else torch.tensor(
            float(repetition_penalty), dtype=torch.float32, device=device)
        # seen only feeds the repetition penalty
        self.seen = None if self.rep is None else torch.zeros(
            batch, vocab, dtype=torch.bool, device=device)

    def mark_prompt(self, ids, last_idx=None):
        """Mark the prompt's tokens seen, the bucket padding past
        ``last_idx`` excluded."""
        if self.seen is not None:
            ids = torch.as_tensor(np.asarray(ids)[:, :last_idx],
                                  dtype=torch.long, device=self.seen.device)
            self.seen.scatter_(1, ids, True)

    def draw(self, logits):
        """The next tokens (B,) int32 from (B, V) float32 logits."""
        keys = prandom.split(self.key)
        self.key = keys[0]
        nxt = sample_logits(logits.float(), keys[1], self.temperature,
                            self.top_k, self.top_p, self.seen, self.rep)
        if self.seen is not None:
            _mark_seen(self.seen, nxt)
        return nxt.to(torch.int32)


def flash_prefill_mode(weights, L: int) -> bool:
    """Whether a pure-causal prefill of ``L`` tokens takes the flash
    forward (the JAX package's routing rule, ``model.py:264``, for
    ``generate`` and ``LlamaServer`` admission): on a GPU from
    ``FLASH_PREFILL_MIN`` tokens on, where the dense route's (L, L) float32
    scores cost more than K3's blocks; never on the CPU, where the kernel's
    plain version is a test lane (tests pass ``True``)."""
    return L >= FLASH_PREFILL_MIN and weights["tok"].device.type == "cuda"


def check_dtype(dtype):
    """Raise ``NotImplementedError`` for a ``dtype`` the port does not
    decode in (``generate``, ``LlamaServer`` and the speculative server
    share it): float32, bfloat16 and float16 run on every lane and route,
    each through the kernels' own instances for that type, as the JAX
    package runs them; nothing is rerouted."""
    if dtype not in (None, torch.float32, torch.bfloat16, torch.float16):
        raise NotImplementedError(f"dtype {dtype}: use float32, bfloat16 "
                                  "or float16")


def not_ported(what: str, item: str):
    """Raise for an option this port does not run yet, naming its item in
    ROADMAP.md's queue 1."""
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1, '{item}')")


# the B=1 step's seven layer matrices, in its argument order (the key of
# each in a ``_fused_weights`` snapshot; a quantized one adds ``_q`` and
# ``_s``)
FUSED_MATS = ("wq", "wk", "wv", "wo", "gate_w", "up_w", "down")


def decode_weight_args(weights):
    """The decode steps' weight arguments, ``emb`` to ``head_b``, from a
    :meth:`Llama._fused_weights` snapshot: its quantized layer matrices and
    head when it has them (``wq_q``.., ``head_wq``), and a grouped-query
    model's narrow ``wk_n``/``wv_n`` when it has those."""
    qhead = "head_s" in weights
    q = "_q" if "wq_s" in weights else ""

    def mat(name):
        return weights.get(name + "_n", weights.get(name + q))

    return (weights["tok"], weights["cosD"], weights["sinD"], weights["norm"],
            *(mat(name) for name in FUSED_MATS),
            weights["in_norm"], weights["post_norm"],
            weights["head_wq"] if qhead else weights["head_w"],
            weights["head_b"])


def decode_quant_kwargs(weights):
    """The decode steps' keyword arguments for the snapshot's weight
    format: ``head_s``, for quantized layers ``scales`` and ``q4``, and for
    the narrow cache ``n_kv_heads``."""
    kw = dict(head_s=weights.get("head_s"))
    if "wq_s" in weights:
        kw.update(scales=tuple(weights[name + "_s"] for name in FUSED_MATS),
                  q4="q4" in weights)
    if "n_kv_heads" in weights:
        kw.update(n_kv_heads=weights["n_kv_heads"])
    return kw


def check_kv_quant(kv_quant, quant, fused: bool):
    """Raise for an int8 KV cache with a weight ``quant`` on the fused lane
    (``ValueError``, as the JAX package's ``generate`` and ``LlamaServer``
    raise: int8 caches and int8 weights disagree on the kernel's compute
    type). The scan lane composes them."""
    if kv_quant and quant and fused:
        raise ValueError("kv_quant and (weight) quant are mutually exclusive "
                         "on the fused kernel; the scan lane (fused=False) "
                         "composes them")


def bucket_prompt(input_ids, L: int, max_seq_len: int):
    """Pad the prompt to the next power of two (at least 8, at most
    ``max_seq_len``). Returns ``(ids_padded, last_idx)``; the logits are
    read at ``last_idx - 1``, and ``last_idx is None`` means no padding."""
    Lp = min(max(1 << (L - 1).bit_length(), 8), max_seq_len)
    if Lp > L:
        return np.pad(input_ids, ((0, 0), (0, Lp - L))), L
    return input_ids, None


class FeedForward(Module):
    """SwiGLU feed-forward."""

    def __init__(self, dim, up_dim, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.up = nn.Linear(dim, up_dim, **kw)
        self.gate = nn.Linear(dim, up_dim, **kw)
        self.down = nn.Linear(up_dim, dim, **kw)

    def forward(self, x):
        return self.down(F.silu(self.gate(x)) * self.up(x))


class Attention(Module):
    """Multi-head (or grouped-query) attention with the in-module KV cache
    the eager path uses in eval mode. The caches are non-persistent
    buffers: they stay out of ``state_dict``."""

    def __init__(self, dim: int, n_heads: int, max_seq_len: int,
                 max_batch_size: int = None, device=None, dtype=None,
                 n_kv_heads: int = None):
        super().__init__()
        assert dim % n_heads == 0
        self.n_heads = n_heads
        self.head_dim = dim // n_heads
        self.n_kv_heads = n_kv_heads or n_heads
        assert n_heads % self.n_kv_heads == 0, (n_heads, self.n_kv_heads)
        kv_dim = self.n_kv_heads * self.head_dim
        kw = dict(bias=False, device=device, dtype=dtype)
        self.Q = nn.Linear(dim, dim, **kw)
        self.K = nn.Linear(dim, kv_dim, **kw)
        self.V = nn.Linear(dim, kv_dim, **kw)
        self.O = nn.Linear(dim, dim, **kw)
        shape = (max_batch_size or 1, max_seq_len, self.n_kv_heads,
                 self.head_dim)
        self.register_buffer("cache_k", torch.zeros(shape, device=device,
                                                    dtype=dtype),
                             persistent=False)
        self.register_buffer("cache_v", torch.zeros(shape, device=device,
                                                    dtype=dtype),
                             persistent=False)

    def forward(self, x, start_pos: int, mask, freqs_cos, freqs_sin):
        B, L, _ = x.shape
        xq = self.Q(x).view(B, L, self.n_heads, self.head_dim)
        xk = self.K(x).view(B, L, self.n_kv_heads, self.head_dim)
        xv = self.V(x).view(B, L, self.n_kv_heads, self.head_dim)
        xq = _rope_pure(xq, freqs_cos, freqs_sin)
        xk = _rope_pure(xk, freqs_cos, freqs_sin)
        if not self.training:  # write the cache in place, read [0, end)
            self.cache_k[:B, start_pos:start_pos + L] = xk
            self.cache_v[:B, start_pos:start_pos + L] = xv
            xk = self.cache_k[:B, :start_pos + L]
            xv = self.cache_v[:B, :start_pos + L]
        elif mask is not None and start_pos != 0:
            raise ValueError(f"start_pos={start_pos} in train mode: the "
                             "train-mode forward keeps no KV cache, so "
                             "a prompt must start at 0")
        g = self.n_heads // self.n_kv_heads
        if g != 1:  # GQA: autograd sums each group's gradient
            xk = xk.repeat_interleave(g, dim=2)
            xv = xv.repeat_interleave(g, dim=2)
        if self.training and mask is not None:
            # the training path: pure causal attention through the flash
            # kernels (K3 forward, K4 backward on a GPU)
            out = scaled_dot_product_attention(xq, xk, xv, causal=True)
            return self.O(out.reshape(B, L, -1))
        s = torch.einsum("blhd,bmhd->bhlm", xq, xk) * (1.0 /
                                                   math.sqrt(self.head_dim))
        if mask is not None:
            s = s + mask
        out = torch.einsum("bhlm,bmhd->blhd", torch.softmax(s, dim=-1), xv)
        return self.O(out.reshape(B, L, -1))


class TransformerBlock(Module):
    """Pre-norm decoder block."""

    def __init__(self, dim, n_heads, ffn_dim, max_seq_len,
                 max_batch_size=None, device=None, dtype=None,
                 n_kv_heads=None):
        super().__init__()
        self.attention = Attention(dim, n_heads, max_seq_len, max_batch_size,
                                   device, dtype, n_kv_heads)
        self.ffn = FeedForward(dim, ffn_dim, device, dtype)
        self.input_norm = RMSNorm(dim, device=device, dtype=dtype)
        self.post_attn_norm = RMSNorm(dim, device=device, dtype=dtype)

    def forward(self, x, start_pos, mask, freqs_cos, freqs_sin):
        z = x + self.attention(self.input_norm(x), start_pos, mask,
                               freqs_cos, freqs_sin)
        return z + self.ffn(self.post_attn_norm(z))


class Llama(Module):
    """Decoder-only Llama on ``device`` (``"cuda"`` when not given, which
    raises without a GPU; ``"cpu"`` only when asked for). The parameters are
    allocated on the device in ``dtype`` (float32 when not given) and filled
    by :meth:`reset_parameters` from ``generator`` (a fresh
    ``torch.Generator`` seeded 0 when not given), one tensor at a time drawn
    in float32 on the generator's device: a CPU generator gives the same
    model on every device, and no full float32 copy of the model is ever
    held on the host; a CUDA generator draws on the card, far faster at 7B
    widths, but not the CPU's values."""

    def __init__(self, vocab_size, embed_dim, n_heads, ffn_dim: int,
                 max_seq_len: int, max_batch_size: int = None,
                 n_layers: int = 6, dtype=None, n_kv_heads: int = None,
                 device=None, generator: torch.Generator = None):
        super().__init__()
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads or n_heads
        self.ffn_dim = ffn_dim
        self.max_seq_len = max_seq_len
        self.max_batch_size = max_batch_size
        self.n_layers = n_layers
        self.head_dim = embed_dim // n_heads
        dtype = dtype or torch.float32
        device = resolve(device)
        self._weights_cache = {}  # (dtype, lane, quant) -> decode weights
        with torch.device("meta"):  # shapes only: no storage, no init draws
            self.tok_embedding = nn.Embedding(vocab_size, embed_dim,
                                              dtype=dtype)
            self.layers = ModuleList([
                TransformerBlock(embed_dim, n_heads, ffn_dim, max_seq_len,
                                 max_batch_size, dtype=dtype,
                                 n_kv_heads=n_kv_heads)
                for _ in range(n_layers)
            ])
            self.norm = RMSNorm(embed_dim, dtype=dtype)
            self.lm_head = nn.Linear(embed_dim, vocab_size, dtype=dtype)
        self.to_empty(device=device)
        cos, sin = compute_cos_sin_cache(self.head_dim, max_seq_len)
        self.register_buffer("freqs_cos", cos.to(device, dtype),
                             persistent=False)
        self.register_buffer("freqs_sin", sin.to(device, dtype),
                             persistent=False)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator = None):
        """Linear weights and biases uniform in +-1/sqrt(fan_in), embedding
        N(0, 1), norms 1, all drawn in float32 on ``generator``'s device (a
        CPU generator by default) in a fixed order and copied into the
        parameters; the eager path's KV caches are zeroed."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        dev = generator.device
        for m in self.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                for p in (m.weight, m.bias):
                    if p is not None:
                        p.copy_(torch.empty(p.shape, device=dev).uniform_(
                            -bound, bound, generator=generator))
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(torch.empty(m.weight.shape, device=dev).normal_(
                    generator=generator))
            elif isinstance(m, RMSNorm):
                m.weight.fill_(1.0)
            elif isinstance(m, Attention):
                m.cache_k.zero_()
                m.cache_v.zero_()
        self._weights_cache.clear()

    # decode-weight snapshots hold copies of the weights (or tensors of the
    # old device and type): anything that replaces the weights drops them
    def _apply(self, fn, *args, **kwargs):
        self._weights_cache.clear()
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        self._weights_cache.clear()
        return super().load_state_dict(*args, **kwargs)

    @property
    def device(self) -> torch.device:
        return self.tok_embedding.weight.device

    # --------------------------- eager module path -------------------------
    def _ids(self, input_ids):
        if isinstance(input_ids, torch.Tensor):
            return input_ids.to(device=self.device, dtype=torch.long)
        return torch.as_tensor(np.asarray(input_ids), dtype=torch.long,
                               device=self.device)

    def _forward_hidden(self, input_ids, start_pos: int):
        ids = self._ids(input_ids)
        L = ids.shape[-1]
        h = self.tok_embedding(ids)
        cos = self.freqs_cos[start_pos:start_pos + L]
        sin = self.freqs_sin[start_pos:start_pos + L]
        mask = None
        if L > 1:
            m = torch.full((L, L), float("-inf"), device=h.device).triu(1)
            mask = torch.cat([torch.zeros(L, start_pos, device=h.device), m],
                             dim=1).to(h.dtype)
        for layer in self.layers:
            h = layer(h, start_pos, mask, cos, sin)
        return self.norm(h)

    def forward_logits(self, input_ids, start_pos: int = 0):
        """Logits at every position."""
        return self.lm_head(self._forward_hidden(input_ids, start_pos))

    def forward(self, input_ids, start_pos: int):
        """Logits at the last position, (B, 1, V)."""
        return self.lm_head(self._forward_hidden(input_ids, start_pos)[:, -1:])

    # ------------------------- freezing / finetuning ------------------------
    def set_trainable_parameters(self, trainable_prefixes=("lm_head",)):
        """Let a parameter require a gradient iff its dotted name starts with
        one of ``trainable_prefixes``. Returns ``(trainable, frozen)``
        counts.

        The JAX package keeps its KV caches (two per layer) and RoPE tables
        (two) as Parameters too, so its counts include them: its frozen count
        is larger by 2 * n_layers + 2 when no prefix matches them, and a
        prefix such as ``layers`` makes its caches trainable and counts them
        there. Here they are buffers and are never counted."""
        trainable = frozen = 0
        for name, param in self.named_parameters():
            on = any(name.startswith(prefix) for prefix in trainable_prefixes)
            param.requires_grad_(on)
            trainable += on
            frozen += not on
        return trainable, frozen

    def add_lora(self, r: int = 8, alpha: float = 16.0, targets=("Q", "V"),
                 dropout: float = 0.0):
        """Attach rank-``r`` LoRA adapters (``nn/modules/lora.py``) to every
        Linear whose attribute name is in ``targets`` (``Q``, ``K``, ``V``,
        ``O``, ``gate``, ``up``, ``down``, ``lm_head``) and freeze every
        other parameter. Returns ``(trainable, frozen)`` as
        :meth:`set_trainable_parameters` counts them. Every decode snapshot
        folds the unmerged adapters into its weights (:meth:`_weights`), and
        fine-tune steps drop the snapshots, so decoding sees the adapters at
        once."""
        from ...nn.modules.lora import apply_lora
        if not apply_lora(self, r=r, alpha=alpha, targets=targets,
                          dropout=dropout, freeze=True):
            raise ValueError(f"no Linear matched targets={targets!r}")
        self._weights_cache.clear()
        flags = [p.requires_grad for p in self.parameters()]
        return sum(flags), len(flags) - sum(flags)

    def merge_lora(self) -> int:
        """Fold every adapter into its base weight (plain Linears again);
        returns the number merged. Decoding is bit-identical before and
        after: both compute the same ``W + A B * scaling`` array."""
        from ...nn.modules.lora import merge_lora
        merged = merge_lora(self)
        self._weights_cache.clear()
        return merged

    def _lora_deltas(self) -> dict:
        """Dotted weight name -> its unmerged adapter (empty without
        adapters)."""
        from ...nn.modules.lora import LoRALinear
        return {path + ".weight": m for path, m in self.named_modules()
                if isinstance(m, LoRALinear)}

    def _train_step(self, inp, tgt, optimizer, criterion, start_pos,
                    clip_norm):
        """Forward, loss, backward, optional clipping and the optimizer step
        on device tensors; returns the detached loss, still on the device."""
        optimizer.zero_grad()
        with torch.enable_grad():
            logits = self.forward_logits(inp, start_pos)
            B, L, V = logits.shape
            loss = criterion(logits.reshape(B * L, V), tgt)
            loss.backward()
        if clip_norm is not None:
            clip_grad_norm_(optimizer.params, clip_norm)
        optimizer.step()
        return loss.detach()

    def _train_inputs(self, input_ids, target_ids, criterion):
        self.train(True)
        tgt = torch.as_tensor(np.asarray(target_ids).reshape(-1),
                              dtype=torch.long, device=self.device)
        return self._ids(input_ids), tgt, criterion or CrossEntropyLoss()

    def finetune_step(self, input_ids, target_ids, optimizer, criterion=None,
                      start_pos: int = 0, sync: bool = True,
                      clip_norm: float = None):
        """One fine-tune step on (B, L) ``input_ids`` and ``target_ids``:
        causal forward in train mode (attention through the flash kernels),
        ``criterion`` (cross-entropy by default) over the (B * L, V) logits,
        backward, global-norm clipping at ``clip_norm`` when given, and
        ``optimizer.step()``. Returns the loss as a float, or with
        ``sync=False`` as a device scalar (no wait for the device). The
        decode-weight snapshots are dropped, so decode sees the new
        weights."""
        inp, tgt, criterion = self._train_inputs(input_ids, target_ids,
                                                 criterion)
        loss = self._train_step(inp, tgt, optimizer, criterion, start_pos,
                                clip_norm)
        self._weights_cache.clear()
        return loss.item() if sync else loss

    def finetune_steps(self, input_ids, target_ids, optimizer, n_steps: int,
                       criterion=None, start_pos: int = 0,
                       clip_norm: float = None):
        """``n_steps`` :meth:`finetune_step` calls on the same pair, in a
        Python loop that never reads back: returns the losses as an
        (n_steps,) tensor on the device."""
        inp, tgt, criterion = self._train_inputs(input_ids, target_ids,
                                                 criterion)
        losses = torch.empty(n_steps, dtype=torch.float32, device=self.device)
        for i in range(n_steps):
            losses[i] = self._train_step(inp, tgt, optimizer, criterion,
                                         start_pos, clip_norm)
        self._weights_cache.clear()
        return losses

    # ------------------------------ scan lane -------------------------------
    def _snapshot_reader(self, dtype):
        """``g(name)``: the named parameter or RoPE table as a decode
        snapshot reads it, cast to ``dtype`` when given. An unmerged
        adapter's update is added to its weight before the cast (the JAX
        package's ``model.py:610-616``), the same array ``merge_lora``
        stores, so every snapshot decodes alike before and after a merge."""
        P = dict(self.named_parameters())
        P.update(freqs_cos=self.freqs_cos, freqs_sin=self.freqs_sin)
        lora = self._lora_deltas()

        def g(name):
            a = P[name].detach()
            mod = lora.get(name)
            if mod is not None:
                a = a + mod.delta_array().to(a.dtype)
            return a.to(dtype) if dtype else a

        return g

    def _weights(self, dtype=None):
        """Layer-stacked decode weights in torch's (out, in) layout, cast to
        ``dtype`` when given: q/k/v and gate/up are concatenated into one
        matrix each, as in the JAX package's ``_weights``."""
        key = (dtype, "dense", None)
        if key in self._weights_cache:
            return self._weights_cache[key]
        g = self._snapshot_reader(dtype)

        def stack(fmt):
            return torch.stack([g(fmt.format(i))
                                for i in range(self.n_layers)])

        w = {
            "tok": g("tok_embedding.weight"),
            "cos": g("freqs_cos"),
            "sin": g("freqs_sin"),
            "norm": g("norm.weight"),
            "head_w": g("lm_head.weight"),
            "head_b": g("lm_head.bias"),
            "wqkv": torch.cat([stack("layers.{}.attention.Q.weight"),
                               stack("layers.{}.attention.K.weight"),
                               stack("layers.{}.attention.V.weight")], 1),
            "wo": stack("layers.{}.attention.O.weight"),
            "wgu": torch.cat([stack("layers.{}.ffn.gate.weight"),
                              stack("layers.{}.ffn.up.weight")], 1),
            "down": stack("layers.{}.ffn.down.weight"),
            "in_norm": stack("layers.{}.input_norm.weight"),
            "post_norm": stack("layers.{}.post_attn_norm.weight"),
        }
        self._weights_cache[key] = w
        return w

    def _weights_xq(self, dtype, quant):
        """The scan lane's weights for a quantized format (the JAX package's
        ``_weights_xq``, ``model.py:647-681``). ``"int8"``/``"int4"``
        quantize each stacked layer matrix as (L, K, N), contraction axis
        first (torch's (out, in) transposed), with per-output-channel scales
        (L, 1, N), into ``<name>_xq``/``<name>_xs``; every format quantizes
        the head as (D, V) into ``head_xq``/``head_xs`` (1, V). ``"q4"``
        marks int4 and ``layer_ids`` holds the device layer indices of
        ``qmatmul_stacked``. A quantized matrix is built a layer at a time,
        so no dense stacked copy of it is made or kept."""
        if quant not in ("int8", "int4", "int8-head"):
            raise ValueError(f"unsupported quant mode: {quant!r}")
        key = (dtype, "xq", quant)
        if key in self._weights_cache:
            return self._weights_cache[key]
        g = self._snapshot_reader(dtype)
        q4 = quant == "int4"
        qfn = quantize_int4 if q4 else quantize_int8
        if quant == "int8-head":
            w = dict(self._weights(dtype))
            del w["head_w"]
        else:
            w = {k: g(n) for k, n in (("tok", "tok_embedding.weight"),
                                      ("cos", "freqs_cos"),
                                      ("sin", "freqs_sin"),
                                      ("norm", "norm.weight"),
                                      ("head_b", "lm_head.bias"))}
            for k, n in (("in_norm", "input_norm"),
                         ("post_norm", "post_attn_norm")):
                w[k] = torch.stack([g(f"layers.{i}.{n}.weight")
                                    for i in range(self.n_layers)])
            for name, mods in _LAYER_MATS.items():
                for i in range(self.n_layers):
                    m = torch.cat([g(f"layers.{i}.{mod}.weight")
                                   for mod in mods]).t()  # (K, N)
                    q, sc = qfn(m, axis=0)
                    if i == 0:
                        w[name + "_xq"] = q.new_empty((self.n_layers,)
                                                      + q.shape)
                        w[name + "_xs"] = sc.new_empty((self.n_layers,)
                                                       + sc.shape)
                    w[name + "_xq"][i] = q
                    w[name + "_xs"][i] = sc
            if q4:
                w["q4"] = True
        hq, hs = qfn(g("lm_head.weight").t(), axis=0)
        w["head_xq"], w["head_xs"] = hq.contiguous(), hs.contiguous()
        w["layer_ids"] = torch.arange(self.n_layers, dtype=torch.int32,
                                      device=self.device)
        self._weights_cache[key] = w
        return w

    def _empty_caches(self, B: int, dtype, kv_quant=None):
        """Zeroed scan-lane caches (N, B, S, Hkv, hd) in ``dtype``, or with
        ``kv_quant="int8"`` ``(int8 rows, (N, B, S, Hkv) float32 scales)``
        pairs, the scales zero as the JAX package's."""
        shape = (self.n_layers, B, self.max_seq_len, self.n_kv_heads,
                 self.head_dim)
        if kv_quant:
            return tuple(
                (torch.zeros(shape, dtype=torch.int8, device=self.device),
                 torch.zeros(shape[:-1], dtype=torch.float32,
                             device=self.device)) for _ in range(2))
        return (torch.zeros(shape, dtype=dtype, device=self.device),
                torch.zeros(shape, dtype=dtype, device=self.device))

    def forward_logits_one(self, weights, ck, cv, tokens, pos,
                           last_idx: int = None, starts=None, flash=False,
                           all_positions: bool = False, win: int = None,
                           slots=None):
        """Dense forward of ``tokens`` (B, L) at absolute position ``pos``
        over caches (N, B, S, Hkv, hd), which are written in place at rows
        [pos, pos + L) (clamped into the cache, as the JAX package's
        ``dynamic_update_slice`` clamps). Row b attends cache rows
        [starts[b], pos + L) under the causal mask (``starts`` (B,) int32 on
        the device, the server's slot-recycling bound; 0 when None).
        Returns float32 logits (B, V) at the last position, or at
        ``last_idx - 1`` when the prompt is bucket-padded, or with
        ``all_positions`` (B, L, V) at every position (the speculative
        verifier's). Weights from :meth:`_weights_xq` run the quantized
        matmuls (see the module doc).

        Caches given as ``(int8 rows, (N, B, S, Hkv) float32 scales)``
        pairs (:meth:`_empty_caches` with ``kv_quant``) are the int8 KV
        cache: the fresh K rows (rotated) and V rows are quantized by
        ``ops.decode_step.quantize_kv`` over ``hd``, one scale a (row,
        head), before they are written, and the attention reads the window
        dequantized and cast to the model's type, as the JAX package's
        ``model.py:824-862``.

        ``flash`` (``True``, or the JAX package's ``"interpret"``, which
        means the same here) routes a pure-causal prefill's attention (pos
        0, no ``starts``) through the flash forward (K3,
        ``ops.flash_attention.flash_attention_fwd``) over the current
        tokens' K/V, unquantized, a grouped-query model's repeated to every
        query head, as the JAX package's ``model.py:842-851``: no (L, L)
        scores or mask are built. The caches are written as on the dense
        route. On CPU tensors K3's wrapper runs its plain version.

        Per-row positions (the speculative server's, the JAX package's
        ``fwd_rows``, ``serve_spec.py:77-155``): ``pos`` a (B,) int tensor on
        the device. Row b's tokens sit at positions [pos[b], pos[b] + L):
        their RoPE angles are gathered a row at a time, their K/V rows are
        scattered into cache slot ``slots[b]`` (b when ``slots`` is None,
        a (B,) long tensor otherwise) at those rows, and each query attends
        the rows [0, its position] of its own slot in a window of the first
        ``win`` rows. Rows from ``max_seq_len`` on (a slot without headroom,
        whose tokens the caller discards) land in the caches' spare rows
        past ``max_seq_len``, which no window reads: the JAX package drops
        them. Nothing is read back to the host. Float caches only."""
        B, L = tokens.shape
        per_row = isinstance(pos, torch.Tensor)
        if per_row and (flash or starts is not None or isinstance(ck, tuple)
                        or last_idx is not None or win is None):
            raise ValueError("per-row positions take float caches and a "
                             "window, with no flash, starts or last_idx")
        if flash and (starts is not None or pos != 0):
            raise ValueError("flash prefill is pure-causal from position 0: "
                             "it cannot honor per-row starts masks or a "
                             f"start at pos={pos}")
        S, H, Hkv, hd = (self.max_seq_len, self.n_heads, self.n_kv_heads,
                         self.head_dim)
        D, Dkv, Fd = H * hd, Hkv * hd, self.ffn_dim
        g = H // Hkv
        W = weights
        q4 = "q4" in W
        kvq = isinstance(ck, tuple)

        def mm(x, name, i):
            if name + "_xq" not in W:
                return F.linear(x, W[name][i])
            x2 = x.reshape(-1, x.shape[-1]).contiguous()
            y = gq.qmatmul_stacked(x2, W[name + "_xq"], W[name + "_xs"],
                                   W["layer_ids"][i], q4=q4)
            return y.reshape(x.shape[:-1] + y.shape[-1:]).to(x.dtype)

        def window(c, i):  # layer i's cache rows [0, end)
            if per_row:
                return c[i, :, :end] if slots is None else c[i, slots, :end]
            if not kvq:
                return c[i, :, :end]
            return (c[0][i, :, :end].float()
                    * c[1][i, :, :end, :, None]).to(h.dtype)

        def write(c, i, x):  # layer i's new K or V rows
            if per_row:
                c[i, slot_ids, rows] = x
            elif kvq:
                c[0][i, :, start:start + L], c[1][i, :, start:start + L] \
                    = dsk.quantize_kv(x)
            else:
                c[i, :, start:start + L] = x

        h = W["tok"][tokens]
        if per_row:  # (B, L) positions; angles of rows past S: clamped
            rows = pos.long()[:, None] + torch.arange(L, device=h.device)
            slot_ids = (torch.arange(B, device=h.device) if slots is None
                        else slots)[:, None]
            end = min(win, S)
            qpos = rows[:, :, None]                              # (B, L, 1)
            cos, sin = (W[t][rows.clamp(max=S - 1)] for t in ("cos", "sin"))
        else:
            start = min(pos, S - L)  # the write slice stays in the cache
            end = min(S, pos + L)
            qpos = pos + torch.arange(L, device=h.device)[:, None]  # (L, 1)
            cos, sin = W["cos"][start:start + L], W["sin"][start:start + L]
        if not flash:
            cols = torch.arange(end, device=h.device)
            allowed = cols <= qpos                  # (L, end) or (B, L, end)
            if starts is not None:  # (B, 1, L, end): broadcast over heads
                allowed = (allowed[None]
                           & (cols >= starts[:, None, None]))[:, None]
            elif per_row:
                allowed = allowed[:, None]
            mask = torch.zeros(allowed.shape, device=h.device).masked_fill(
                ~allowed, float("-inf"))
        scale = 1.0 / math.sqrt(hd)
        for i in range(self.n_layers):
            hn = rms_norm(h, W["in_norm"][i]).to(h.dtype)
            qkv = mm(hn, "wqkv", i)
            q = qkv[..., :D].reshape(B, L, H, hd)
            k = qkv[..., D:D + Dkv].reshape(B, L, Hkv, hd)
            v = qkv[..., D + Dkv:].reshape(B, L, Hkv, hd)
            q = _rope_pure(q, cos.to(q.dtype), sin.to(q.dtype))
            k = _rope_pure(k, cos.to(k.dtype), sin.to(k.dtype))
            write(ck, i, k)
            write(cv, i, v)
            if flash:
                kf, vf = ((x.repeat_interleave(g, dim=2) if g != 1 else x)
                          for x in (k, v))
                att = fa.flash_attention_fwd(
                    q.contiguous(), kf.contiguous(), vf.contiguous(),
                    scale)[0].to(h.dtype).reshape(B, L, D)
            else:
                kk, vv = window(ck, i), window(cv, i)
                if g != 1:
                    kk = kk.repeat_interleave(g, dim=2)
                    vv = vv.repeat_interleave(g, dim=2)
                s = torch.einsum("blhd,bmhd->bhlm", q.float(),
                                 kk.float()) * scale
                p = torch.softmax(s + mask, dim=-1).to(h.dtype)
                att = torch.einsum("bhlm,bmhd->blhd", p, vv).reshape(B, L, D)
            z = h + mm(att, "wo", i)
            zn = rms_norm(z, W["post_norm"][i]).to(z.dtype)
            gate, up = mm(zn, "wgu", i).split(Fd, dim=-1)
            h = z + mm(gate * torch.sigmoid(gate) * up, "down", i)
        h = rms_norm(h, W["norm"]).to(h.dtype)
        if all_positions:
            hl = h
        else:
            hl = h[:, -1] if last_idx is None else h[:, last_idx - 1]
        if "head_xq" in W:
            logits = gq.qmatmul(hl.reshape(-1, hl.shape[-1]).contiguous(),
                                W["head_xq"], W["head_xs"], q4=q4)
            logits = logits.reshape(hl.shape[:-1] + logits.shape[-1:])
        else:
            logits = F.linear(hl, W["head_w"]).float()
        return logits + W["head_b"].float()

    def prefill_logits(self, weights, ck, cv, ids, last_idx=None,
                       flash=False):
        """Float32 logits (B, V) after the prompt ``ids`` (B, L), caches
        filled (read at ``last_idx - 1`` for a bucket-padded prompt), the
        attention through the flash forward with ``flash``
        (:meth:`forward_logits_one`)."""
        tokens = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        return self.forward_logits_one(weights, ck, cv, tokens, 0, last_idx,
                                       flash=flash)

    def prefill(self, weights, ck, cv, ids, last_idx=None, sampler=None,
                flash=False):
        """The token after the prompt ``ids`` (B, L), caches filled: the
        greedy one, or drawn by ``sampler`` (a :class:`Sampler`, whose
        ``seen`` first marks the prompt's tokens, bucket padding
        excluded)."""
        logits = self.prefill_logits(weights, ck, cv, ids, last_idx, flash)
        if sampler is None:
            return logits.argmax(-1)
        sampler.mark_prompt(ids, last_idx)
        return sampler.draw(logits)

    def decode_chunk_plain(self, weights, ck, cv, tok, pos: int,
                           n_steps: int, starts=None, sampler=None):
        """``n_steps`` tokens on the scan lane from ``tok`` (B,) at ``pos``,
        rows attending from ``starts`` (see :meth:`forward_logits_one`):
        greedy, or drawn by ``sampler`` from each step's logits (a
        :class:`Sampler`, or a server's per-row ``draw``). Returns them as
        (n_steps, B) int32, still on the device."""
        toks = torch.empty(n_steps, tok.shape[0], dtype=torch.int32,
                           device=tok.device)
        for i in range(n_steps):
            logits = self.forward_logits_one(weights, ck, cv, tok[:, None],
                                             pos + i, starts=starts)
            tok = toks[i] = (logits.argmax(-1) if sampler is None
                             else sampler.draw(logits))
        return toks

    # ------------------------------ fused lane ------------------------------
    def _fused_weights(self, dtype=None, quant=None):
        """The plain lane's weights plus what ``fused_decode_token`` reads:
        per-matrix (N, out, in) stacks, (S, D) RoPE tables
        ``tile(repeat(cos, 2), H)`` in the weight type, and for
        ``quant="int8-head"`` the int8 head with per-row float32 scales
        (the JAX package's ``quantize_int8(head_w, axis=0)`` in torch's
        layout). ``"int8"`` and ``"int4"`` quantize each layer matrix along
        its ``in`` axis too (``ops/quant.py``; int4 packs it to in / 2)
        into ``<name>_q`` with (N, out) scales ``<name>_s``, and the head
        into ``head_wq``/``head_s``; ``"q4"`` marks int4. The float
        matrices and head stay for the prefill token, which runs at full
        precision as in the JAX package (``model.py:1180-1186``);
        :func:`decode_weight_args` picks the decode steps' arguments.

        A grouped-query model (``n_kv_heads < n_heads``) with float layers
        decodes on the narrow cache: ``wk_n``/``wv_n`` (N, Hkv * hd, D),
        torch's layout of the JAX package's ``wk_n`` without its lane
        padding, and ``n_kv_heads``. With int8/int4 layers it decodes on the
        expanded (MHA) layout, as the JAX package does (its ``kv_expand``,
        ``model.py:1126-1135``): ``wk``/``wv`` repeat each KV head's rows
        to its query group before they are quantized, so the scales are
        the JAX package's."""
        if quant not in QUANTS:
            raise ValueError(f"unsupported quant mode: {quant!r}")
        key = (dtype, "fused", quant)
        if key in self._weights_cache:
            return self._weights_cache[key]
        base = self._weights(dtype)
        D, H, Fd = self.embed_dim, self.n_heads, self.ffn_dim
        Dkv = self.n_kv_heads * self.head_dim
        qlayers = quant in ("int8", "int4")

        def expand(t):  # (S, hd/2) -> (S, D): each pair's angle, per head
            return t.repeat_interleave(2, dim=-1).repeat(1, H).contiguous()

        def kv_rows(a, b):  # wk or wv (N, Dkv, D), expanded for qlayers
            m = base["wqkv"][:, a:b]
            if qlayers and Dkv != D:
                m = m.reshape(m.shape[0], self.n_kv_heads, self.head_dim, D) \
                    .repeat_interleave(H // self.n_kv_heads, dim=1) \
                    .reshape(m.shape[0], D, D)
            return m.contiguous()

        kv = (("wk", "wv") if qlayers or Dkv == D else ("wk_n", "wv_n"))
        w = dict(base)
        w.update({
            "wq": base["wqkv"][:, :D].contiguous(),
            kv[0]: kv_rows(D, D + Dkv),
            kv[1]: kv_rows(D + Dkv, D + 2 * Dkv),
            "gate_w": base["wgu"][:, :Fd].contiguous(),
            "up_w": base["wgu"][:, Fd:].contiguous(),
            "cosD": expand(base["cos"]),
            "sinD": expand(base["sin"]),
        })
        if kv[0] == "wk_n":
            w["n_kv_heads"] = self.n_kv_heads
        qfn = quantize_int4 if quant == "int4" else quantize_int8
        if qlayers:
            for name in FUSED_MATS:
                q, sc = qfn(w[name], axis=2)
                w[name + "_q"] = q.contiguous()
                w[name + "_s"] = sc.reshape(sc.shape[:2]).contiguous()
            if quant == "int4":
                w["q4"] = True
        if quant is not None:
            hq, hs = qfn(base["head_w"], axis=1)
            w["head_wq"] = hq.contiguous()     # int8 (V, D), int4 (V, D/2)
            w["head_s"] = hs.reshape(-1)       # float32 (V,)
        self._weights_cache[key] = w
        return w

    def _fused_decode_supported(self, quant=None, batch: int = 1,
                                batched: bool = False) -> bool:
        """Whether the fused lane can run this model at ``batch`` rows
        (through the batched kernel at any B when ``batched``, as
        ``LlamaServer`` does).

        The JAX package bounds its kernel by TPU VMEM (100 MB): the Pallas
        kernel keeps every per-layer weight matrix resident in a
        double-buffered VMEM window. Re-derived for the H100: the CUDA
        chain streams weights from device memory through registers and
        keeps nothing per layer on chip, so weight size sets no bound. What
        stays on chip is a block's weight ring and its group's activation
        rows (D wide, F in the down projection): at B=1 max(D, F) plus a
        few reduction slots must fit in 12,288 floats; the attention block
        (256 threads) needs head_dim <= 256; RoPE needs an even head_dim
        (``ops.decode_step.kernel_takes``). At B>1 a block keeps a group
        of up to 32 activation rows beside its ring, opting in up to 227
        KB, and the chain takes any number of groups
        (``ops.decode_step.batched_kernel_takes``). A grouped-query model
        decodes on the narrow cache with float layers, on the expanded
        layout with int8/int4 layers (:meth:`_fused_weights`). int8 and
        int4 layers run on both kernels, but only where the JAX package's
        rule (:meth:`_tpu_fused_supported`) puts them on its fused kernel:
        a Llama-2-7B model with them stays on the scan lane, as there.
        """
        D, H, Fd = self.embed_dim, self.n_heads, self.ffn_dim
        q4 = quant == "int4"
        hkv = None if quant in ("int8", "int4") else self.n_kv_heads
        takes = (dsk.kernel_takes(D, H, Fd, q4, hkv)
                 if batch == 1 and not batched
                 else dsk.batched_kernel_takes(D, H, Fd, batch, q4, hkv))
        fmt = (quant in (None, "int8-head")
               or self._tpu_fused_supported(quant))
        return fmt and takes

    def _tpu_fused_supported(self, quant=None) -> bool:
        """The JAX package's routing rule, ``_fused_decode_supported``
        (``pydynet_tpu/models/llama/model.py:1228-1258``): whether its
        whole-token Pallas kernel takes the model, else ``generate`` runs
        the scan lane. 8-aligned widths, a 16-aligned cache, an even
        head_dim, a vocab that tiles, and every per-layer weight window
        double-buffered within 100 MB of TPU VMEM at the format's item size.
        ``fused=None`` sends a model the port's fused kernels do not take to
        the scan lane exactly where this rule does."""
        D, Fd, S, V = (self.embed_dim, self.ffn_dim, self.max_seq_len,
                       self.vocab_size)
        CW = dsk.lane_pad_dim(max(self.n_kv_heads * self.head_dim, 1)) \
            if self.n_kv_heads != self.n_heads else D
        itemsize = {"int8": 1.0, "int4": 0.5}.get(quant, 2.0)
        vmem = 2 * (2 * D * D + 2 * D * CW + 3 * D * Fd) * itemsize
        return (D % 8 == 0 and Fd % 8 == 0 and S % 16 == 0
                and self.head_dim % 2 == 0 and dsk.pick_vt(V) > 0
                and dsk.pick_sb(S) > 0 and V % 8 == 0
                and vmem <= (100 << 20))

    def use_fused(self, quant, batch: int, fused=None,
                  batched: bool = False) -> bool:
        """Resolve the lane of ``generate`` and ``LlamaServer``: ``fused``
        True or False asks for a lane; None takes the fused lane where the
        port's fused kernels take the model, format and batch (the batched
        kernel's at any B when ``batched``), else the scan lane where the
        JAX package's rule (:meth:`_tpu_fused_supported`) sends the model
        there. Raises ``NotImplementedError`` naming the ROADMAP.md item
        for a fused lane the port cannot run."""
        if quant not in QUANTS:
            raise ValueError(f"unsupported quant mode: {quant!r}")
        if fused is not None and not fused:
            return False
        if self._fused_decode_supported(quant, batch, batched):
            return True
        if fused is None and not self._tpu_fused_supported(quant):
            return False
        not_ported("a fused decode kernel for these dims (fused=False runs "
                   "the scan lane)", "Big-dims lane")

    def fused_step(self, weights, ck, cv, tok, pos, emit_logits=False,
                   out=None):
        """One ``fused_decode_token`` call in the snapshot's weight format
        (the narrow mode for a grouped-query snapshot): ``tok``/``pos`` (1,)
        int32 on the device, caches (N, S, W) (:meth:`_flat_caches`)
        updated in place; returns (1,) int32, or with ``emit_logits`` the
        (1, V) float32 logits."""
        return dsk.fused_decode_token(
            pos, tok, *decode_weight_args(weights), ck, cv,
            n_heads=self.n_heads, emit_logits=emit_logits, out=out,
            **decode_quant_kwargs(weights))

    def fused_step_batched(self, weights, ck, cv, tok, pos, starts=None,
                           emit_logits=False, out=None):
        """One ``fused_decode_token_batched`` call in the snapshot's weight
        format: ``tok`` (B,) and ``pos`` (1,) int32 on the device, caches
        (N, B, S, W) updated in place, or for the int8 KV cache ``(int8
        rows, (N, B, S) float32 scales)`` pairs (:func:`quantize_kv`'s);
        ``starts`` (B,) int32 per-row attention lower bounds or None;
        returns (B,) int32, or with ``emit_logits`` the (B, V) float32
        logits."""
        kv = {}
        if isinstance(ck, tuple):
            (ck, sk), (cv, sv) = ck, cv
            kv = dict(sk=sk, sv=sv)
        return dsk.fused_decode_token_batched(
            pos, tok, *decode_weight_args(weights), ck, cv,
            n_heads=self.n_heads, starts=starts, emit_logits=emit_logits,
            out=out, **decode_quant_kwargs(weights), **kv)

    def decode_chunk(self, weights, ck, cv, tok, pos: int, n_steps: int,
                     starts=None, sampler=None):
        """``n_steps`` fused steps from ``tok`` (B,) int32 at the shared
        ``pos``: flat caches (N, S, W) take the B=1 kernel, batched caches
        (N, B, S, W), or the int8 KV cache's (rows, scales) pairs, the
        batched one, whose rows may start their attention at ``starts``
        (B,) int32 on the device. Greedy steps take the kernel's token;
        with ``sampler`` (see :meth:`decode_chunk_plain`) the kernel emits
        the logits and the sampler draws the token. Positions, tokens and
        the sampler's state stay on the device: step i reads step i-1's
        output in place, so no step waits for the host. Returns the
        (n_steps, B) int32 tokens."""
        B = tok.shape[0]
        toks = torch.empty(n_steps, B, dtype=torch.int32, device=tok.device)
        positions = torch.arange(pos, pos + n_steps, dtype=torch.int32,
                                 device=tok.device)
        batched = isinstance(ck, tuple) or ck.dim() == 4
        step = self.fused_step_batched if batched else self.fused_step
        kw = dict(starts=starts) if batched else {}
        if sampler is not None:  # one logits buffer for the whole chunk
            kw.update(emit_logits=True, out=torch.empty(
                B, self.vocab_size, dtype=torch.float32, device=tok.device))
        for i in range(n_steps):
            if sampler is None:
                step(weights, ck, cv, tok, positions[i:i + 1], out=toks[i],
                     **kw)
            else:
                toks[i] = sampler.draw(step(weights, ck, cv, tok,
                                            positions[i:i + 1], **kw))
            tok = toks[i]
        return toks

    def _flat_caches(self, ck5, cv5, weights):
        """(N, B, S, Hkv, hd) dense caches in the fused lane's layout for
        the ``weights`` snapshot (the JAX package's ``_kv_flat``): (N, S, W)
        at B=1, (N, B, S, W) at B>1. For MHA and the narrow cache (W = Hkv
        * hd) they are views of the same memory; for a grouped-query model
        on the expanded layout (int8/int4 layers) each KV head is repeated
        to its query group (W = D), a copy."""
        N, B, S = ck5.shape[:3]
        shape = (N, S, -1) if B == 1 else (N, B, S, -1)
        if self.n_kv_heads != self.n_heads and "n_kv_heads" not in weights:
            g = self.n_heads // self.n_kv_heads
            ck5, cv5 = (c.repeat_interleave(g, dim=3) for c in (ck5, cv5))
        return ck5.view(shape), cv5.view(shape)

    # ------------------------------- generate -------------------------------
    def _numpy_lane(self, B, dtype, fused, quant, kv_quant) -> bool:
        """Whether ``generate`` takes the NumPy BLAS lane (``cpu_decode.py``;
        the JAX package's rule, ``model.py:1596-1625``): ``fused="numpy"``
        asks for it and raises ``ValueError`` unless B=1, the weights are
        float32 and no ``quant``, ``kv_quant`` or ``dtype`` is given;
        ``fused=None`` takes it for a model on the CPU where those hold."""
        ok = (B == 1 and quant is None and kv_quant is None and dtype is None
              and self.tok_embedding.weight.dtype == torch.float32)
        if isinstance(fused, str) and fused == "numpy":
            if not ok:
                raise ValueError("fused='numpy' is the B=1, f32-native CPU "
                                 "lane (no quant/kv_quant/dtype override)")
            return True
        return fused is None and ok and self.device.type == "cpu"

    def _generate_numpy(self, ids, total, **sampling):
        from .cpu_decode import build_np_weights, numpy_decode

        w = self._weights_cache.get(("numpy",))
        if w is None:
            w = self._weights_cache[("numpy",)] = build_np_weights(self)
        for t in numpy_decode(self, w, ids, total, **sampling):
            yield torch.tensor([[t]], dtype=torch.int32)

    def _check_generate(self, B, dtype, fused, quant, kv_quant):
        """Resolve the lane (:meth:`use_fused`) and raise for whatever this
        port does not run yet, naming its ROADMAP.md item. Nothing is
        rerouted silently: a model, format or batch that neither the port's
        fused kernels take nor the JAX package's rule sends to the scan lane
        raises unless the caller asks for the scan lane with
        ``fused=False``."""
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unsupported kv_quant mode: {kv_quant!r}")
        check_dtype(dtype)
        # the int8 KV cache lives in the batched kernel, at B=1 too
        fused = self.use_fused(quant, B, fused, batched=bool(kv_quant))
        check_kv_quant(kv_quant, quant, fused)
        return fused

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int,
                 chunk: int = DECODE_CHUNK, dtype=None, fused=None,
                 quant=None, temperature: float = 0.0, top_k: int = None,
                 top_p: float = None, seed: int = 0,
                 repetition_penalty: float = None, kv_quant=None,
                 bucket_prefill: bool = True, flash_prefill=None):
        """Greedy or sampled generation. Yields (B, 1) int32 CPU tensors one
        token at a time: first the prefill token, then one per decode step.
        Tokens are
        read back from the device once per ``chunk`` steps, the prefill
        token with the first chunk. ``max_new_tokens`` bounds the total
        length (prompt included) and is capped at ``max_seq_len``; a total
        at or below the prompt length yields nothing. ``dtype`` (float32,
        bfloat16 or float16, :func:`check_dtype`) casts the weights and
        caches; ``quant="int8-head"`` stores
        the lm_head as int8, ``"int8"`` and ``"int4"`` every matmul weight
        as well (the prefill token stays on the float weights on the fused
        lane). ``kv_quant="int8"`` keeps the KV cache as int8 rows with
        float32 scales: on the fused lane per row (:func:`quantize_kv` of
        the dense prefill's caches, then the batched kernel's int8 KV mode,
        at B=1 too, as in the JAX package), with float weights only (a
        ``quant`` raises ``ValueError``); on the scan lane per (row, head),
        through prefill and decode (:meth:`forward_logits_one`), with any
        ``quant``.
        ``fused`` picks the lane (module doc; ``"numpy"`` the NumPy BLAS
        lane, :meth:`_numpy_lane`): on
        the fused lane one B=1 kernel chain a token at B=1, one batched
        chain a token for all rows at B>1 or with ``kv_quant``; on the scan
        lane one dense forward a token, its matmuls quantized with
        ``quant``. ``bucket_prefill`` (default on) pads the prompt to the
        next power of two before the prefill, as the JAX package does; the
        tokens are the same either way (the logits are read at the true
        last position, and every padded cache row lies above the decode
        position until the step that rewrites it). ``flash_prefill``
        routes the prefill's attention, on either lane, through the flash
        forward, K3 (:meth:`forward_logits_one`): ``None`` where
        :func:`flash_prefill_mode` says so for the padded prompt, ``False``
        never, ``True`` (or ``"interpret"``) always.

        ``temperature > 0`` samples (the JAX package's sampled path, token
        for token with it up to the two frameworks' rounding at near-ties):
        the HF ``repetition_penalty`` over the prompt's and the generated
        tokens, temperature, then the ``top_k`` and nucleus ``top_p``
        filters, then a Gumbel draw from the threefry key stream of
        ``PRNGKey(seed)``, split once a token (:class:`Sampler`). On the
        fused lane the kernel runs in its ``emit_logits`` mode, one launch
        a token, and the sampling stage draws from its logits; the scan
        lane draws from its forward's. The key, the ``seen`` marks, the
        positions and the tokens stay on the device: tokens are read back
        once a chunk, as on the greedy path. ``temperature <= 0`` is greedy,
        and then ``top_k``, ``top_p``, ``seed`` and ``repetition_penalty``
        do nothing."""
        ids = np.asarray(input_ids)
        B, L = ids.shape
        total = min(max_new_tokens, self.max_seq_len)
        if self._numpy_lane(B, dtype, fused, quant, kv_quant):
            if total > L:
                yield from self._generate_numpy(
                    ids, total, temperature=temperature, top_k=top_k,
                    top_p=top_p, seed=seed,
                    repetition_penalty=repetition_penalty)
            return
        fused = self._check_generate(B, dtype, fused, quant, kv_quant)
        if total <= L:
            return
        if fused:
            weights = self._fused_weights(dtype, quant)
        elif quant:
            weights = self._weights_xq(dtype, quant)
        else:
            weights = self._weights(dtype)
        # the fused lane quantizes its caches after the dense prefill; the
        # scan lane carries (rows, scales) pairs from the prefill on
        ck, cv = self._empty_caches(B, weights["tok"].dtype,
                                    None if fused else kv_quant)
        sampler = None
        if temperature is not None and temperature > 0:
            sampler = Sampler(B, self.vocab_size, self.device, temperature,
                              top_k, top_p, seed, repetition_penalty)
        ids_pad, last_idx = (bucket_prompt(ids, L, self.max_seq_len)
                             if bucket_prefill else (ids, None))
        flash = (flash_prefill_mode(weights, ids_pad.shape[1])
                 if flash_prefill is None else flash_prefill)
        tok = self.prefill(weights, ck, cv, ids_pad, last_idx,
                           sampler=sampler, flash=flash)
        tok = tok.to(torch.int32)
        if fused:
            ck, cv = self._flat_caches(ck, cv, weights)
            if kv_quant:  # int8 rows and scales, (N, B, S, D) even at B=1
                if B == 1:
                    ck, cv = ck[:, None], cv[:, None]
                ck, cv = dsk.quantize_kv(ck), dsk.quantize_kv(cv)
        rows, pos = tok[None], L  # (1, B): the prefill token
        while True:
            n = min(chunk, total - pos - 1)
            if n > 0:
                decode = (self.decode_chunk if fused
                          else self.decode_chunk_plain)
                toks = decode(weights, ck, cv, tok, pos, n,
                              sampler=sampler).reshape(n, B)
                tok, pos = toks[-1], pos + n
                rows = torch.cat([rows, toks])
            yield from rows.cpu()[:, :, None]
            if pos + 1 >= total:
                return
            rows = rows[:0]

    # ------------------------- beam search, speculation ----------------------
    @torch.no_grad()
    def generate_beam(self, input_ids, max_new_tokens: int,
                      num_beams: int = 4, length_penalty: float = 1.0,
                      eos_id: int = 2, dtype=None):
        """Beam search for one prompt (B=1) on the scan lane's float weights
        (``generate(fused=False)``'s snapshot), the JAX package's
        ``generate_beam``: returns the best token list (Python ints,
        truncated at ``eos_id``). ``max_new_tokens`` bounds the total
        length, prompt included.

        The prompt is prefilled once at B=1 and its caches repeated to the
        W beams, which decode as batch rows. Each step takes the top W of
        the (W * V) float32 scores ``beam score + log_softmax(logits)``,
        ties to the lower flat index as ``lax.top_k`` takes them (a stable
        descending sort), and reorders the caches and every per-beam state
        by parent beam. A finished beam extends only with ``eos_id``, at no
        cost. The winner maximizes ``score / length ** length_penalty``."""
        ids = np.asarray(input_ids)
        B, L = ids.shape
        if B != 1:
            raise ValueError("generate_beam decodes one prompt at a time")
        n_new = min(max_new_tokens, self.max_seq_len) - L
        if n_new <= 0:
            return []
        W = int(num_beams)
        w = self._weights(dtype)
        dev = self.device

        def top_w(x):  # lax.top_k's order: ties to the lower index
            vals, idx = torch.sort(x, descending=True, stable=True)
            return vals[:W], idx[:W]

        ck1, cv1 = self._empty_caches(1, w["tok"].dtype)
        logits = self.prefill_logits(w, ck1, cv1, ids)
        scores, toks = top_w(torch.log_softmax(logits[0].float(), -1))
        ck, cv = ck1.repeat_interleave(W, 1), cv1.repeat_interleave(W, 1)
        del ck1, cv1
        V = logits.shape[-1]
        seqs = torch.zeros(W, n_new, dtype=torch.int64, device=dev)
        seqs[:, 0] = toks
        fin = toks == eos_id
        lens = torch.ones(W, dtype=torch.float32, device=dev)
        eos_row = torch.full((V,), float("-inf"), device=dev)
        eos_row[eos_id] = 0.0
        for i in range(n_new - 1):
            logits = self.forward_logits_one(w, ck, cv, toks[:, None], L + i)
            logp = torch.log_softmax(logits.float(), -1)
            cont = torch.where(fin[:, None], eos_row[None], logp)
            scores, idx = top_w((scores[:, None] + cont).reshape(-1))
            parent = idx // V
            toks = idx % V
            ck.copy_(ck.index_select(1, parent))
            cv.copy_(cv.index_select(1, parent))
            fin, lens, seqs = fin[parent], lens[parent], seqs[parent]
            seqs[:, i + 1] = toks
            lens = torch.where(fin, lens, lens + 1.0)
            fin = fin | (toks == eos_id)
        best = torch.argmax(scores / lens.pow(length_penalty))
        out = seqs[best, :int(lens[best])].tolist()
        return out[:out.index(eos_id)] if eos_id in out else out

    def generate_speculative(self, input_ids, max_new_tokens: int,
                             draft_k: int = 7, ngram: int = 3, dtype=None,
                             temperature: float = 0.0, top_k: int = None,
                             top_p: float = None, seed: int = 0):
        """Prompt-lookup speculative decoding at B=1 on the scan lane:
        ``(tokens (total - L,) int64, stats)``, greedy equal to
        ``generate(fused=False)``'s stream (``speculative.py``)."""
        from .speculative import generate_speculative
        return generate_speculative(self, input_ids, max_new_tokens,
                                    draft_k=draft_k, ngram=ngram, dtype=dtype,
                                    temperature=temperature, top_k=top_k,
                                    top_p=top_p, seed=seed)
