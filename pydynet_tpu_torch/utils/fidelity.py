"""Fidelity gates for the decode lanes (port of the argmax, logits and
sampled gates and the dequantized truth of
``pydynet_tpu/utils/fidelity.py``).

A lane is driven teacher-forced along a greedy token stream from a truth
model, and its per-step token must equal that stream at every step whose
top-2 margin clears bf16 noise (``gate_fused_argmax``, ``gate_scan_argmax``),
or, for a lossy weight format, agree with it on a majority of steps
(``min_agree``). Teacher forcing stops one near-tie flip from cascading, so
the gate checks the lane's arithmetic, not the chaos of a random-weight
stream. ``dequant_inplace`` makes the truth of a lossy format: the weights
round-tripped through it, so the quantized lane differs from the truth only
by the per-call activation quantization. ``gate_fused_logits`` and
``gate_fused_sampled`` hold the B=1 kernel's ``emit_logits`` mode, which the
sampled decode runs, against the scan lane's logits, as logits and as the
tokens the sampling stage draws from them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import decode_step as dsk
from ..ops import quant as Q

MARGIN = 0.05      # absolute floor: bf16 rounding at |logit| ~ 5 is ~ 0.04
REL_MARGIN = 0.02  # plus this share of |top logit|: bf16's ulp is |x|/256
_ROUND_TRIPPED = ("attention.Q", "attention.K", "attention.V", "attention.O",
                  "ffn.gate", "ffn.up", "ffn.down")


@torch.no_grad()
def dequant_inplace(model, quant: str = "int4"):
    """Round-trip the model's matmul weights (every layer's seven and the
    head) through ``quant`` ("int8" or "int4") with per-output-channel
    scales over the contraction axis, as the scan lane's ``_weights_xq``
    quantizes them, IN PLACE. Per-output-channel scales commute with the
    scan lane's q/k/v and gate/up concatenation, so this is exactly the
    quantized lane's weight error. Returns the model."""
    if quant == "int4":
        def rt(a):
            return Q.dequantize_int4(*Q.quantize_int4(a, axis=1), axis=1)
    elif quant == "int8":
        def rt(a):
            return Q.dequantize_int8(*Q.quantize_int8(a, axis=1))
    else:
        raise ValueError(f"unsupported quant mode: {quant!r}")
    names = [f"layers.{i}.{m}.weight" for i in range(model.n_layers)
             for m in _ROUND_TRIPPED] + ["lm_head.weight"]
    for name in names:
        p = model.get_parameter(name)
        p.copy_(rt(p))
    model._weights_cache.clear()
    return model


def dequant_int4_inplace(model):
    """``dequant_inplace(model, "int4")``."""
    return dequant_inplace(model, "int4")


@torch.no_grad()
def greedy_truth(model, prompt_ids, steps: int):
    """Greedy stream from the eager module path, with per-step top-2
    margins and top values. Returns ``(truth, margins, tops)``, each
    (steps, B)."""
    prompt_ids = np.asarray(prompt_ids)
    B, L = prompt_ids.shape
    truth, margins, tops = [], [], []
    logits = model(prompt_ids, 0)[:, -1].float().cpu().numpy()
    for i in range(steps):
        srt = np.sort(logits, axis=-1)
        margins.append(srt[:, -1] - srt[:, -2])
        tops.append(srt[:, -1])
        nxt = logits.argmax(-1)
        truth.append(nxt)
        logits = model(nxt[:, None], L + i)[:, -1].float().cpu().numpy()
    return np.array(truth), np.array(margins), np.array(tops)


def _confident(margins, tops, margin, rel):
    """Steps whose top-2 gap clears ``margin`` plus ``rel * |top|``."""
    thr = margin + (rel * np.abs(tops) if tops is not None else 0.0)
    return margins > thr


@torch.no_grad()
def gate_fused_argmax(model, prompt_ids, truth, margins, tops=None, *,
                      dtype=None, quant=None, kv_quant=None,
                      margin: float = MARGIN, rel: float = REL_MARGIN,
                      min_agree: float = None, flash=False):
    """``(checked, ok, agree)`` for one weight format on the model's device:
    the dense prefill's token and then the fused step's token, fed the
    ``truth`` stream, must equal it at every confident step of every row.
    B=1 drives the B=1 kernel (``fused_step``), B>1 the batched one
    (``fused_step_batched``) on all rows at once. ``kv_quant="int8"``
    quantizes the prefill's caches (``quantize_kv``) and drives the batched
    kernel's int8 KV mode at every B, as ``generate`` does. Zero confident
    steps is not a pass. ``agree`` is the agreeing share of the checked
    steps. ``min_agree`` makes it the JAX package's majority gate for lossy
    formats (int8, int4, the int8 KV cache): every step is checked and the
    agreeing share must reach ``min_agree``. ``flash`` takes the prefill's
    attention through the flash forward (``Llama.forward_logits_one``)."""
    prompt_ids = np.asarray(prompt_ids)
    B, L = prompt_ids.shape
    w = model._fused_weights(dtype, quant)
    ck5, cv5 = model._empty_caches(B, w["tok"].dtype)
    first = model.prefill(w, ck5, cv5, prompt_ids, flash=flash).cpu().numpy()
    ck, cv = model._flat_caches(ck5, cv5, w)
    if kv_quant:
        if B == 1:  # the batched kernel's (N, 1, S, D) layout
            ck, cv = ck[:, None], cv[:, None]
        ck, cv = dsk.quantize_kv(ck), dsk.quantize_kv(cv)
    steps = truth.shape[0]
    dev = model.device
    toks_in = torch.as_tensor(truth[:-1], dtype=torch.int32, device=dev)
    positions = torch.arange(L, L + steps - 1, dtype=torch.int32, device=dev)
    outs = torch.empty(steps - 1, B, dtype=torch.int32, device=dev)
    for i in range(steps - 1):
        if B == 1 and not kv_quant:
            model.fused_step(w, ck, cv, toks_in[i], positions[i:i + 1],
                             out=outs[i])
        else:
            model.fused_step_batched(w, ck, cv, toks_in[i],
                                     positions[i:i + 1], out=outs[i])
    got = np.concatenate([first[None], outs.cpu().numpy()])  # (steps, B)
    if min_agree is not None:
        frac = float((got == truth).mean()) if truth.size else 0.0
        return truth.size, truth.size > 0 and frac >= min_agree, frac
    conf = _confident(margins, tops, margin, rel)
    checked = int(conf.sum())  # per row and step, as the JAX gate counts
    ok = int((got[conf] == truth[conf]).sum())
    frac = ok / checked if checked else 0.0
    return checked, checked > 0 and ok == checked, frac


def _top2(logits):
    srt = torch.sort(logits.float(), dim=-1).values
    return (srt[..., -1] - srt[..., -2]).cpu().numpy(), \
        srt[..., -1].cpu().numpy()


@torch.no_grad()
def scan_truth(model, prompt_ids, steps: int, *, dtype=None, quant=None,
               forced=None):
    """Greedy stream of the scan lane (``generate(fused=False)``'s
    forward, in ``dtype`` and ``quant``) with per-step top-2 margins and top
    values: ``(truth, margins, tops)``, each (steps, B). The truth of the
    gates below on a model too large for the eager float32 stream. With
    ``forced`` (steps, B) the lane is fed those tokens instead of its own
    argmax: the margins are then those along the ``forced`` stream."""
    prompt_ids = np.asarray(prompt_ids)
    B, L = prompt_ids.shape
    w = model._weights_xq(dtype, quant) if quant else model._weights(dtype)
    ck, cv = model._empty_caches(B, w["tok"].dtype)
    tokens = torch.as_tensor(prompt_ids, dtype=torch.long,
                             device=model.device)
    logits = model.forward_logits_one(w, ck, cv, tokens, 0)
    truth, margins, tops = [], [], []
    for i in range(steps):
        m, t = _top2(logits)
        margins.append(m)
        tops.append(t)
        nxt = logits.argmax(-1)
        truth.append(nxt.cpu().numpy())
        if forced is not None:
            nxt = torch.as_tensor(forced[i], device=model.device)
        if i + 1 < steps:
            logits = model.forward_logits_one(w, ck, cv, nxt[:, None], L + i)
    return np.array(truth), np.array(margins), np.array(tops)


@torch.no_grad()
def gate_scan_argmax(model, prompt_ids, truth, margins, tops=None, *,
                     dtype=None, quant=None, margin: float = MARGIN,
                     rel: float = REL_MARGIN, min_agree: float = None,
                     flash=False):
    """``(checked, ok, agree)`` for the scan lane in ``dtype`` and ``quant``
    (its quantized matmuls on a GPU), teacher-forced along ``truth``: its
    prefill token and then each step's token must equal the truth at every
    confident step of every row, as :func:`gate_fused_argmax` asks of the
    fused kernels; zero confident steps is not a pass. ``min_agree`` makes
    it the JAX package's majority gate for lossy formats: every step is
    checked and the agreeing share must reach ``min_agree``. ``flash``
    takes the prefill's attention through the flash forward."""
    prompt_ids = np.asarray(prompt_ids)
    B, L = prompt_ids.shape
    w = model._weights_xq(dtype, quant) if quant else model._weights(dtype)
    ck, cv = model._empty_caches(B, w["tok"].dtype)
    got = [model.prefill(w, ck, cv, prompt_ids, flash=flash)]
    toks_in = torch.as_tensor(truth[:-1], dtype=torch.long,
                              device=model.device)
    for i in range(truth.shape[0] - 1):
        got.append(model.forward_logits_one(w, ck, cv, toks_in[i][:, None],
                                            L + i).argmax(-1))
    got = torch.stack(got).cpu().numpy()  # (steps, B)
    if min_agree is not None:
        frac = float((got == truth).mean()) if truth.size else 0.0
        return truth.size, truth.size > 0 and frac >= min_agree, frac
    conf = _confident(margins, tops, margin, rel)
    checked = int(conf.sum())
    ok = int((got[conf] == truth[conf]).sum())
    frac = ok / checked if checked else 0.0
    return checked, checked > 0 and ok == checked, frac


@torch.no_grad()
def _teacher_forced_logits(model, prompt_ids, truth, dtype=None, quant=None):
    """``(fused_lg, scan_lg)``, both (steps - 1, V) float32 on the model's
    device: the B=1 fused kernel's ``emit_logits`` output and the scan
    lane's forward logits (float weights in ``dtype``), each teacher-forced
    along the same ``truth`` stream after its own dense prefill of the
    prompt. Shared by the logits gate and the sampled-stream gate."""
    prompt_ids = np.asarray(prompt_ids)
    B, L = prompt_ids.shape
    if B != 1:
        raise ValueError(f"the logits gates are B=1, got B={B}")
    w = model._fused_weights(dtype, quant)
    dev = model.device
    steps = truth.shape[0]
    toks_in = torch.as_tensor(truth[:-1], dtype=torch.int32,
                              device=dev).reshape(steps - 1, 1)
    positions = torch.arange(L, L + steps - 1, dtype=torch.int32, device=dev)
    ck5, cv5 = model._empty_caches(1, w["tok"].dtype)
    model.prefill(w, ck5, cv5, prompt_ids)
    ck, cv = model._flat_caches(ck5, cv5, w)
    fused_lg = torch.empty(steps - 1, 1, model.vocab_size,
                           dtype=torch.float32, device=dev)
    for i in range(steps - 1):
        model.fused_step(w, ck, cv, toks_in[i], positions[i:i + 1],
                         emit_logits=True, out=fused_lg[i])
    ck5, cv5 = model._empty_caches(1, w["tok"].dtype)
    model.prefill(w, ck5, cv5, prompt_ids)
    scan_lg = torch.stack([
        model.forward_logits_one(w, ck5, cv5, toks_in[i][:, None].long(),
                                 L + i)[0]
        for i in range(steps - 1)])
    return fused_lg[:, 0], scan_lg


def gate_fused_logits(model, prompt_ids, truth, *, dtype=None, quant=None,
                      rel_tol: float = 2e-2, margin: float = MARGIN):
    """``(max_abs_diff, ok)`` (bench.py's ``logits-head-f32`` gate): the
    fused kernel's ``emit_logits`` output, teacher-forced along ``truth``,
    against the scan lane's logits along the same stream on the same
    device and weights. A tile-indexing slip in the emitting head shows as
    differences the size of the logit range, so ``ok`` asks for the largest
    difference below ``rel_tol`` of the logit scale and for the same
    argmax at every step whose scan-lane top-2 margin clears ``margin``
    (at least one such step)."""
    fused_lg, scan_lg = (t.cpu().numpy() for t in _teacher_forced_logits(
        model, prompt_ids, truth, dtype, quant))
    diff = float(np.abs(fused_lg - scan_lg).max())
    scale = float(np.abs(scan_lg).max()) or 1.0
    srt = np.sort(scan_lg, axis=-1)
    confident = _confident(srt[:, -1] - srt[:, -2], srt[:, -1], margin,
                           REL_MARGIN)
    am_ok = bool(confident.any()) and bool(np.all(
        fused_lg[confident].argmax(-1) == scan_lg[confident].argmax(-1)))
    return diff, (diff < rel_tol * scale) and am_ok


def gate_fused_sampled(model, prompt_ids, truth, *, dtype=None, quant=None,
                       temperature: float = 0.8, top_k: int = 50,
                       top_p: float = 0.9, seed: int = 0,
                       min_agree: float = 0.8):
    """``(checked, ok, agree)`` (bench.py's ``sampled-t0.8-k50-p0.9``
    gate): the fused kernel's ``emit_logits`` stream and the scan lane's
    logits stream, both teacher-forced along ``truth``, go through the same
    sampling stage (``sample_logits``: temperature, top-k, nucleus, the
    Gumbel draw) under the same key, the steps axis as the batch axis, and
    the drawn tokens must agree on at least ``min_agree`` of the steps. The
    two streams differ only by the two lanes' rounding, which moves a
    draw only where it sits on a filter or CDF boundary; a filter or
    indexing fault drives the agreement towards one in the nucleus
    size."""
    from ..models.llama.model import sample_logits
    from ..random import PRNGKey

    fused_lg, scan_lg = _teacher_forced_logits(model, prompt_ids, truth,
                                               dtype, quant)
    key = PRNGKey(seed, fused_lg.device)
    tf, tx = (sample_logits(lg, key, temperature, top_k, top_p).cpu().numpy()
              for lg in (fused_lg, scan_lg))
    checked = int(tf.size)
    frac = float((tf == tx).mean()) if checked else 0.0
    return checked, checked > 0 and frac >= min_agree, frac
