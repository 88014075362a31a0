"""Fidelity gates for the fused decode kernels (port of the argmax gate in
``pydynet_tpu/utils/fidelity.py``).

The kernel is driven teacher-forced along a greedy token stream from the
eager float32 model, and its per-step token must equal that stream at every
step whose float32 top-2 margin clears bf16 noise. Teacher forcing stops one
near-tie flip from cascading, so the gate checks the kernel's arithmetic, not
the chaos of a random-weight stream.
"""
from __future__ import annotations

import numpy as np
import torch

MARGIN = 0.05      # absolute floor: bf16 rounding at |logit| ~ 5 is ~ 0.04
REL_MARGIN = 0.02  # plus this share of |top logit|: bf16's ulp is |x|/256


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
                      dtype=None, quant=None, margin: float = MARGIN,
                      rel: float = REL_MARGIN):
    """``(checked, ok, agree)`` for one weight format on the model's device:
    the dense prefill's token and then the fused step's token, fed the
    ``truth`` stream, must equal it at every confident step of every row.
    B=1 drives the B=1 kernel (``fused_step``), B>1 the batched one
    (``fused_step_batched``) on all rows at once. Zero confident steps is
    not a pass. ``agree`` is the agreeing share of the checked steps."""
    prompt_ids = np.asarray(prompt_ids)
    B, L = prompt_ids.shape
    w = model._fused_weights(dtype, quant)
    ck5, cv5 = model._empty_caches(B, w["tok"].dtype)
    first = model.prefill(w, ck5, cv5, prompt_ids).cpu().numpy()
    ck, cv = model._flat_caches(ck5, cv5)
    steps = truth.shape[0]
    dev = model.device
    toks_in = torch.as_tensor(truth[:-1], dtype=torch.int32, device=dev)
    positions = torch.arange(L, L + steps - 1, dtype=torch.int32, device=dev)
    outs = torch.empty(steps - 1, B, dtype=torch.int32, device=dev)
    for i in range(steps - 1):
        if B == 1:
            model.fused_step(w, ck, cv, toks_in[i], positions[i:i + 1],
                             out=outs[i])
        else:
            model.fused_step_batched(w, ck, cv, toks_in[i],
                                     positions[i:i + 1], out=outs[i])
    got = np.concatenate([first[None], outs.cpu().numpy()])  # (steps, B)
    conf = _confident(margins, tops, margin, rel)
    checked = int(conf.sum())  # per row and step, as the JAX gate counts
    ok = int((got[conf] == truth[conf]).sum())
    frac = ok / checked if checked else 0.0
    return checked, checked > 0 and ok == checked, frac
