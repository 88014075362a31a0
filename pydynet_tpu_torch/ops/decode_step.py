"""One greedy B=1 Llama decode step: the port of the Pallas TPU kernel
``_token_kernel`` (``pydynet_tpu/ops/decode_step.py:160``, launched by
``fused_decode_token`` at :1346).

``fused_decode_token`` is the wrapper. For CUDA tensors it launches the
hand-written Hopper kernel chain in ``csrc/decode_token.cu``; for CPU
tensors it runs ``fused_decode_token_ref``, the same step in plain PyTorch.
It never moves data between devices and never falls back: a CUDA input the
kernel does not take raises.

Layouts (T is the weight type, float32 or bfloat16; N layers, S cache rows,
D model width, F ffn width, V vocab):

* ``pos``, ``tok``: (1,) int32 on the weights' device (device memory, so a
  chain of steps never waits for the host). ``pos >= S`` acts as ``S - 1``.
* ``emb`` (V, D); ``cos``, ``sin`` (S, D): interleaved RoPE tables,
  ``tile(repeat(cos, 2), H)``; ``final_norm`` (D,); all T.
* ``wq``, ``wk``, ``wv``, ``wo`` (N, D, D); ``gate_w``, ``up_w`` (N, F, D);
  ``down_w`` (N, D, F): torch's (out, in) layout, T. ``in_norm``,
  ``post_norm`` (N, D), T.
* ``head_w`` (V, D) T with ``head_b`` (V,) T; or, for the int8 head,
  ``head_w`` int8 with per-row float32 scales ``head_s`` (V,).
* ``ck``, ``cv`` (N, S, D) T: updated in place at row ``min(pos, S - 1)``.

Returns ``out``, a (1,) int32 tensor holding the next token (allocated when
not given). The residual stream is float32; each matmul input is rounded to
T and accumulated in float32; argmax ties go to the lowest index.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..nn.modules.norm import rms_norm
from . import _build

_THREADS = 256  # block size of every launch (kThreads in decode_token.cu)
_SMEM_FLOATS = 48 * 1024 // 4  # shared memory a block gets without opt-in
_WDTYPES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_takes(dim: int, n_heads: int, ffn: int) -> bool:
    """Whether the CUDA kernel takes these model widths. An attention block
    spreads one head's features over its threads, so head_dim <= 256, and
    even for RoPE's pairs; the norm and projection blocks hold one D- or
    F-wide activation vector plus a few reduction slots in shared memory."""
    hd = dim // n_heads
    return (dim % n_heads == 0 and hd % 2 == 0 and hd <= _THREADS
            and max(dim, ffn) + 64 <= _SMEM_FLOATS)


def _rope_pairs(x, cos, sin):
    """Rotate interleaved (2i, 2i+1) pairs: x (..., D); cos/sin (D,) f32."""
    xr, xi = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = xr * cos[0::2] - xi * sin[0::2]
    out[..., 1::2] = xi * cos[1::2] + xr * sin[1::2]
    return out


def decode_token_logits_ref(pos, tok, emb, cos, sin, final_norm, wq, wk, wv,
                            wo, gate_w, up_w, down_w, in_norm, post_norm,
                            head_w, head_b, ck, cv, *, n_heads: int,
                            head_s=None):
    """The plain-PyTorch step up to the float32 logits (V,), caches updated
    in place; :func:`fused_decode_token_ref` takes their argmax. Runs on any
    device (it reads ``pos`` and ``tok`` back to the host)."""
    N, S, D = ck.shape
    hd = D // n_heads
    wdt = emb.dtype
    p = min(int(pos.reshape(-1)[0]), S - 1)
    t = int(tok.reshape(-1)[0])

    def mm(w, x):  # input rounded to the weight type, f32 accumulation
        return torch.mv(w.float(), x.to(wdt).float())

    c, s = cos[p].float(), sin[p].float()
    h = emb[t].float()
    for layer in range(N):
        x = rms_norm(h, in_norm[layer])
        q = _rope_pairs(mm(wq[layer], x), c, s)
        k = _rope_pairs(mm(wk[layer], x), c, s)
        ck[layer, p] = k.to(wdt)
        cv[layer, p] = mm(wv[layer], x).to(wdt)
        keys = ck[layer, :p + 1].float().view(p + 1, n_heads, hd)
        vals = cv[layer, :p + 1].float().view(p + 1, n_heads, hd)
        qh = q.to(wdt).float().view(n_heads, hd)
        scores = torch.einsum("nhd,hd->hn", keys, qh) * (1.0 / math.sqrt(hd))
        att = torch.einsum("hn,nhd->hd", torch.softmax(scores, -1), vals)
        z = h + mm(wo[layer], att.reshape(D))
        zn = rms_norm(z, post_norm[layer])
        g, u = mm(gate_w[layer], zn), mm(up_w[layer], zn)
        h = z + mm(down_w[layer], g * torch.sigmoid(g) * u)
    hf = rms_norm(h, final_norm)
    if head_s is None:
        logits = mm(head_w, hf) + head_b.float()
    else:  # int8 head: per-call activation quantisation (TPU kernel's qvec)
        amax = torch.clamp(hf.abs().max(), min=1e-30)
        xq = torch.round(hf * (127.0 / amax))
        acc = torch.mv(head_w.double(), xq.double()).float()  # exact
        logits = acc * (head_s.reshape(-1).float() * (amax * (1.0 / 127.0))) \
            + head_b.float()
    return logits


def fused_decode_token_ref(pos, tok, emb, cos, sin, final_norm, wq, wk, wv,
                           wo, gate_w, up_w, down_w, in_norm, post_norm,
                           head_w, head_b, ck, cv, *, n_heads: int,
                           head_s=None, out=None):
    """The plain-PyTorch version of :func:`fused_decode_token`: same
    arguments, same results, on any device."""
    logits = decode_token_logits_ref(
        pos, tok, emb, cos, sin, final_norm, wq, wk, wv, wo, gate_w, up_w,
        down_w, in_norm, post_norm, head_w, head_b, ck, cv, n_heads=n_heads,
        head_s=head_s)
    if out is None:
        out = torch.empty(1, dtype=torch.int32, device=emb.device)
    out[0] = torch.argmax(logits)  # first maximal index
    return out


def _check(pos, tok, emb, cos, sin, final_norm, wq, wk, wv, wo, gate_w, up_w,
           down_w, in_norm, post_norm, head_w, head_b, ck, cv, n_heads,
           head_s, out):
    """Raise unless the arguments have the layouts of the module doc."""
    N, S, D = ck.shape
    V = emb.shape[0]
    F = gate_w.shape[1]
    wdt = emb.dtype
    if wdt not in _WDTYPES:
        raise TypeError(f"weights must be float32 or bfloat16, got {wdt}")
    if N < 1 or D % n_heads or (D // n_heads) % 2:
        raise ValueError(f"need >= 1 layer and an even head_dim: N={N}, "
                         f"D={D}, n_heads={n_heads}")
    shapes = {
        "emb": (emb, (V, D), wdt), "cos": (cos, (S, D), wdt),
        "sin": (sin, (S, D), wdt), "final_norm": (final_norm, (D,), wdt),
        "wq": (wq, (N, D, D), wdt), "wk": (wk, (N, D, D), wdt),
        "wv": (wv, (N, D, D), wdt), "wo": (wo, (N, D, D), wdt),
        "gate_w": (gate_w, (N, F, D), wdt), "up_w": (up_w, (N, F, D), wdt),
        "down_w": (down_w, (N, D, F), wdt),
        "in_norm": (in_norm, (N, D), wdt),
        "post_norm": (post_norm, (N, D), wdt),
        "head_w": (head_w, (V, D), wdt if head_s is None else torch.int8),
        "head_b": (head_b, (V,), wdt), "ck": (ck, (N, S, D), wdt),
        "cv": (cv, (N, S, D), wdt), "pos": (pos, (1,), torch.int32),
        "tok": (tok, (1,), torch.int32),
    }
    if head_s is not None:
        shapes["head_s"] = (head_s, (V,), torch.float32)
    if out is not None:
        shapes["out"] = (out, (1,), torch.int32)
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != emb.device:
            raise ValueError(f"{name} is on {t.device}, weights on "
                             f"{emb.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return N, S, D, F, V


def fused_decode_token(pos, tok, emb, cos, sin, final_norm, wq, wk, wv, wo,
                       gate_w, up_w, down_w, in_norm, post_norm, head_w,
                       head_b, ck, cv, *, n_heads: int, head_s=None,
                       out=None):
    """One greedy decode step (see the module doc for the layouts). CUDA
    tensors launch ``csrc/decode_token.cu``; CPU tensors run
    :func:`fused_decode_token_ref`."""
    args = (pos, tok, emb, cos, sin, final_norm, wq, wk, wv, wo, gate_w,
            up_w, down_w, in_norm, post_norm, head_w, head_b, ck, cv)
    N, S, D, F, V = _check(*args, n_heads, head_s, out)
    if emb.device.type == "cpu":
        return fused_decode_token_ref(*args, n_heads=n_heads, head_s=head_s,
                                      out=out)
    if emb.device.type != "cuda":
        raise ValueError(f"no decode kernel for device {emb.device}")
    if not kernel_takes(D, n_heads, F):
        raise ValueError(f"dims beyond the kernel's limits: D={D}, "
                         f"n_heads={n_heads}, F={F}")
    lib = _build.load()
    hd = D // n_heads
    if out is None:
        out = torch.empty(1, dtype=torch.int32, device=emb.device)
    scratch = torch.empty(
        lib.pdt_decode_token_scratch_floats(D, n_heads, F, V, S),
        dtype=torch.float32, device=emb.device)
    dummy = head_w if head_s is None else head_s
    ptrs = [t.data_ptr() for t in (pos, tok, out, emb, cos, sin, final_norm,
                                   wq, wk, wv, wo, gate_w, up_w, down_w,
                                   in_norm, post_norm, head_w, dummy, head_b,
                                   ck, cv, scratch)]
    with torch.cuda.device(emb.device):  # launch on the tensors' GPU
        stream = torch.cuda.current_stream().cuda_stream
        fused_decode_token.launches += 1
        err = lib.pdt_decode_token(
            _WDTYPES[emb.dtype], int(head_s is not None), *ptrs, N, D,
            n_heads, F, V, S, ctypes.c_float(1.0 / math.sqrt(hd)), stream)
    if err != 0:
        raise RuntimeError(f"decode_token launch failed: CUDA error {err}")
    return out


fused_decode_token.launches = 0
