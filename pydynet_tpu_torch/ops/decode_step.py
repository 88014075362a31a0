"""Greedy Llama decode steps: the ports of the Pallas TPU kernels
``_token_kernel`` (B=1; ``pydynet_tpu/ops/decode_step.py:160``, launched by
``fused_decode_token`` at :1346) and ``_token_kernel_batched`` (B rows
sharing one weight stream; :509, launched by ``fused_decode_token_batched``
at :1027).

``fused_decode_token`` and ``fused_decode_token_batched`` are the wrappers.
For CUDA tensors they launch the hand-written Hopper kernel chains in
``csrc/decode_token.cu`` and ``csrc/decode_token_batched.cu``; for CPU
tensors they run ``fused_decode_token_ref`` and
``fused_decode_token_batched_ref``, the same steps in plain PyTorch. They
never move data between devices and never fall back: a CUDA input a kernel
does not take raises.

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

The batched step takes the same arguments except: ``tok`` (B,) int32;
``ck``, ``cv`` (N, B, S, D) T, row b's cache at ``[:, b]``; ``starts`` (B,)
int32 or None (zeros): row b attends its cache rows
``[starts[b], min(pos, S - 1)]``, its new row always included; ``out`` (B,)
int32. ``pos`` is shared by the rows. The int8 head quantises each row's
activations with its own scale. Each row gets what the B=1 step gives on
that row alone with ``starts[b] = 0``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..nn.modules.norm import rms_norm
from . import _build

_THREADS = 256  # block size of every launch (kThreads in common.cuh)
_SMEM_FLOATS = 48 * 1024 // 4  # shared memory a block gets without opt-in
_SMEM_OPTIN_FLOATS = 232448 // 4  # what it may opt in to on sm_90
MAX_BATCH = 32  # kMaxBatch in decode_token_batched.cu
_WDTYPES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_takes(dim: int, n_heads: int, ffn: int) -> bool:
    """Whether the CUDA kernel takes these model widths. An attention block
    spreads one head's features over its threads, so head_dim <= 256, and
    even for RoPE's pairs; the norm and projection blocks hold one D- or
    F-wide activation vector plus a few reduction slots in shared memory."""
    hd = dim // n_heads
    return (dim % n_heads == 0 and hd % 2 == 0 and hd <= _THREADS
            and max(dim, ffn) + 64 <= _SMEM_FLOATS)


def batched_kernel_takes(dim: int, n_heads: int, ffn: int,
                         batch: int) -> bool:
    """Whether the batched CUDA kernel takes these widths and rows. Its
    blocks hold all B activation rows (D or F wide, float32) in shared
    memory, opting in above 48 KB, so B * max(D, F) plus the head block's
    per-row reduction slots must fit the 227 KB a block may opt in to; a
    warp keeps row b's sums in lane b, so B <= 32; the attention block is
    K1's (head_dim <= 256 and even)."""
    hd = dim // n_heads
    return (dim % n_heads == 0 and hd % 2 == 0 and hd <= _THREADS
            and 1 <= batch <= MAX_BATCH
            and batch * max(dim, ffn) + 1024 <= _SMEM_OPTIN_FLOATS)


def lane_pad_dim(d: int) -> int:
    """Smallest multiple of 128 >= d (``pydynet_tpu/ops/decode_step.py:1274``,
    used by the JAX package's routing rule, ``Llama._tpu_fused_supported``)."""
    return -(-d // 128) * 128


def pick_vt(vocab: int, cap: int = 8192) -> int:
    """Largest 128-multiple vocab tile <= ``cap`` dividing ``vocab``, else
    the largest one at all, else 0 (``decode_step.py:1279``, without the
    ``d_model`` byte budget the routing rule does not pass)."""
    for limit in (min(cap, vocab), vocab):
        for vt in range(limit, 127, -128):
            if vocab % vt == 0 and vt % 128 == 0:
                return vt
    return 0


def pick_sb(seq: int, cap: int = 256) -> int:
    """Largest 16-multiple KV block <= ``cap`` dividing ``seq``, else 0
    (``decode_step.py:1304``)."""
    for sb in range(min(cap, seq), 15, -16):
        if seq % sb == 0:
            return sb
    return 0


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
                            head_s=None, start: int = 0):
    """The plain-PyTorch step up to the float32 logits (V,), caches updated
    in place; :func:`fused_decode_token_ref` takes their argmax. Attention
    reads cache rows ``[start, p]`` (``start`` clipped to ``[0, p]``). Runs
    on any device (it reads ``pos`` and ``tok`` back to the host)."""
    N, S, D = ck.shape
    hd = D // n_heads
    wdt = emb.dtype
    p = min(int(pos.reshape(-1)[0]), S - 1)
    lo = min(max(start, 0), p)
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
        keys = ck[layer, lo:p + 1].float().view(p + 1 - lo, n_heads, hd)
        vals = cv[layer, lo:p + 1].float().view(p + 1 - lo, n_heads, hd)
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


def decode_token_batched_logits_ref(pos, tok, emb, cos, sin, final_norm, wq,
                                    wk, wv, wo, gate_w, up_w, down_w,
                                    in_norm, post_norm, head_w, head_b, ck,
                                    cv, *, n_heads: int, head_s=None,
                                    starts=None):
    """The plain-PyTorch batched step up to the float32 logits (B, V),
    caches updated in place: each row through :func:`decode_token_logits_ref`
    on its own cache ``[:, b]`` from its own ``starts[b]``."""
    lows = [0] * tok.shape[0] if starts is None else starts.tolist()
    return torch.stack([
        decode_token_logits_ref(
            pos, tok[b:b + 1], emb, cos, sin, final_norm, wq, wk, wv, wo,
            gate_w, up_w, down_w, in_norm, post_norm, head_w, head_b,
            ck[:, b], cv[:, b], n_heads=n_heads, head_s=head_s, start=lo)
        for b, lo in enumerate(lows)])


def fused_decode_token_batched_ref(pos, tok, emb, cos, sin, final_norm, wq,
                                   wk, wv, wo, gate_w, up_w, down_w, in_norm,
                                   post_norm, head_w, head_b, ck, cv, *,
                                   n_heads: int, head_s=None, starts=None,
                                   out=None):
    """The plain-PyTorch version of :func:`fused_decode_token_batched`: same
    arguments, same results, on any device."""
    logits = decode_token_batched_logits_ref(
        pos, tok, emb, cos, sin, final_norm, wq, wk, wv, wo, gate_w, up_w,
        down_w, in_norm, post_norm, head_w, head_b, ck, cv, n_heads=n_heads,
        head_s=head_s, starts=starts)
    if out is None:
        out = torch.empty(tok.shape[0], dtype=torch.int32, device=emb.device)
    out[:] = torch.argmax(logits, dim=-1)  # first maximal index per row
    return out


def _check(pos, tok, emb, cos, sin, final_norm, wq, wk, wv, wo, gate_w, up_w,
           down_w, in_norm, post_norm, head_w, head_b, ck, cv, n_heads,
           head_s, out, starts=None, batched=False):
    """Raise unless the arguments have the layouts of the module doc (the
    batched step's when ``batched``). Returns (B, N, S, D, F, V), B = 1 for
    the B=1 step."""
    if ck.dim() != (4 if batched else 3):
        raise ValueError(f"ck: expected {4 if batched else 3} dims, got "
                         f"{tuple(ck.shape)}")
    if batched:
        N, B, S, D = ck.shape
        rows, cache = (B,), (N, B, S, D)
    else:
        (N, S, D), B = ck.shape, 1
        rows, cache = (1,), (N, S, D)
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
        "head_b": (head_b, (V,), wdt), "ck": (ck, cache, wdt),
        "cv": (cv, cache, wdt), "pos": (pos, (1,), torch.int32),
        "tok": (tok, rows, torch.int32),
    }
    if head_s is not None:
        shapes["head_s"] = (head_s, (V,), torch.float32)
    if starts is not None:
        shapes["starts"] = (starts, rows, torch.int32)
    if out is not None:
        shapes["out"] = (out, rows, torch.int32)
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != emb.device:
            raise ValueError(f"{name} is on {t.device}, weights on "
                             f"{emb.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, N, S, D, F, V


def _check_cuda(emb, takes, what):
    """Raise unless ``emb`` is on a CUDA device and the kernel takes the
    shapes (``takes``)."""
    if emb.device.type != "cuda":
        raise ValueError(f"no decode kernel for device {emb.device}")
    if not takes:
        raise ValueError(f"beyond the kernel's limits: {what}")


def fused_decode_token(pos, tok, emb, cos, sin, final_norm, wq, wk, wv, wo,
                       gate_w, up_w, down_w, in_norm, post_norm, head_w,
                       head_b, ck, cv, *, n_heads: int, head_s=None,
                       out=None):
    """One greedy decode step (see the module doc for the layouts). CUDA
    tensors launch ``csrc/decode_token.cu``; CPU tensors run
    :func:`fused_decode_token_ref`."""
    args = (pos, tok, emb, cos, sin, final_norm, wq, wk, wv, wo, gate_w,
            up_w, down_w, in_norm, post_norm, head_w, head_b, ck, cv)
    _, N, S, D, F, V = _check(*args, n_heads, head_s, out)
    if emb.device.type == "cpu":
        return fused_decode_token_ref(*args, n_heads=n_heads, head_s=head_s,
                                      out=out)
    _check_cuda(emb, kernel_takes(D, n_heads, F),
                f"D={D}, n_heads={n_heads}, F={F}")
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


def fused_decode_token_batched(pos, tok, emb, cos, sin, final_norm, wq, wk,
                               wv, wo, gate_w, up_w, down_w, in_norm,
                               post_norm, head_w, head_b, ck, cv, *,
                               n_heads: int, head_s=None, starts=None,
                               out=None):
    """One greedy decode step for B rows (see the module doc for the
    layouts). CUDA tensors launch ``csrc/decode_token_batched.cu``, one
    weight stream for all rows; CPU tensors run
    :func:`fused_decode_token_batched_ref`."""
    args = (pos, tok, emb, cos, sin, final_norm, wq, wk, wv, wo, gate_w,
            up_w, down_w, in_norm, post_norm, head_w, head_b, ck, cv)
    B, N, S, D, F, V = _check(*args, n_heads, head_s, out, starts,
                              batched=True)
    if emb.device.type == "cpu":
        return fused_decode_token_batched_ref(
            *args, n_heads=n_heads, head_s=head_s, starts=starts, out=out)
    _check_cuda(emb, batched_kernel_takes(D, n_heads, F, B),
                f"B={B}, D={D}, n_heads={n_heads}, F={F}")
    lib = _build.load()
    hd = D // n_heads
    if out is None:
        out = torch.empty(B, dtype=torch.int32, device=emb.device)
    scratch = torch.empty(
        lib.pdt_decode_token_batched_scratch_floats(B, D, n_heads, F, V, S),
        dtype=torch.float32, device=emb.device)
    ptrs = [None if t is None else t.data_ptr()
            for t in (pos, tok, starts, out, emb, cos, sin, final_norm, wq,
                      wk, wv, wo, gate_w, up_w, down_w, in_norm, post_norm,
                      head_w, head_s, head_b, ck, cv, scratch)]
    with torch.cuda.device(emb.device):  # launch on the tensors' GPU
        stream = torch.cuda.current_stream().cuda_stream
        fused_decode_token_batched.launches += 1
        err = lib.pdt_decode_token_batched(
            _WDTYPES[emb.dtype], int(head_s is not None), *ptrs, B, N, D,
            n_heads, F, V, S, ctypes.c_float(1.0 / math.sqrt(hd)), stream)
    if err != 0:
        raise RuntimeError(f"decode_token_batched launch failed: CUDA error "
                           f"{err}")
    return out


fused_decode_token_batched.launches = 0
