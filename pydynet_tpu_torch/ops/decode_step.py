"""Llama decode steps: the ports of the Pallas TPU kernels
``_token_kernel`` (B=1, K1; ``pydynet_tpu/ops/decode_step.py:160``, launched
by ``fused_decode_token`` at :1346), ``_token_kernel_batched`` (B rows
sharing one weight stream, K2; :509, launched by
``fused_decode_token_batched`` at :1027), ``_lm_head_kernel`` (the greedy
head alone, K9; :102, launched by ``lm_head_argmax`` at :129) and
``_kernel`` (the older layers-only B=1 step, K10; :1575, launched by
``fused_decode_step`` at :1657).

``fused_decode_token``, ``fused_decode_token_batched``, ``lm_head_argmax``
and ``fused_decode_step`` are the wrappers. For CUDA tensors they launch
the hand-written Hopper kernels in ``csrc/decode_token.cu`` (K1, K9),
``csrc/decode_token_batched.cu`` (K2) and ``csrc/decode_step.cu`` (K10);
for CPU tensors they run the same functions in plain PyTorch (the ``_ref``
functions). They never move data between devices and never fall back: a
CUDA input a kernel does not take raises. Each wrapper counts its kernel
launches in its ``launches`` attribute.

Layouts (T is the weight type, float32, bfloat16 or float16; N layers, S
cache rows, D model width, F ffn width, V vocab):

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

With ``emit_logits=True`` (the TPU kernels' ``emit_logits`` mode, which the
sampled decode runs) a step returns the float32 logits instead of the token:
``out`` is then a (1, V) float32 tensor (the batched step's (B, V)). They
are the values the greedy mode's argmax compares, bias added and the
quantized head's scales applied, so their argmax is its token. The step
skips the argmax launch. Each wrapper counts these launches apart, in its
``emit_launches`` attribute.

K1 also takes quantized layers (the TPU kernel's ``qlayers`` and ``q4``
modes): with ``scales`` (seven float32 (N, out) tensors, one per matrix in
the order wq, wk, wv, wo, gate_w, up_w, down_w) the seven layer matrices are
int8 (N, out, in), or with ``q4`` int4 packed along ``in`` (N, out, in / 2)
(``ops/quant.py``), and the head is quantized the same way with ``head_s``.
Each quantized matmul quantizes its float32 activation vector per call
(``amax = max(max |x|, 1e-30)``, ``rint(x * 127 / amax)``, no clip; the
normed h, the attention output, the normed z and the SwiGLU output, none
rounded to T), accumulates exactly and rescales by ``scale * amax / 127``.
The caches stay T.

The batched step takes the same arguments except: ``tok`` (B,) int32;
``ck``, ``cv`` (N, B, S, D) T, row b's cache at ``[:, b]``; ``starts`` (B,)
int32 or None (zeros): row b attends its cache rows
``[starts[b], min(pos, S - 1)]``, its new row always included; ``out`` (B,)
int32. ``pos`` is shared by the rows. The int8 head and the int8 and int4
layers quantise each row's activations with its own scale (the TPU kernel's
``qvec_b``). Each row gets what the B=1 step gives on that row alone with
``starts[b] = 0``.

The batched step also takes an int8 KV cache (the TPU kernel's ``kv_int8``
mode; float weights only): ``ck``, ``cv`` (N, B, S, D) int8 with float32
per-row scales ``sk``, ``sv`` (N, B, S), as :func:`quantize_kv` makes them.
The new K and V rows are quantized by that scheme over the whole D-wide row
and written with their scales at ``min(pos, S - 1)``. The query is quantized
per row the same way; a cached row's score is the exact integer dot per head
times its ``sk`` times the query's scale times ``1 / sqrt(head_dim)``; the
new row scores its dequantized key against the exact float32 query. Values
are ``cv * sv``, the new row's dequantized.

Both steps take a grouped-query model's narrow cache (the TPU kernels'
``narrow`` mode): with ``n_kv_heads`` = Hkv < ``n_heads`` = H, ``wk`` and
``wv`` are (N, Dkv, D), Dkv = Hkv * head_dim, and the caches (N, [B,] S,
Dkv), so cache traffic scales with Hkv. Query head h reads KV head
``h // (H / Hkv)``; k is rotated by the first Dkv columns of ``cos``/``sin``
(the table repeats per head). The narrow cache combines with float weights,
the int8 head, the int8 KV cache (scales over the Dkv-wide rows; the query's
still over its D features), ``starts`` and ``emit_logits``, never with
int8/int4 layers: a grouped-query model runs those on the expanded (MHA)
layout, each KV head's rows repeated to its query group, as the JAX package
does. Each wrapper counts its narrow launches, of either mode, also in its
``narrow_launches`` attribute.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..nn.modules.norm import rms_norm
from . import _build
from .quant import unpack_int4

_THREADS = 256  # block size of every launch (kThreads in common.cuh)
_SMEM_FLOATS = 48 * 1024 // 4  # shared memory a block gets without opt-in
_SMEM_OPTIN_BYTES = 232448  # what it may opt in to on sm_90
_SMEM_OPTIN_FLOATS = _SMEM_OPTIN_BYTES // 4
ROW_GROUP = 32  # kRowGroup in decode_token_batched.cuh
_HEAD_RING_FLOATS = 4 * 128 * 64 // 4  # kHeadRing in head.cuh
_MAX_GRID_Z = 65535  # the attention grid's rows, one a z index
_WDTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# a layer-stage block (csrc/decode_token_batched.cuh): 8 warps, each with a
# cp.async ring of 4 stages of 64 bytes of 16 weight rows a tile
_WARPS, _TILE_STAGES, _STAGE_BYTES, _LAYER_ROWS = 8, 4, 64, 16


def act_row_bytes(k: int, itemsize: int = 4, q4: bool = False) -> int:
    """Bytes of one activation row of ``k`` elements in a product's shared
    memory (``act_rows`` in ``csrc/mma_rows.cuh``): the 64-byte stages that
    cover a weight row of ``itemsize`` bytes an element (4 float32, 2
    bfloat16 or float16, 1 int8; ``q4``: int4, two a byte), padded for
    the banks."""
    wbytes = k // 2 if q4 else k * itemsize
    span = -(-wbytes // _STAGE_BYTES) * _STAGE_BYTES
    if itemsize == 4:
        return (-(-span // 4 // 32) * 32 + 4) * 4
    if q4:
        return -(-2 * span // 128) * 128 + 16
    return -(-span // 128) * 128 + 16


def layer_smem_bytes(k: int, rows: int, tiles: int, itemsize: int = 4,
                     q4: bool = False, norm_itemsize: int = 0) -> int:
    """Dynamic shared memory of a layer-stage block (``layer_smem`` in
    ``csrc/decode_token_batched.cuh``): ``tiles`` 16-row weight tiles
    (gate/up: 2) streamed through each warp's 4-stage ring, and ``rows``
    activation rows of ``k`` elements (:func:`act_row_bytes`). A stage
    that normalises its rows (``norm_smem``: q/k/v, gate/up) also holds the
    raw rows, 4 bytes an element, and the norm weights of
    ``norm_itemsize`` bytes each (the weight type's)."""
    raw = rows * k * 4 + -(-k * norm_itemsize // 16) * 16 \
        if norm_itemsize else 0
    return (_WARPS * _TILE_STAGES * tiles * _LAYER_ROWS * _STAGE_BYTES
            + rows * act_row_bytes(k, itemsize, q4) + raw)


def _heads_take(dim: int, n_heads: int, n_kv_heads=None) -> bool:
    """An attention block spreads one head's features over its threads, so
    head_dim <= 256, and even for RoPE's pairs; the KV heads divide the
    query heads."""
    hkv = n_kv_heads or n_heads
    hd = dim // n_heads
    return (dim % n_heads == 0 and hd % 2 == 0 and hd <= _THREADS
            and 1 <= hkv <= n_heads and n_heads % hkv == 0)


def kernel_takes(dim: int, n_heads: int, ffn: int, q4: bool = False,
                 n_kv_heads: int = None) -> bool:
    """Whether the CUDA kernel takes these model widths (``n_kv_heads``:
    the narrow cache's KV heads, None for MHA): the heads as
    :func:`_heads_take`; max(D, F) plus 64 floats within the 48 KB a block
    gets without opting in (the bound K1 has had from the start; K1 runs
    K2's stages on one row, whose blocks fit their opt-in at these widths:
    :func:`batched_kernel_takes` at B = 1); int4 packs pairs of contraction
    rows, so ``q4`` needs D and F even."""
    return (_heads_take(dim, n_heads, n_kv_heads)
            and max(dim, ffn) + 64 <= _SMEM_FLOATS
            and not (q4 and (dim % 2 or ffn % 2)))


def batched_kernel_takes(dim: int, n_heads: int, ffn: int, batch: int,
                         q4: bool = False, n_kv_heads: int = None) -> bool:
    """Whether the batched CUDA kernel takes these widths and rows. Its
    blocks each take one group of at most ``ROW_GROUP`` rows and hold the
    group's activation rows in shared memory beside their warps' weight
    rings, opting in above 48 KB. So each layer stage's block must fit the
    227 KB a block may opt in to (:func:`layer_smem_bytes` for float32
    weights, whose rows are the widest: the gate/up stage's two tiles over
    D-wide rows with the raw rows and norm weights, the down stage over
    F-wide rows), and so must the head block's weight ring and its
    min(B, 32) activation rows of at most D + 36 floats (``head_smem`` in
    ``csrc/head.cuh``); the attention grid has a row a z index (B <=
    65535); above that B is bounded by device memory only; the heads as
    K1's; ``q4`` needs D and F even."""
    rows = min(batch, ROW_GROUP)
    return (_heads_take(dim, n_heads, n_kv_heads)
            and 1 <= batch <= _MAX_GRID_Z
            and max(layer_smem_bytes(dim, rows, 2, norm_itemsize=4),
                    layer_smem_bytes(ffn, rows, 1)) <= _SMEM_OPTIN_BYTES
            and _HEAD_RING_FLOATS + rows * (dim + 36) <= _SMEM_OPTIN_FLOATS
            and not (q4 and (dim % 2 or ffn % 2)))


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


def _qmm(w, scale, x, q4):
    """The TPU kernel's qvec + qmm for one (out, in) int8 matrix, or an int4
    one packed to (out, in / 2), and a float32 activation vector x (in,):
    the activations quantized per call, the product summed exactly (float64
    holds these int sums exactly) and rescaled by ``scale * amax / 127``."""
    amax = torch.clamp(x.abs().max(), min=1e-30)
    # an IEEE 127 / amax as the kernel and jnp take it: a Python scalar over
    # a tensor is 127 * (1 / amax) in torch, an ulp off a quarter of the time
    xq = torch.round(x * (amax.new_tensor(127.0) / amax)).double()
    if q4:
        lo, hi = unpack_int4(w)
        k2 = w.shape[-1]
        acc = torch.mv(lo.double(), xq[:k2]) + torch.mv(hi.double(), xq[k2:])
    else:
        acc = torch.mv(w.double(), xq)
    return acc.float() * (scale.reshape(-1).float() * (amax * (1.0 / 127.0)))


def quantize_kv(c):
    """(..., W) KV rows -> (int8 rows, (...) float32 per-row scales), the JAX
    package's ``quantize_kv`` (``pydynet_tpu/ops/decode_step.py:1260``):
    ``s = max(max |x| / 127, 1e-10)`` over the last axis (all-zero rows stay
    zero) and ``q = clip(round(x / s), -127, 127)``, round half to even, both
    true divisions as the kernel takes them (a Python scalar would make
    ``amax / 127`` a product with 1 / 127 on a GPU)."""
    x = c.float()
    amax = x.abs().amax(-1)
    s = torch.clamp(amax / amax.new_tensor(127.0), min=1e-10)
    q = torch.clamp(torch.round(x / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def _by_query_head(x, n_heads, hd):
    """(..., Hkv * hd) rows -> (..., H, hd): each KV head repeated to the
    H / Hkv query heads of its group (MHA: a view, no copy)."""
    hkv = x.shape[-1] // hd
    x = x.reshape(x.shape[:-1] + (hkv, hd))
    return x if hkv == n_heads else x.repeat_interleave(n_heads // hkv, -2)


def _attend_kv8(ck, cv, sk, sv, p, lo, q, k, v, n_heads, rows=None):
    """The ``kv_int8`` attention of one row over one layer's int8 caches
    (S, Dkv) with scales (S,): the new K and V rows quantized into row
    ``p`` (or ``rows``, their int8 rows and scales (kq, ks, vq, vs), given),
    cached rows ``[lo, p)`` scored by the exact integer dot with the
    quantized query (its scale over all D features), the new row by its
    dequantized key against the exact float32 query ``q``; query head h
    reads KV head ``h // (H / Hkv)``. Returns the (D,) float32 attention
    output."""
    D = q.shape[0]
    hd = D // n_heads
    scale = 1.0 / math.sqrt(hd)
    (kq, ks), (vq, vs) = ((quantize_kv(k), quantize_kv(v)) if rows is None
                          else (rows[:2], rows[2:]))
    ck[p], sk[p], cv[p], sv[p] = kq, ks, vq, vs
    qq, qs = quantize_kv(q)
    keys = _by_query_head(ck[lo:p].double(), n_heads, hd)  # exact sums
    dots = torch.einsum("nhd,hd->nh", keys,
                        qq.double().view(n_heads, hd)).float()
    s_cache = dots * sk[lo:p, None] * qs * scale
    kself = _by_query_head(kq.float() * ks, n_heads, hd)
    s_self = (kself * q.view(n_heads, hd)).sum(-1) * scale
    scores = torch.cat([s_cache, s_self[None]]).t()             # (H, n + 1)
    vals = _by_query_head(torch.cat([cv[lo:p].float() * sv[lo:p, None],
                                     (vq.float() * vs)[None]]), n_heads, hd)
    att = torch.einsum("hn,nhd->hd", torch.softmax(scores, -1), vals)
    return att.reshape(D)


def decode_token_logits_ref(pos, tok, emb, cos, sin, final_norm, wq, wk, wv,
                            wo, gate_w, up_w, down_w, in_norm, post_norm,
                            head_w, head_b, ck, cv, *, n_heads: int,
                            head_s=None, scales=None, q4: bool = False,
                            start: int = 0, sk=None, sv=None,
                            n_kv_heads: int = None, forced=None,
                            kv_rows=None):
    """The plain-PyTorch step up to the float32 logits (V,), caches updated
    in place; :func:`fused_decode_token_ref` takes their argmax. Attention
    reads cache rows ``[start, p]`` (``start`` clipped to ``[0, p]``); with
    ``sk``/``sv`` (N, S) the caches are int8 (the batched step's
    ``kv_int8`` mode on one row). The caches are (N, S, Hkv * head_dim),
    Hkv = ``n_kv_heads`` (``n_heads`` when None): narrow for a
    grouped-query model. ``forced``, caches of the same layout (``(ck, cv,
    sk, sv)``, the scales None for float caches), teacher-forces the step:
    each layer's new K and V rows are their row p, not the rows computed
    here (a check holds a kernel's step given the rows the kernel wrote).
    ``kv_rows``, a list, receives each layer's new K and V rows as computed
    here, float32 (Dkv,), as a pair (k, v), before they are cached. Runs on
    any device (it reads ``pos`` and ``tok`` back to the host)."""
    N, S, Dkv = ck.shape
    D = emb.shape[1]
    hd = D // n_heads
    if Dkv != (n_kv_heads or n_heads) * hd:
        raise ValueError(f"caches {Dkv} wide, want n_kv_heads * head_dim = "
                         f"{(n_kv_heads or n_heads) * hd}")
    wdt = emb.dtype
    p = min(int(pos.reshape(-1)[0]), S - 1)
    lo = min(max(start, 0), p)
    t = int(tok.reshape(-1)[0])

    def mm(w, x):  # input rounded to the weight type, f32 accumulation
        return torch.mv(w.float(), x.to(wdt).float())

    if scales is None:
        def lmm(i, layer, x):
            return mm((wq, wk, wv, wo, gate_w, up_w, down_w)[i][layer], x)
    else:
        def lmm(i, layer, x):  # quantized layers: x stays float32
            w = (wq, wk, wv, wo, gate_w, up_w, down_w)[i][layer]
            return _qmm(w, scales[i][layer], x, q4)

    c, s = cos[p].float(), sin[p].float()
    h = emb[t].float()
    for layer in range(N):
        x = rms_norm(h, in_norm[layer])
        q = _rope_pairs(lmm(0, layer, x), c, s)
        k = _rope_pairs(lmm(1, layer, x), c[:Dkv], s[:Dkv])
        v = lmm(2, layer, x)
        if kv_rows is not None:
            kv_rows.append((k, v))
        rows = None if forced is None else tuple(
            f[layer, p] for f in forced if f is not None)
        if sk is not None:
            att = _attend_kv8(ck[layer], cv[layer], sk[layer], sv[layer], p,
                              lo, q, k, v, n_heads,
                              None if rows is None else
                              (rows[0], rows[2], rows[1], rows[3]))
        else:
            ck[layer, p] = k.to(wdt) if rows is None else rows[0]
            cv[layer, p] = v.to(wdt) if rows is None else rows[1]
            keys = _by_query_head(ck[layer, lo:p + 1].float(), n_heads, hd)
            vals = _by_query_head(cv[layer, lo:p + 1].float(), n_heads, hd)
            qh = q.to(wdt).float().view(n_heads, hd)
            scores = torch.einsum("nhd,hd->hn", keys, qh) * (
                1.0 / math.sqrt(hd))
            att = torch.einsum("hn,nhd->hd", torch.softmax(scores, -1), vals)
        z = h + lmm(3, layer, att.reshape(D))
        zn = rms_norm(z, post_norm[layer])
        g, u = lmm(4, layer, zn), lmm(5, layer, zn)
        h = z + lmm(6, layer, g * torch.sigmoid(g) * u)
    hf = rms_norm(h, final_norm)
    if head_s is None:
        logits = mm(head_w, hf) + head_b.float()
    else:  # quantized head: per-call activation quantisation (qvec)
        logits = _qmm(head_w, head_s, hf, q4) + head_b.float()
    return logits


def fused_decode_token_ref(pos, tok, emb, cos, sin, final_norm, wq, wk, wv,
                           wo, gate_w, up_w, down_w, in_norm, post_norm,
                           head_w, head_b, ck, cv, *, n_heads: int,
                           head_s=None, scales=None, q4: bool = False,
                           n_kv_heads: int = None, out=None):
    """The plain-PyTorch version of :func:`fused_decode_token`: same
    arguments, same results, on any device."""
    logits = decode_token_logits_ref(
        pos, tok, emb, cos, sin, final_norm, wq, wk, wv, wo, gate_w, up_w,
        down_w, in_norm, post_norm, head_w, head_b, ck, cv, n_heads=n_heads,
        head_s=head_s, scales=scales, q4=q4, n_kv_heads=n_kv_heads)
    if out is None:
        out = torch.empty(1, dtype=torch.int32, device=emb.device)
    out[0] = torch.argmax(logits)  # first maximal index
    return out


def decode_token_batched_logits_ref(pos, tok, emb, cos, sin, final_norm, wq,
                                    wk, wv, wo, gate_w, up_w, down_w,
                                    in_norm, post_norm, head_w, head_b, ck,
                                    cv, *, n_heads: int, head_s=None,
                                    scales=None, q4: bool = False, sk=None,
                                    sv=None, starts=None,
                                    n_kv_heads: int = None, forced=None,
                                    kv_rows=None):
    """The plain-PyTorch batched step up to the float32 logits (B, V),
    caches updated in place: each row through :func:`decode_token_logits_ref`
    on its own cache ``[:, b]`` (and scales ``sk[:, b]``, ``sv[:, b]``) from
    its own ``starts[b]``, its activations quantized on their own;
    ``forced`` (``(ck, cv, sk, sv)`` of the same layout) teacher-forces
    each row's new K and V rows as there; ``kv_rows``, a list, receives
    each row's list of its layers' new (k, v) rows."""
    lows = [0] * tok.shape[0] if starts is None else starts.tolist()
    if kv_rows is not None:
        kv_rows.extend([] for _ in lows)
    return torch.stack([
        decode_token_logits_ref(
            pos, tok[b:b + 1], emb, cos, sin, final_norm, wq, wk, wv, wo,
            gate_w, up_w, down_w, in_norm, post_norm, head_w, head_b,
            ck[:, b], cv[:, b], n_heads=n_heads, head_s=head_s,
            scales=scales, q4=q4, start=lo,
            sk=None if sk is None else sk[:, b],
            sv=None if sv is None else sv[:, b], n_kv_heads=n_kv_heads,
            forced=None if forced is None else tuple(
                None if f is None else f[:, b] for f in forced),
            kv_rows=None if kv_rows is None else kv_rows[b])
        for b, lo in enumerate(lows)])


def fused_decode_token_batched_ref(pos, tok, emb, cos, sin, final_norm, wq,
                                   wk, wv, wo, gate_w, up_w, down_w, in_norm,
                                   post_norm, head_w, head_b, ck, cv, *,
                                   n_heads: int, head_s=None, scales=None,
                                   q4: bool = False, sk=None, sv=None,
                                   starts=None, n_kv_heads: int = None,
                                   out=None):
    """The plain-PyTorch version of :func:`fused_decode_token_batched`: same
    arguments, same results, on any device."""
    logits = decode_token_batched_logits_ref(
        pos, tok, emb, cos, sin, final_norm, wq, wk, wv, wo, gate_w, up_w,
        down_w, in_norm, post_norm, head_w, head_b, ck, cv, n_heads=n_heads,
        head_s=head_s, scales=scales, q4=q4, sk=sk, sv=sv, starts=starts,
        n_kv_heads=n_kv_heads)
    if out is None:
        out = torch.empty(tok.shape[0], dtype=torch.int32, device=emb.device)
    out[:] = torch.argmax(logits, dim=-1)  # first maximal index per row
    return out


_MATS = ("wq", "wk", "wv", "wo", "gate_w", "up_w", "down_w")


def _check(pos, tok, emb, cos, sin, final_norm, wq, wk, wv, wo, gate_w, up_w,
           down_w, in_norm, post_norm, head_w, head_b, ck, cv, n_heads,
           head_s, out, starts=None, batched=False, scales=None, q4=False,
           sk=None, sv=None, emit_logits=False, n_kv_heads=None):
    """Raise unless the arguments have the layouts of the module doc (the
    batched step's when ``batched``; ``out`` the logits' when
    ``emit_logits``; the narrow cache's when ``n_kv_heads`` < ``n_heads``).
    Returns (B, N, S, D, F, V, Hkv), B = 1 for the B=1 step."""
    if ck.dim() != (4 if batched else 3) or emb.dim() != 2:
        raise ValueError(f"ck: expected {4 if batched else 3} dims, got "
                         f"{tuple(ck.shape)}")
    V, D = emb.shape
    hkv = n_kv_heads or n_heads
    if batched:
        N, B, S = ck.shape[:3]
    else:
        (N, S), B = ck.shape[:2], 1
    F = up_w.shape[1]
    wdt = emb.dtype
    if wdt not in _WDTYPES:
        raise TypeError(f"weights must be float32, bfloat16 or float16, "
                        f"got {wdt}")
    if N < 1 or D % n_heads or (D // n_heads) % 2:
        raise ValueError(f"need >= 1 layer and an even head_dim: N={N}, "
                         f"D={D}, n_heads={n_heads}")
    if not 1 <= hkv <= n_heads or n_heads % hkv:
        raise ValueError(f"n_kv_heads={hkv} must divide n_heads={n_heads}")
    if hkv != n_heads and scales is not None:
        raise ValueError("a narrow GQA cache takes float layers: int8/int4 "
                         "layers run on the expanded (MHA) layout")
    Dkv = hkv * (D // n_heads)
    rows, cache = ((B,), (N, B, S, Dkv)) if batched else ((1,), (N, S, Dkv))
    if q4 and scales is None:
        raise ValueError("q4 packs the quantized layers: it needs scales")
    if scales is not None and head_s is None:
        raise ValueError("quantized layers need the quantized head (head_s)")
    if scales is not None and len(scales) != len(_MATS):
        raise ValueError(f"scales: expected {len(_MATS)} tensors, one per "
                         f"matrix {_MATS}")
    if (sk is None) != (sv is None) or (sk is not None and not batched):
        raise ValueError("the int8 KV cache takes sk and sv, on the batched "
                         "step")
    if sk is not None and (scales is not None or head_s is not None):
        raise ValueError("the int8 KV cache needs float weights: weight "
                         "int8 and KV int8 are mutually exclusive")
    if q4 and (D % 2 or F % 2):
        raise ValueError(f"int4 packs pairs of rows: D={D} and F={F} must "
                         "be even")
    qdt = wdt if scales is None else torch.int8
    cdt = wdt if sk is None else torch.int8
    div = 2 if q4 else 1  # int4 packs the contraction axis
    shapes = {
        "emb": (emb, (V, D), wdt), "cos": (cos, (S, D), wdt),
        "sin": (sin, (S, D), wdt), "final_norm": (final_norm, (D,), wdt),
        "wq": (wq, (N, D, D // div), qdt),
        "wk": (wk, (N, Dkv, D // div), qdt),
        "wv": (wv, (N, Dkv, D // div), qdt), "wo": (wo, (N, D, D // div), qdt),
        "gate_w": (gate_w, (N, F, D // div), qdt),
        "up_w": (up_w, (N, F, D // div), qdt),
        "down_w": (down_w, (N, D, F // div), qdt),
        "in_norm": (in_norm, (N, D), wdt),
        "post_norm": (post_norm, (N, D), wdt),
        "head_w": (head_w, (V, D // div),
                   wdt if head_s is None else torch.int8),
        "head_b": (head_b, (V,), wdt), "ck": (ck, cache, cdt),
        "cv": (cv, cache, cdt), "pos": (pos, (1,), torch.int32),
        "tok": (tok, rows, torch.int32),
    }
    if head_s is not None:
        shapes["head_s"] = (head_s, (V,), torch.float32)
    for name, sc, (_, shape, _) in zip(
            _MATS, scales or (), (shapes[m] for m in _MATS)):
        shapes[f"scales[{name}]"] = (sc, shape[:2], torch.float32)
    if sk is not None:
        shapes["sk"] = (sk, cache[:3], torch.float32)
        shapes["sv"] = (sv, cache[:3], torch.float32)
    if starts is not None:
        shapes["starts"] = (starts, rows, torch.int32)
    if out is not None:
        shapes["out"] = ((out, (B, V), torch.float32) if emit_logits
                         else (out, rows, torch.int32))
    _check_tensors(shapes, emb.device)
    return B, N, S, D, F, V, hkv


def _check_tensors(shapes, device):
    """Raise unless each ``name: (tensor, shape, dtype)`` has that shape and
    type, lies on ``device`` and is contiguous."""
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, weights on "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


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
                       scales=None, q4: bool = False,
                       emit_logits: bool = False, n_kv_heads: int = None,
                       out=None):
    """One decode step (see the module doc for the layouts): the greedy
    token, or with ``emit_logits`` the (1, V) float32 logits; the narrow
    cache with ``n_kv_heads`` < ``n_heads``. CUDA tensors launch
    ``csrc/decode_token.cu``; CPU tensors run
    :func:`fused_decode_token_ref` (:func:`decode_token_logits_ref` for the
    logits)."""
    args = (pos, tok, emb, cos, sin, final_norm, wq, wk, wv, wo, gate_w,
            up_w, down_w, in_norm, post_norm, head_w, head_b, ck, cv)
    _, N, S, D, F, V, hkv = _check(*args, n_heads, head_s, out,
                                   scales=scales, q4=q4,
                                   emit_logits=emit_logits,
                                   n_kv_heads=n_kv_heads)
    if emb.device.type == "cpu":
        kw = dict(n_heads=n_heads, head_s=head_s, scales=scales, q4=q4,
                  n_kv_heads=hkv)
        if not emit_logits:
            return fused_decode_token_ref(*args, out=out, **kw)
        logits = decode_token_logits_ref(*args, **kw)
        if out is None:
            return logits[None]
        out[0] = logits
        return out
    _check_cuda(emb, kernel_takes(D, n_heads, F, q4, hkv),
                f"D={D}, n_heads={n_heads}, n_kv_heads={hkv}, F={F}")
    lib = _build.load()
    hd = D // n_heads
    if out is None:
        out = (torch.empty(1, V, dtype=torch.float32, device=emb.device)
               if emit_logits else
               torch.empty(1, dtype=torch.int32, device=emb.device))
    scratch = torch.empty(
        lib.pdt_decode_token_scratch_floats(D, n_heads, F, V, S),
        dtype=torch.float32, device=emb.device)
    lfmt = 0 if scales is None else (2 if q4 else 1)
    hfmt = lfmt if scales is not None else int(head_s is not None)
    token, logits = (None, out) if emit_logits else (out, None)
    ptrs = [None if t is None else t.data_ptr()
            for t in (pos, tok, token, logits, emb, cos, sin, final_norm, wq,
                      wk, wv, wo, gate_w, up_w, down_w, in_norm, post_norm,
                      head_w, head_s, head_b,
                      *(scales or (None,) * len(_MATS)), ck, cv, scratch)]
    with torch.cuda.device(emb.device):  # launch on the tensors' GPU
        stream = torch.cuda.current_stream().cuda_stream
        if emit_logits:
            fused_decode_token.emit_launches += 1
        else:
            fused_decode_token.launches += 1
        fused_decode_token.narrow_launches += hkv != n_heads
        err = lib.pdt_decode_token(
            _WDTYPES[emb.dtype], lfmt, hfmt, *ptrs, N, D, n_heads, hkv, F, V,
            S, ctypes.c_float(1.0 / math.sqrt(hd)), stream)
    if err != 0:
        raise RuntimeError(f"decode_token launch failed: CUDA error {err}")
    return out


fused_decode_token.launches = 0
fused_decode_token.emit_launches = 0
fused_decode_token.narrow_launches = 0


def fused_decode_token_batched(pos, tok, emb, cos, sin, final_norm, wq, wk,
                               wv, wo, gate_w, up_w, down_w, in_norm,
                               post_norm, head_w, head_b, ck, cv, *,
                               n_heads: int, head_s=None, scales=None,
                               q4: bool = False, sk=None, sv=None,
                               starts=None, emit_logits: bool = False,
                               n_kv_heads: int = None, out=None):
    """One decode step for B rows, any B >= 1 (see the module doc for the
    layouts): float, int8-head, int8 or int4 weights, float caches or the
    int8 KV cache with ``sk``/``sv``, the narrow cache with ``n_kv_heads``
    < ``n_heads``; the greedy tokens, or with ``emit_logits`` the (B, V)
    float32 logits. CUDA tensors launch ``csrc/decode_token_batched.cu``,
    one weight stream a group of 32 rows; CPU tensors run
    :func:`fused_decode_token_batched_ref`
    (:func:`decode_token_batched_logits_ref` for the logits)."""
    args = (pos, tok, emb, cos, sin, final_norm, wq, wk, wv, wo, gate_w,
            up_w, down_w, in_norm, post_norm, head_w, head_b, ck, cv)
    B, N, S, D, F, V, hkv = _check(*args, n_heads, head_s, out, starts,
                                   batched=True, scales=scales, q4=q4, sk=sk,
                                   sv=sv, emit_logits=emit_logits,
                                   n_kv_heads=n_kv_heads)
    if emb.device.type == "cpu":
        kw = dict(n_heads=n_heads, head_s=head_s, scales=scales, q4=q4,
                  sk=sk, sv=sv, starts=starts, n_kv_heads=hkv)
        if not emit_logits:
            return fused_decode_token_batched_ref(*args, out=out, **kw)
        logits = decode_token_batched_logits_ref(*args, **kw)
        if out is None:
            return logits
        out.copy_(logits)
        return out
    _check_cuda(emb, batched_kernel_takes(D, n_heads, F, B, q4, hkv),
                f"B={B}, D={D}, n_heads={n_heads}, n_kv_heads={hkv}, F={F}")
    lib = _build.load()
    hd = D // n_heads
    if out is None:
        out = (torch.empty(B, V, dtype=torch.float32, device=emb.device)
               if emit_logits else
               torch.empty(B, dtype=torch.int32, device=emb.device))
    scratch = torch.empty(
        lib.pdt_decode_token_batched_scratch_floats(B, D, n_heads, F, V, S),
        dtype=torch.float32, device=emb.device)
    lfmt = 0 if scales is None else (2 if q4 else 1)
    hfmt = lfmt if scales is not None else int(head_s is not None)
    token, logits = (None, out) if emit_logits else (out, None)
    ptrs = [None if t is None else t.data_ptr()
            for t in (pos, tok, starts, token, logits, emb, cos, sin,
                      final_norm, wq, wk, wv, wo, gate_w, up_w, down_w,
                      in_norm, post_norm, head_w, head_s, head_b,
                      *(scales or (None,) * len(_MATS)), ck, cv, sk, sv,
                      scratch)]
    with torch.cuda.device(emb.device):  # launch on the tensors' GPU
        stream = torch.cuda.current_stream().cuda_stream
        if emit_logits:
            fused_decode_token_batched.emit_launches += 1
        else:
            fused_decode_token_batched.launches += 1
        fused_decode_token_batched.narrow_launches += hkv != n_heads
        err = lib.pdt_decode_token_batched(
            _WDTYPES[emb.dtype], lfmt, hfmt, int(sk is not None), *ptrs, B,
            N, D, n_heads, hkv, F, V, S, ctypes.c_float(1.0 / math.sqrt(hd)),
            stream)
    if err != 0:
        raise RuntimeError(f"decode_token_batched launch failed: CUDA error "
                           f"{err}")
    return out


fused_decode_token_batched.launches = 0
fused_decode_token_batched.emit_launches = 0
fused_decode_token_batched.narrow_launches = 0


# --------------------------- K9: the greedy head ---------------------------
def lm_head_argmax_ref(h, w, b, out=None):
    """The plain-PyTorch version of :func:`lm_head_argmax`: same arguments,
    same result, on any device."""
    logits = torch.mv(w.float(), h.reshape(-1).float()) + b.float()
    if out is None:
        out = torch.empty(1, 1, dtype=torch.int32, device=w.device)
    out[0, 0] = torch.argmax(logits)  # first maximal index
    return out


def lm_head_argmax(h, w, b, out=None):
    """Greedy next token, ``argmax(w @ h + b)`` over the vocabulary, as an
    int32 (1, 1) tensor (the JAX package's ``lm_head_argmax``). ``h`` (1, D)
    float32, bfloat16 or float16; ``w`` (V, D), the port's (out, in) layout,
    and ``b`` (V,), both of one of those types. Both operands are widened to
    float32, as ``jnp.dot`` promotes them (an ``h`` of another type is not
    rounded to the weights'), and the products summed in float32 with the bias;
    ties go to the lowest index. Any V >= 1: the TPU kernel's vocab tile is its
    own tiling. CUDA tensors launch ``lm_head_kernel`` of ``csrc/head.cuh``:
    K1's tensor-core head stage at one row without the final RMSNorm, whose
    last block to finish reduces the blocks' (max, index) pairs, one launch
    (``csrc/decode_token.cu`` zeroes its arrival count first); an ``h`` of
    another type against bfloat16 weights enters as three bfloat16 pieces whose
    sum is ``h``, and against float16 weights (whose 5-bit exponent holds no
    such split) the float16 weights are widened and multiplied on the CUDA
    cores, as float32 weights are. CPU tensors run
    :func:`lm_head_argmax_ref`."""
    V, D = w.shape if w.dim() == 2 else (-1, -1)
    if w.dtype not in _WDTYPES or h.dtype not in _WDTYPES:
        raise TypeError(f"h and w must be float32, bfloat16 or float16, "
                        f"got {h.dtype} and {w.dtype}")
    if w.dim() != 2 or V < 1 or D < 1:
        raise ValueError(f"w: expected (V, D) with V, D >= 1, got "
                         f"{tuple(w.shape)}")
    shapes = {"h": (h, (1, D), h.dtype), "w": (w, (V, D), w.dtype),
              "b": (b, (V,), w.dtype)}
    if out is not None:
        shapes["out"] = (out, (1, 1), torch.int32)
    _check_tensors(shapes, w.device)
    if w.device.type == "cpu":
        return lm_head_argmax_ref(h, w, b, out=out)
    # the head block's ring and up to three activation rows (head_smem)
    _check_cuda(w, _HEAD_RING_FLOATS + 3 * (D + 36) <= _SMEM_OPTIN_FLOATS,
                f"D={D}")
    lib = _build.load()
    if out is None:
        out = torch.empty(1, 1, dtype=torch.int32, device=w.device)
    scratch = torch.empty(lib.pdt_lm_head_argmax_scratch_floats(V),
                          dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        lm_head_argmax.launches += 1
        err = lib.pdt_lm_head_argmax(
            _WDTYPES[h.dtype], _WDTYPES[w.dtype], h.data_ptr(), w.data_ptr(),
            b.data_ptr(), out.data_ptr(), scratch.data_ptr(), D, V, stream)
    if err != 0:
        raise RuntimeError(f"lm_head_argmax launch failed: CUDA error {err}")
    return out


lm_head_argmax.launches = 0


# ---------------------- K10: the layers-only B=1 step ----------------------
MAX_STEP_HEADS = 64  # kMaxHeads in decode_step.cu


def rope_pair_swap_matrix(dim: int, dtype=torch.float32):
    """R such that (x @ R)[2i] = -x[2i+1], (x @ R)[2i+1] = x[2i]
    (``pydynet_tpu/ops/decode_step.py:63``)."""
    R = torch.zeros(dim, dim, dtype=dtype)
    i = torch.arange(dim // 2)
    R[2 * i + 1, 2 * i] = -1.0
    R[2 * i, 2 * i + 1] = 1.0
    return R


def head_mask_matrix(dim: int, n_heads: int, dtype=torch.float32):
    """M[d, h] = 1 iff feature d belongs to head h (:72)."""
    hd = dim // n_heads
    M = torch.zeros(dim, n_heads, dtype=dtype)
    for h in range(n_heads):
        M[h * hd:(h + 1) * hd, h] = 1.0
    return M


def step_kernel_takes(dim: int, n_heads: int, ffn: int) -> bool:
    """Whether ``csrc/decode_step.cu`` takes these widths. The rule is the
    one its first design had (vectors of 2 D + 512 and F + 64 floats within
    48 KB, up to 64 heads), kept so that no width it took is refused: the
    layer stages it shares with K1 and K2 fit their opt-in at every such
    width (:func:`layer_smem_bytes` at one row, at most about 136 KB at D =
    5888), and the attention stage stages its cache rows, rot rows and
    features in chunks that fit (``attn_plan``), any S."""
    return (1 <= n_heads <= min(dim, MAX_STEP_HEADS)
            and max(2 * dim + 512, ffn + 64) <= _SMEM_FLOATS)


def step_scratch_floats(dim: int, n_heads: int, ffn: int, seq: int) -> int:
    """Floats of device scratch a K10 step takes
    (``pdt_decode_step_scratch_floats``): the residual h, the raw q and k,
    the attention output (D, 2 D, D), the SwiGLU output (F), and the scores
    of ``seq`` rows for the heads padded to 8, for the attention stage's
    scores where they do not fit in its shared memory."""
    return 4 * dim + ffn + seq * (-(-n_heads // 8) * 8)


def fused_decode_step_ref(pos, h0, cos, sin, rot, hmask, final_norm, wq, wk,
                          wv, wo, gate_w, up_w, down_w, in_norm, post_norm,
                          ck, cv, *, alias: bool = True):
    """The plain-PyTorch version of :func:`fused_decode_step`: same
    arguments, same results, on any device (it reads ``pos`` back)."""
    if not alias:
        ck, cv = ck.clone(), cv.clone()
    N, S, D = ck.shape
    H = hmask.shape[1]
    cdt = ck.dtype
    p = min(max(int(pos.reshape(-1)[0]), 0), S - 1)
    scale = 1.0 / math.sqrt(D // H)

    def mm(w, x):  # the input rounded to the cache type, f32 accumulation
        return torch.mv(w.float(), x.to(cdt).float())

    c, s = cos.reshape(D).float(), sin.reshape(D).float()
    rot32, hm = rot.float(), hmask.float()
    hmt = hm.t().to(cdt).float()
    h = h0.reshape(D).float()
    for layer in range(N):
        hn = rms_norm(h, in_norm[layer])
        q, k = mm(wq[layer], hn), mm(wk[layer], hn)
        q = q * c + (q @ rot32) * s
        k = k * c + (k @ rot32) * s
        ck[layer, p] = k.to(cdt)
        cv[layer, p] = mm(wv[layer], hn).to(cdt)
        qm = (q[:, None] * hm).to(cdt).float()                  # (D, H)
        scores = (ck[layer].float() @ qm) * scale                # (S, H)
        scores[p + 1:] = float("-inf")
        prob = torch.softmax(scores, dim=0).to(cdt).float()
        att = ((prob @ hmt) * cv[layer].float()).sum(0)          # (D,)
        z = h + mm(wo[layer], att)
        zn = rms_norm(z, post_norm[layer])
        g, u = mm(gate_w[layer], zn), mm(up_w[layer], zn)
        h = z + mm(down_w[layer], g * torch.sigmoid(g) * u)
    return rms_norm(h, final_norm).reshape(1, D), ck, cv


def fused_decode_step(pos, h0, cos, sin, rot, hmask, final_norm, wq, wk, wv,
                      wo, gate_w, up_w, down_w, in_norm, post_norm, ck, cv,
                      *, alias: bool = True):
    """One layers-only greedy decode step from a hidden state (the JAX
    package's ``fused_decode_step``): per layer RMSNorm, q/k/v, RoPE as
    ``q * cos + (q @ rot) * sin``, the K/V row write at ``min(pos, S - 1)``,
    a plain softmax over all S rows with rows after pos masked (per-head
    scores ``ck @ T(q * hmask) / sqrt(D // H)``, probabilities rounded to T
    and expanded by ``T(hmask).T``), wo + residual, RMSNorm, SwiGLU +
    residual. Returns ``(h_out, ck, cv)``: the final-RMSNormed hidden state
    (1, D) float32 and the caches, updated in place, or in copies when
    ``alias`` is false.

    Layouts (T float32, bfloat16 or float16): ``pos`` (1,) int32; ``h0``,
    ``cos``, ``sin`` (1, D), ``rot`` (D, D) and ``hmask`` (D, H) float32, each
    used as given; ``final_norm`` (D,) T; ``wq``..``wo`` (N, D, D), ``gate_w``,
    ``up_w`` (N, F, D), ``down_w`` (N, D, F) in the (out, in) layout, T;
    ``in_norm``, ``post_norm`` (N, D) T; ``ck``, ``cv`` (N, S, D) T. Each
    matmul input is rounded to T and accumulated in float32, the residual
    float32. CUDA tensors launch ``csrc/decode_step.cu``; CPU tensors run
    :func:`fused_decode_step_ref`."""
    if ck.dim() != 3 or hmask.dim() != 2:
        raise ValueError(f"ck (N, S, D) and hmask (D, H): got "
                         f"{tuple(ck.shape)} and {tuple(hmask.shape)}")
    N, S, D = ck.shape
    H = hmask.shape[1]
    F = up_w.shape[1] if up_w.dim() == 3 else -1
    T = ck.dtype
    if T not in _WDTYPES:
        raise TypeError(f"caches must be float32, bfloat16 or float16, "
                        f"got {T}")
    if N < 1 or not 1 <= H <= D:
        raise ValueError(f"need >= 1 layer and 1 <= H <= D: N={N}, H={H}, "
                         f"D={D}")
    f32 = torch.float32
    _check_tensors({
        "pos": (pos, (1,), torch.int32), "h0": (h0, (1, D), f32),
        "cos": (cos, (1, D), f32), "sin": (sin, (1, D), f32),
        "rot": (rot, (D, D), f32), "hmask": (hmask, (D, H), f32),
        "final_norm": (final_norm, (D,), T), "wq": (wq, (N, D, D), T),
        "wk": (wk, (N, D, D), T), "wv": (wv, (N, D, D), T),
        "wo": (wo, (N, D, D), T), "gate_w": (gate_w, (N, F, D), T),
        "up_w": (up_w, (N, F, D), T), "down_w": (down_w, (N, D, F), T),
        "in_norm": (in_norm, (N, D), T), "post_norm": (post_norm, (N, D), T),
        "ck": (ck, (N, S, D), T), "cv": (cv, (N, S, D), T)}, ck.device)
    if not alias:
        ck, cv = ck.clone(), cv.clone()
    if ck.device.type == "cpu":
        return fused_decode_step_ref(pos, h0, cos, sin, rot, hmask,
                                     final_norm, wq, wk, wv, wo, gate_w,
                                     up_w, down_w, in_norm, post_norm, ck,
                                     cv)
    _check_cuda(ck, step_kernel_takes(D, H, F), f"D={D}, H={H}, F={F}")
    lib = _build.load()
    h_out = torch.empty(1, D, dtype=f32, device=ck.device)
    scratch = torch.empty(lib.pdt_decode_step_scratch_floats(D, H, F, S),
                          dtype=f32, device=ck.device)
    ptrs = [t.data_ptr() for t in (pos, h0, cos, sin, rot, hmask, final_norm,
                                   wq, wk, wv, wo, gate_w, up_w, down_w,
                                   in_norm, post_norm, ck, cv, h_out,
                                   scratch)]
    with torch.cuda.device(ck.device):
        stream = torch.cuda.current_stream().cuda_stream
        fused_decode_step.launches += 1
        err = lib.pdt_decode_step(_WDTYPES[T], *ptrs, N, D, H, F, S,
                                  ctypes.c_float(1.0 / math.sqrt(D // H)),
                                  stream)
    if err != 0:
        raise RuntimeError(f"decode_step launch failed: CUDA error {err}")
    return h_out, ck, cv


fused_decode_step.launches = 0
