"""Causal flash attention: the ports of the Pallas TPU kernels of
``pydynet_tpu/ops/flash_attention.py``, the forward ``_fa_kernel`` (K3,
:82) and the backward's ``_fa_bwd_dq_kernel`` (:192) and
``_fa_bwd_dkv_kernel`` (:259) (K4).

The wrappers are :func:`flash_attention_fwd`, :func:`flash_attention_bwd_dq`
and :func:`flash_attention_bwd_dkv`, each with a ``launches`` counter. For
CUDA tensors they launch the hand-written Hopper kernels of
``csrc/flash_attention.cu``; for CPU tensors they run the plain versions
beside them (``*_ref``), which do the same arithmetic in plain PyTorch. They
never move data between devices and never fall back: a CUDA input the
kernels do not take (another type, head_dim > 256) raises.
:func:`flash_attention_causal` is the differentiable op on top of them, the
counterpart of the JAX package's custom-VJP ``flash_attention_causal``.

Layouts: ``q``, ``k``, ``v``, ``o``, ``do`` and the gradients are the JAX
package's public (B, L, H, d), contiguous, float32 or bfloat16 on a GPU (any
floating type on the CPU). ``lse`` (the row log-sum-exp) and ``dd`` (the
row sums of ``do * o``) are (B, H, L) in the accumulation type: float32, or
float64 for float64 inputs on the CPU. Every product accumulates in that
type; ``o`` and the gradients come back in the inputs' type. Unlike the JAX
package, there is no ``_tiles`` fallback to a dense composite: the kernels
mask the ragged last tile and take any L >= 1.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

MAX_HEAD_DIM = 256  # kMaxHeadDim in csrc/flash_attention.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _acc(dtype):
    """Accumulation type: at least float32, never below the input's (float64
    gradient checks), as ``mha_reference`` in the JAX package."""
    return torch.promote_types(dtype, torch.float32)


def causal_mask(L: int, dtype=torch.float32, device=None):
    """(L, L) additive mask: 0 where the key is at or before the query,
    -inf after it."""
    future = torch.ones(L, L, dtype=torch.bool, device=device).triu(1)
    return torch.zeros(L, L, dtype=dtype, device=device).masked_fill(
        future, float("-inf"))


def mha_reference(q, k, v, mask=None, scale=None):
    """(B, L, H, d) x (B, M, H, d) -> (B, L, H, d) with an additive (L, M)
    mask: the plain composite, scores and softmax in the accumulation
    type, the probabilities cast to q's type before the product with v."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    acc = _acc(q.dtype)
    s = torch.einsum("blhd,bmhd->bhlm", q.to(acc), k.to(acc)) * scale
    if mask is not None:
        s = s + mask.to(acc)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhlm,bmhd->blhd", p, v)


# --------------------------- plain versions ------------------------------
def flash_attention_fwd_ref(q, k, v, scale):
    """Plain K3: ``(o, lse)`` of causal attention with q scaled once, as
    ``_fa_kernel`` does; ``o = (p @ v) / l`` and ``lse = m + log(l)``."""
    acc = _acc(q.dtype)
    L = q.shape[1]
    s = torch.einsum("blhd,bmhd->bhlm", q.to(acc) * scale, k.to(acc))
    s = s + causal_mask(L, acc, q.device)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhlm,bmhd->blhd", p, v.to(acc)) \
        / l.transpose(1, 2)
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _probs_and_ds(q, k, v, do, lse, dd, scale):
    """Recompute p = exp(q k^T * scale - lse) under the causal mask and
    ds = p * (do v^T - dd), (B, H, L, L) in the accumulation type."""
    acc = _acc(q.dtype)
    L = q.shape[1]
    s = torch.einsum("blhd,bmhd->bhlm", q.to(acc), k.to(acc)) * scale
    s = s + causal_mask(L, acc, q.device)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("blhd,bmhd->bhlm", do.to(acc), v.to(acc))
    return p, p * (dp - dd[..., None])


def flash_attention_bwd_dq_ref(q, k, v, do, lse, dd, scale):
    """Plain half of K4 (``_fa_bwd_dq_kernel``): dq = ds k * scale."""
    _, ds = _probs_and_ds(q, k, v, do, lse, dd, scale)
    dq = torch.einsum("bhlm,bmhd->blhd", ds, k.to(ds.dtype)) * scale
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_ref(q, k, v, do, lse, dd, scale):
    """Plain half of K4 (``_fa_bwd_dkv_kernel``): dk = ds^T q * scale and
    dv = p^T do."""
    p, ds = _probs_and_ds(q, k, v, do, lse, dd, scale)
    dk = torch.einsum("bhlm,blhd->bmhd", ds, q.to(ds.dtype)) * scale
    dv = torch.einsum("bhlm,blhd->bmhd", p, do.to(p.dtype))
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_dd(o, do):
    """dd = rowsum(do * o), (B, H, L) in the accumulation type: what the JAX
    package computes outside its kernels (``_fa_backward``, :335)."""
    acc = _acc(o.dtype)
    return (do.to(acc) * o.to(acc)).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_ref(q, k, v, o, lse, do, scale):
    """Plain K4: ``(dq, dk, dv)`` from the forward's ``o`` and ``lse``."""
    dd = attention_dd(o, do)
    dk, dv = flash_attention_bwd_dkv_ref(q, k, v, do, lse, dd, scale)
    return flash_attention_bwd_dq_ref(q, k, v, do, lse, dd, scale), dk, dv


# ------------------------------- wrappers --------------------------------
def _check(heads: dict, rows: dict):
    """Raise unless every tensor of ``heads`` is (B, L, H, d) of one type and
    every one of ``rows`` (B, H, L) in the accumulation type, all contiguous
    on one device. On a CUDA device the kernels also need float32 or
    bfloat16 and d <= 256. Returns (B, L, H, d)."""
    ref = next(iter(heads.values()))
    if ref.dim() != 4:
        raise ValueError(f"expected (B, L, H, d) tensors, got "
                         f"{tuple(ref.shape)}")
    B, L, H, d = ref.shape
    acc = _acc(ref.dtype)
    want = {name: (ref.shape, ref.dtype) for name in heads}
    want.update({name: ((B, H, L), acc) for name in rows})
    for name, t in {**heads, **rows}.items():
        shape, dtype = want[name]
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, "
                             f"{next(iter(heads))} on {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not ref.dtype.is_floating_point or min(B, L, H, d) < 1:
        raise ValueError(f"need floating tensors with B, L, H, d >= 1: "
                         f"{ref.dtype} {tuple(ref.shape)}")
    if ref.device.type == "cpu":
        return B, L, H, d
    if ref.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device "
                         f"{ref.device}")
    if ref.dtype not in _DTYPES or d > MAX_HEAD_DIM or B * H > 65535:
        raise ValueError(f"beyond the kernels' limits: {ref.dtype}, d={d} "
                         f"(float32 or bfloat16, d <= {MAX_HEAD_DIM}), "
                         f"B*H={B * H} (<= 65535)")
    return B, L, H, d


def _launch(fn, name, device, *args):
    """Call the C entry point ``fn`` on the tensors' GPU and current stream;
    raise on the CUDA error it returns."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def flash_attention_fwd(q, k, v, scale=None):
    """Causal attention forward (K3): ``(o, lse)``. CUDA tensors launch the
    forward kernel; CPU tensors run :func:`flash_attention_fwd_ref`."""
    B, L, H, d = _check(dict(q=q, k=k, v=v), {})
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, scale)
    lib = _build.load()
    o = torch.empty_like(q)
    lse = torch.empty(B, H, L, dtype=torch.float32, device=q.device)
    flash_attention_fwd.launches += 1
    _launch(lib.pdt_flash_fwd, "flash_attention_fwd", q.device,
            _DTYPES[q.dtype], *_ptrs(q, k, v, o, lse), B, L, H, d,
            ctypes.c_float(scale))
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd_dq(q, k, v, do, lse, dd, scale=None):
    """dq of causal attention (K4, first kernel). CUDA tensors launch the dq
    kernel; CPU tensors run :func:`flash_attention_bwd_dq_ref`."""
    B, L, H, d = _check(dict(q=q, k=k, v=v, do=do), dict(lse=lse, dd=dd))
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_ref(q, k, v, do, lse, dd, scale)
    lib = _build.load()
    dq = torch.empty_like(q)
    flash_attention_bwd_dq.launches += 1
    _launch(lib.pdt_flash_bwd_dq, "flash_attention_bwd_dq", q.device,
            _DTYPES[q.dtype], *_ptrs(q, k, v, do, lse, dd, dq), B, L, H, d,
            ctypes.c_float(scale))
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, dd, scale=None):
    """``(dk, dv)`` of causal attention (K4, second kernel). CUDA tensors
    launch the dk/dv kernel; CPU tensors run
    :func:`flash_attention_bwd_dkv_ref`."""
    B, L, H, d = _check(dict(q=q, k=k, v=v, do=do), dict(lse=lse, dd=dd))
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_ref(q, k, v, do, lse, dd, scale)
    lib = _build.load()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    flash_attention_bwd_dkv.launches += 1
    _launch(lib.pdt_flash_bwd_dkv, "flash_attention_bwd_dkv", q.device,
            _DTYPES[q.dtype], *_ptrs(q, k, v, do, lse, dd, dk, dv), B, L, H,
            d, ctypes.c_float(scale))
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, scale=None):
    """Causal attention backward (K4): ``(dq, dk, dv)``, with dd computed by
    plain torch ops as the JAX package does outside its kernels."""
    dd = attention_dd(o, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, dd, scale)
    return flash_attention_bwd_dq(q, k, v, do, lse, dd, scale), dk, dv


class _FlashCausal(torch.autograd.Function):
    """Forward through K3, saving ``o`` (q's type) and ``lse`` (float32);
    backward through both kernels of K4."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.scale)
        return dq, dk, dv, None


def flash_attention_causal(q, k, v, scale=None):
    """Causal flash attention in the (B, L, H, d) layout, differentiable in
    q, k and v: the counterpart of the JAX package's custom-VJP op, without
    its block-size and interpret arguments."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashCausal.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                              scale)
