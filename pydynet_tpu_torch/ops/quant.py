"""Symmetric per-channel int8 and int4 weight quantization (counterpart of
``pydynet_tpu/ops/quant.py``).

Same schemes bit for bit: absmax over the contraction axis floored at 1e-30,
divided by 127 (int8) or 7 (int4), round half to even, clip. int4 packs two
values a byte along the contraction axis: rows k and k + K/2 share a byte,
row k in the low nibble, so the product splits as
``x[:, :K/2] @ lo + x[:, K/2:] @ hi`` (``ops/gemv_quant.py``).
"""
from __future__ import annotations

import torch

INT8_MAX = 127.0
INT4_MAX = 7.0


def _quantize(w: torch.Tensor, axis: int, qmax: float):
    w32 = w.float()
    amax = w32.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-30) / qmax
    q = torch.clamp(torch.round(w32 / scale), -qmax, qmax)
    return q.to(torch.int8), scale


def quantize_int8(w: torch.Tensor, axis: int):
    """``(q, scale)``: ``q`` int8 shaped like ``w``; ``scale`` float32 with
    ``axis`` (the contraction axis) reduced to 1, so each output channel has
    its own scale and ``q * scale ~= w``."""
    return _quantize(w, axis, INT8_MAX)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` (for references and tests)."""
    return (q.float() * scale).to(dtype)


def quantize_int4(w: torch.Tensor, axis: int):
    """``(packed, scale)``: values in [-7, 7] packed two a byte along
    ``axis`` (even length K), so ``packed`` has ``axis`` halved: byte k
    holds row k in its low nibble and row k + K/2 in its high nibble.
    ``scale`` is float32 with ``axis`` reduced to 1."""
    K = w.shape[axis]
    if K % 2:
        raise ValueError(f"int4 packs pairs of rows: axis {axis} has odd "
                         f"length {K}")
    q, scale = _quantize(w, axis, INT4_MAX)
    lo, hi = q.split(K // 2, dim=axis)
    packed = torch.bitwise_or(torch.bitwise_and(lo, 0x0F),
                              torch.bitwise_left_shift(hi, 4))
    return packed.to(torch.int8), scale


def unpack_int4(packed: torch.Tensor):
    """``(lo, hi)`` int8 halves of a :func:`quantize_int4` pack, unpacked by
    arithmetic shifts in int32: ``lo = (p << 28) >> 28``, ``hi = p >> 4``."""
    p = packed.to(torch.int32)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(p, 28), 28)
    hi = torch.bitwise_right_shift(p, 4)
    return lo.to(torch.int8), hi.to(torch.int8)


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor, axis: int,
                    dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_int4` (for references and tests)."""
    lo, hi = unpack_int4(packed)
    return (torch.cat([lo, hi], dim=axis).float() * scale).to(dtype)
