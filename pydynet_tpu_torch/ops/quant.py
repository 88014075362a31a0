"""Symmetric per-channel int8 weight quantization (counterpart of
``pydynet_tpu/ops/quant.py:quantize_int8`` / ``dequantize_int8``).

Same scheme bit for bit: absmax over the contraction axis floored at 1e-30,
divided by 127, round half to even, clip to +-127.
"""
from __future__ import annotations

import torch

INT8_MAX = 127.0


def quantize_int8(w: torch.Tensor, axis: int):
    """``(q, scale)``: ``q`` int8 shaped like ``w``; ``scale`` float32 with
    ``axis`` (the contraction axis) reduced to 1, so each output channel has
    its own scale and ``q * scale ~= w``."""
    w32 = w.float()
    amax = w32.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-30) / INT8_MAX
    q = torch.clamp(torch.round(w32 / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` (for references and tests)."""
    return (q.float() * scale).to(dtype)
