"""RMSNorm (counterpart of ``pydynet_tpu/nn/modules/norm.py:RMSNorm``)."""
from __future__ import annotations

import torch
from torch import nn


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``x / sqrt(mean(x^2) + eps) * weight`` over the last axis, computed
    in float32 and returned in float32 (``decode_step.py:_rms``)."""
    x32 = x.float()
    return x32 / torch.sqrt(x32.pow(2).mean(-1, keepdim=True) + eps) \
        * weight.float()


class RMSNorm(nn.Module):
    """Weight-only RMS normalization over the last axis. The arithmetic is
    float32 whatever the input type; the result has the input's type."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None,
                 dtype=None) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device,
                                              dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps).to(x.dtype)
