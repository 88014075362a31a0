"""Loss modules (port of ``pydynet_tpu/nn/modules/loss.py``)."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F
from .module import Module


class Loss(Module):

    def __init__(self, reduction: str = "mean") -> None:
        super().__init__()
        if reduction not in ("mean", "sum"):
            raise ValueError(f"reduction must be mean or sum, got "
                             f"{reduction!r}")
        self.reduction = reduction

    def forward(self, y_pred: torch.Tensor,
                y_true: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class MSELoss(Loss):
    """:func:`nn.functional.mse_loss`."""

    def forward(self, y_pred: torch.Tensor,
                y_true: torch.Tensor) -> torch.Tensor:
        return F.mse_loss(y_pred, y_true, reduction=self.reduction)


class NLLLoss(Loss):
    """:func:`nn.functional.nll_loss`: ``-y_pred * y_true`` over every
    element."""

    def forward(self, y_pred: torch.Tensor,
                y_true: torch.Tensor) -> torch.Tensor:
        return F.nll_loss(y_pred, y_true, reduction=self.reduction)


class CrossEntropyLoss(Loss):
    """:func:`nn.functional.cross_entropy_loss`, global-max shift and all."""

    def forward(self, y_pred: torch.Tensor,
                y_true: torch.Tensor) -> torch.Tensor:
        return F.cross_entropy_loss(y_pred, y_true, reduction=self.reduction)
