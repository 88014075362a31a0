"""Inverted dropout (counterpart of ``pydynet_tpu/nn/modules/dropout.py``):
:func:`nn.functional.dropout` in train mode, the identity in eval mode."""
from __future__ import annotations

from torch import nn

from .. import functional as F


class Dropout(nn.Module):

    def __init__(self, p: float = 0.5) -> None:
        super().__init__()
        if not 0 <= p < 1:
            raise ValueError(f"dropout probability must be in [0, 1), got "
                             f"{p}")
        self.p = p

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training)

    def extra_repr(self) -> str:
        return f"p={self.p}"
