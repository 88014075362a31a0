"""Activation modules (counterparts of
``pydynet_tpu/nn/modules/activation.py``), over ``nn/functional.py``."""
from __future__ import annotations

from torch import nn

from .. import functional as F


class Sigmoid(nn.Module):

    def forward(self, x):
        return F.sigmoid(x)


class Tanh(nn.Module):

    def forward(self, x):
        return F.tanh(x)


class ReLU(nn.Module):

    def forward(self, x):
        return F.relu(x)


class LeakyReLU(nn.Module):

    def __init__(self, alpha: float = 0.1) -> None:
        super().__init__()
        self.alpha = float(alpha)

    def forward(self, x):
        return F.leaky_relu(x, self.alpha)

    def extra_repr(self) -> str:
        return f"alpha={self.alpha}"


class SiLU(nn.Module):

    def forward(self, x):
        return F.silu(x)


class GELU(nn.Module):

    def forward(self, x):
        return F.gelu(x)


class Softmax(nn.Module):

    def __init__(self, axis=None) -> None:
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, self.axis)

    def extra_repr(self) -> str:
        return f"axis={self.axis}"
