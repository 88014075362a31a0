"""Pooling modules (counterparts of ``pydynet_tpu/nn/modules/pool.py``):
zero padding before the window reduction, as ``nn/functional.py`` pools."""
from __future__ import annotations

from torch import nn

from .. import functional as F


class _Pool(nn.Module):
    _fn = None

    def __init__(self, kernel_size: int, stride: int,
                 padding: int = 0) -> None:
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        return type(self)._fn(x, self.kernel_size, self.stride, self.padding)

    def extra_repr(self) -> str:
        return (f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class MaxPool1d(_Pool):
    _fn = staticmethod(F.max_pool1d)


class AvgPool1d(_Pool):
    _fn = staticmethod(F.avg_pool1d)


class MaxPool2d(_Pool):
    _fn = staticmethod(F.max_pool2d)


class AvgPool2d(_Pool):
    _fn = staticmethod(F.avg_pool2d)
