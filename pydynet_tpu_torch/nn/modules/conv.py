"""Conv1d and Conv2d (counterparts of ``pydynet_tpu/nn/modules/conv.py``).

The weight is (O, C, K[, K]) and the bias (1, O, 1[, 1]), added after the
convolution: the JAX package's layout, not torch's (O,) bias, kept so that
state dicts cross between the packages as they are.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .. import functional as F
from .. import init


class _ConvNd(nn.Module):
    _ndim_sp = None
    _conv = None

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias=True, device=None, dtype=None) -> None:
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.padding = padding
        self.stride = stride
        wshape = (out_channels, in_channels) + (kernel_size,) * self._ndim_sp
        self.weight = nn.Parameter(torch.empty(wshape, **kw))
        bshape = (1, out_channels) + (1,) * self._ndim_sp
        self.bias = nn.Parameter(torch.empty(bshape, **kw)) if bias else None
        self.reset_parameters()

    def reset_parameters(self):
        init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        if self.bias is not None:
            fan_in, _ = init._calculate_fan(self.weight)
            if fan_in != 0:
                bound = 1 / math.sqrt(fan_in)
                init.uniform_(self.bias, -bound, bound)

    def forward(self, x):
        out = type(self)._conv(x, self.weight, self.padding, self.stride)
        return out + self.bias if self.bias is not None else out

    def extra_repr(self) -> str:
        return (f"in_channels={self.in_channels}, out_channels="
                f"{self.out_channels}, kernel_size={self.kernel_size}, "
                f"padding={self.padding}, stride={self.stride}, "
                f"bias={self.bias is not None}")


class Conv1d(_ConvNd):
    _ndim_sp = 1
    _conv = staticmethod(F.conv1d)


class Conv2d(_ConvNd):
    _ndim_sp = 2
    _conv = staticmethod(F.conv2d)
