"""Normalization layers (counterparts of ``pydynet_tpu/nn/modules/norm.py``):
BatchNorm1d, BatchNorm2d, the JAX package's LayerNorm, and RMSNorm.

The batch norms and LayerNorm keep the JAX package's names and shapes:
parameters ``scale`` and ``shift``, buffers ``running_mean`` and
``running_var``, of shape (C,) for BatchNorm1d, (1, C, 1, 1) for
BatchNorm2d and ``normalized_shape`` for LayerNorm; eps 1e-6 and momentum
0.1 by default. In train mode the batch's mean and biased variance
normalize, and the running statistics move towards them by ``momentum``,
without a gradient. In eval mode the running statistics normalize.

A 2-D BatchNorm1d input on a CUDA tensor in float32 or bfloat16 goes through
the fused kernel (``ops/batchnorm.py``, K8), which is where the JAX package
runs its Pallas kernel (on its accelerator; the port reads ``x.is_cuda``);
everything else takes the composite. LayerNorm normalizes over the
*leading* axes and keeps running statistics: a quirk of the JAX package's
reference, kept.

Unlike the JAX package's ``Module``, ``train(mode)`` does not flip the
global grad switch, and the running statistics are buffers, so
``parameters()`` yields the trainable tensors only, as it does there.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops import batchnorm as _bn
from .module import Module


class _RunningNorm(Module):
    """Parameters, buffers and eval-mode forward shared by the batch norms
    and LayerNorm."""

    def __init__(self, stat_shape, eps, momentum, device, dtype) -> None:
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.eps = eps
        self.momentum = momentum
        self.register_buffer("running_mean", torch.zeros(stat_shape, **kw))
        self.register_buffer("running_var", torch.ones(stat_shape, **kw))
        self.scale = nn.Parameter(torch.ones(stat_shape, **kw))
        self.shift = nn.Parameter(torch.zeros(stat_shape, **kw))

    def reset_parameters(self):
        with torch.no_grad():
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            self.shift.zero_()
            self.scale.fill_(1.0)

    @torch.no_grad()
    def _update(self, mean, var):
        """running = (1 - momentum) * running + momentum * batch statistic."""
        m = self.momentum
        for buf, stat in ((self.running_mean, mean), (self.running_var, var)):
            buf.mul_(1 - m).add_(m * stat.detach().reshape(buf.shape)
                                 .to(buf.dtype))

    def _normalize(self, x, mean, var):
        """Train mode's composite: update the running statistics, return
        ``(x - mean) / sqrt(var + eps) * scale + shift``."""
        self._update(mean, var)
        return (x - mean) / torch.sqrt(var + self.eps) * self.scale \
            + self.shift

    def _eval(self, x):
        return (x - self.running_mean) * self.scale / torch.sqrt(
            self.running_var + self.eps) + self.shift


class _BatchNorm(_RunningNorm):

    def __init__(self, num_features, stat_shape, reduce_axes, keepdims, eps,
                 momentum, device, dtype) -> None:
        super().__init__(stat_shape, eps, momentum, device, dtype)
        self.num_features = num_features
        self._axes = reduce_axes
        self._keepdims = keepdims

    def forward(self, x):
        if not self.training:
            return self._eval(x)
        if self._axes == (0,) and x.dim() == 2 and x.is_cuda \
                and x.dtype in _bn.KERNEL_DTYPES \
                and self.scale.dtype in _bn.KERNEL_DTYPES:
            out, mean, var = _bn.batch_norm_train(
                x.contiguous(), self.scale.reshape(1, -1),
                self.shift.reshape(1, -1), self.eps)
            self._update(mean, var)
            return out
        mean = x.mean(self._axes, keepdim=self._keepdims)
        var = ((x - mean) ** 2).mean(self._axes, keepdim=self._keepdims)
        return self._normalize(x, mean, var)

    def extra_repr(self) -> str:
        return f"num_features={self.num_features}, momentum={self.momentum}"


class BatchNorm1d(_BatchNorm):
    """Statistics over the batch axis of (N, C) inputs."""

    def __init__(self, num_features: int, eps: float = 1e-6,
                 momentum: float = 0.1, device=None, dtype=None) -> None:
        super().__init__(num_features, (num_features,), (0,), False, eps,
                         momentum, device, dtype)


class BatchNorm2d(_BatchNorm):
    """Statistics over (N, H, W) of (N, C, H, W) inputs."""

    def __init__(self, num_features: int, eps: float = 1e-6,
                 momentum: float = 0.1, device=None, dtype=None) -> None:
        super().__init__(num_features, (1, num_features, 1, 1), (0, 2, 3),
                         True, eps, momentum, device, dtype)


class LayerNorm(_RunningNorm):
    """The JAX package's LayerNorm: statistics over the *leading* axes (all
    but the trailing ``normalized_shape``), with running statistics."""

    def __init__(self, normalized_shape, eps: float = 1e-6,
                 momentum: float = 0.1, device=None, dtype=None) -> None:
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        super().__init__(tuple(normalized_shape), eps, momentum, device,
                         dtype)
        self.normalized_shape = tuple(normalized_shape)

    def forward(self, x):
        if not self.training:
            return self._eval(x)
        axes = tuple(range(x.dim() - len(self.normalized_shape)))
        mean = x.mean(axes)
        var = ((x - mean) ** 2).mean(axes)
        return self._normalize(x, mean, var)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``x / sqrt(mean(x^2) + eps) * weight``, the mean over the trailing
    ``weight.dim()`` axes (the last one for the Llama's (D,) weights),
    computed in float32 and returned in float32 (``decode_step.py:_rms``)."""
    x32 = x.float()
    axes = tuple(range(-weight.dim(), 0))
    return x32 / torch.sqrt(x32.pow(2).mean(axes, keepdim=True) + eps) \
        * weight.float()


class RMSNorm(Module):
    """Weight-only RMS normalization over the trailing ``normalized_shape``
    axes (an int is one axis). The arithmetic is float32 whatever the input
    type; the result has the input's type."""

    def __init__(self, normalized_shape, eps: float = 1e-6, device=None,
                 dtype=None) -> None:
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(self.normalized_shape,
                                               device=device, dtype=dtype))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        """The gain back to ones."""
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps).to(x.dtype)
