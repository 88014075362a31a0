"""Weight initializers, with the formulas of ``pydynet_tpu/nn/init.py``.

Draws are made in float32 on the CPU from the CPU's ``torch.Generator`` of
``pydynet_tpu_torch.random`` (``torch_generator``, seeded by
``manual_seed``) and copied into the tensor, whatever its device and type,
so one seed gives the same weights on every device. They are not the JAX package's NumPy draws: weights cross
between the packages through ``utils/checkpoint.py``.
"""
from __future__ import annotations

import math

import torch

from ..random import torch_generator


def calculate_gain(nonlinearity: str, param: float = None) -> float:
    return {
        "linear": 1,
        "conv1d": 1,
        "conv2d": 1,
        "sigmoid": 1,
        "tanh": 5 / 3,
        "relu": math.sqrt(2.),
        "leaky_relu":
        math.sqrt(2. / (1 + (param if param is not None else 0.01)**2)),
    }[nonlinearity]


def _calculate_fan(tensor: torch.Tensor):
    """(fan_in, fan_out) of a weight of two or more axes: its first two
    sizes, each times the product of the rest."""
    if tensor.dim() < 2:
        raise ValueError(f"fan of a tensor of {tensor.dim()} axes: need 2 "
                         "or more")
    fan_in, fan_out = tensor.shape[:2]
    receptive_field_size = math.prod(tensor.shape[2:])
    return fan_in * receptive_field_size, fan_out * receptive_field_size


@torch.no_grad()
def _assign(tensor: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    tensor.copy_(value)
    return tensor


def uniform_(tensor, a: float = 0., b: float = 1.):
    return _assign(tensor, torch.empty(tensor.shape).uniform_(
        a, b, generator=torch_generator()))


def normal_(tensor, mean: float = 0., std: float = 1.):
    return _assign(tensor, torch.empty(tensor.shape).normal_(
        mean, std, generator=torch_generator()))


def constant_(tensor, val: float):
    return _assign(tensor, torch.full(tensor.shape, float(val)))


def ones_(tensor):
    return constant_(tensor, 1.)


def zeros_(tensor):
    return constant_(tensor, 0.)


def xavier_uniform_(tensor, gain: float = 1.):
    fan_in, fan_out = _calculate_fan(tensor)
    bound = gain * math.sqrt(6. / (fan_in + fan_out))
    return uniform_(tensor, -bound, bound)


def xavier_normal_(tensor, gain: float = 1.):
    fan_in, fan_out = _calculate_fan(tensor)
    std = gain * math.sqrt(2 / (fan_in + fan_out))
    return normal_(tensor, std=std)


def _fan(tensor, mode):
    fan_in, fan_out = _calculate_fan(tensor)
    return {"fan_in": fan_in, "fan_out": fan_out}[mode]


def kaiming_uniform_(tensor, a: float = 0., mode: str = "fan_in",
                     nonlinearity: str = "relu"):
    gain = calculate_gain(nonlinearity, a)
    bound = gain * math.sqrt(3. / _fan(tensor, mode))
    return uniform_(tensor, -bound, bound)


def kaiming_normal_(tensor, a: float = 0., mode: str = "fan_in",
                    nonlinearity: str = "relu"):
    gain = calculate_gain(nonlinearity, a)
    std = gain / math.sqrt(_fan(tensor, mode))
    return normal_(tensor, std=std)
