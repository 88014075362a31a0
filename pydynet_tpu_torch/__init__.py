"""pydynet_tpu_torch: the PyTorch / CUDA port of ``pydynet_tpu``.

It keeps the JAX package's module tree and names, computes in PyTorch, and
replaces each Pallas TPU kernel with a kernel written by hand for NVIDIA
Hopper (sm_90a). The JAX package stays the reference it is tested against.
This package never imports JAX.

The surface is the JAX package's: the tape's ``Tensor`` and its ops, the
factories, ``Device``, the grad switch, ``jit``, ``Generator``,
``wrap_pure``/``remat_pure``; and ``resolve``, the port's device rule for
its models and trainers (no device means the card).
"""
from .core import (Tensor, add, sub, mul, div, pow, matmul, abs, sum, mean,
                   min, max, argmax, argmin, maximum, minimum, exp, log,
                   sign, reshape, transpose, swapaxes, concat, sigmoid, tanh,
                   sqrt, square, vsplit, hsplit, dsplit, split, unsqueeze,
                   squeeze, wrap_pure, remat_pure, Graph)
from .special import zeros, ones, full, rand, randn, empty, uniform
from .device import Device, device_count, is_available, resolve
from .autograd import enable_grad, no_grad, is_grad_enable, set_grad_enabled
from .jit import jit
from .random import Generator, default_generator, manual_seed
from . import cuda
from . import special
from . import random
from . import core
from . import nn
from . import optim
from . import data
from . import ops
from . import utils

__all__ = [
    "Tensor", "add", "sub", "mul", "div", "pow", "matmul", "abs", "sum",
    "mean", "min", "max", "argmax", "argmin", "maximum", "minimum", "exp",
    "log", "sign", "reshape", "transpose", "swapaxes", "concat", "sigmoid",
    "tanh", "sqrt", "square", "vsplit", "hsplit", "dsplit", "split",
    "unsqueeze", "squeeze", "zeros", "ones", "full", "rand", "randn",
    "empty", "uniform", "Device", "enable_grad", "no_grad",
    "is_grad_enable", "set_grad_enabled", "jit", "manual_seed", "Generator",
    "wrap_pure", "remat_pure", "Graph", "cuda", "default_generator",
    "device_count", "is_available", "resolve",
]

__version__ = "0.1.0"
