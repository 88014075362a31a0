"""The tape: ``Tensor``, ``Graph`` and the ops (counterpart of
``pydynet_tpu/core``)."""
from .tensor import (Graph, Tensor, add, sub, mul, div, pow, matmul, abs,
                     sum, mean, min, max, argmax, argmin, maximum, minimum,
                     exp, log, sign, reshape, transpose, swapaxes, concat,
                     sigmoid, tanh, wrap_pure, remat_pure)
from .function import (sqrt, square, vsplit, hsplit, dsplit, split,
                       unsqueeze, squeeze, normalize_axis_tuple)
