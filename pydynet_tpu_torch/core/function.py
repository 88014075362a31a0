"""Derived tensor functions: sqrt/square, split family, squeeze/unsqueeze
(counterpart of ``pydynet_tpu/core/function.py``).

All are thin differentiable compositions over the core ops (splits are
slice-based, so they reuse the scatter-add VJP of ``_get_slice``).
"""
from __future__ import annotations

import builtins
import operator

import numpy as np

from .tensor import Tensor, _coerce, _get_slice, reshape, swapaxes


def sqrt(x) -> Tensor:
    from . import tensor as _t
    return _t.pow(x, 0.5)


def square(x) -> Tensor:
    return x * x


def normalize_axis_tuple(axis, ndim, argname=None, allow_duplicate=False):
    """Same contract as numpy's private helper: AxisError out of range."""
    if type(axis) not in (tuple, list):
        try:
            axis = [operator.index(axis)]
        except TypeError:
            pass
    # single +ndim shift like numpy, NOT modulo: `a % ndim` silently wraps
    # out-of-range negatives (e.g. -10 on a 2-d array) instead of raising
    axis = tuple(a + ndim if a < 0 else a for a in axis)
    for a in axis:
        if not 0 <= a < ndim:
            raise np.exceptions.AxisError(a, ndim, argname)
    if not allow_duplicate and len(set(axis)) != len(axis):
        if argname:
            raise ValueError(f"repeated axis in `{argname}` argument")
        raise ValueError("repeated axis")
    return axis


def _split_along(x, indices_or_sections, axis: int):
    x = _coerce(x)
    length = x.shape[axis]
    if isinstance(indices_or_sections, int):
        if length % indices_or_sections != 0:
            raise ValueError(
                "array split does not result in an equal division")
        step = length // indices_or_sections
        bounds = [(i * step, (i + 1) * step)
                  for i in builtins.range(indices_or_sections)]
    else:
        points = [0] + list(indices_or_sections) + [length]
        bounds = list(zip(points[:-1], points[1:]))
    pieces = []
    for lo, hi in bounds:
        key = tuple(slice(None) for _ in builtins.range(axis)) + (
            slice(lo, hi),)
        pieces.append(_get_slice(x, key))
    return pieces


def vsplit(x, indices_or_sections) -> list:
    if _coerce(x).ndim < 2:
        raise ValueError("vsplit only works on arrays of 2 or more dimensions")
    return _split_along(x, indices_or_sections, 0)


def hsplit(x, indices_or_sections) -> list:
    x = _coerce(x)
    if x.ndim < 1:
        raise ValueError("hsplit only works on arrays of 1 or more dimensions")
    return _split_along(x, indices_or_sections, 1 if x.ndim > 1 else 0)


def dsplit(x, indices_or_sections) -> list:
    if _coerce(x).ndim < 3:
        raise ValueError("dsplit only works on arrays of 3 or more dimensions")
    return _split_along(x, indices_or_sections, 2)


def split(x, indices_or_sections, axis: int = 0) -> list:
    x = _coerce(x)
    (axis,) = normalize_axis_tuple(axis, x.ndim, "axis")
    if axis == 0:
        return _split_along(x, indices_or_sections, 0)
    # general axis: swap to front, split, swap back
    swapped = swapaxes(x, 0, axis)
    return [
        swapaxes(piece, 0, axis)
        for piece in _split_along(swapped, indices_or_sections, 0)
    ]


def unsqueeze(x, axis) -> Tensor:
    x = _coerce(x)
    if isinstance(axis, int):
        axis = (axis,)
    out_ndim = x.ndim + len(axis)
    axis = normalize_axis_tuple(axis, out_ndim)
    shape_it = iter(x.shape)
    new_shape = [
        1 if ax in axis else next(shape_it) for ax in builtins.range(out_ndim)
    ]
    return reshape(x, tuple(new_shape))


def squeeze(x, axis=None) -> Tensor:
    x = _coerce(x)
    if axis is None:
        new_shape = tuple(s for s in x.shape if s != 1)
    else:
        if isinstance(axis, int):
            axis = (axis,)
        axis = normalize_axis_tuple(axis, x.ndim)
        for a in axis:
            if x.shape[a] != 1:
                raise ValueError(
                    "cannot select an axis to squeeze out which has size "
                    "not equal to one")
        new_shape = tuple(s for i, s in enumerate(x.shape) if i not in axis)
    return reshape(x, new_shape)
