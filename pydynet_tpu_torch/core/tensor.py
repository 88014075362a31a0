"""Tensor core: a PyTorch-style eager tensor over ``torch.Tensor`` with a
global gradient tape (counterpart of ``pydynet_tpu/core/tensor.py``).

* ``Tensor`` wraps a ``torch.Tensor`` that PyTorch's own autograd never
  sees; every operator is a plain torch call, and a process-global tape
  (:class:`Graph`) records every requires-grad tensor in creation order.
  ``backward()`` sweeps it in reverse, applying each node's VJP, summing
  broadcast gradients back to shape and casting them to the input's type,
  accumulating into ``.grad`` and freeing non-leaf nodes unless
  ``retain_graph``.
* Types follow the JAX package under x64, not PyTorch's rules: host
  literals go through ``np.array`` (``Tensor(1.0)`` is float64,
  ``Tensor([1, 2])`` int64); a Python scalar or array operand takes its
  peer's type and device; two tensors promote on JAX's lattice
  (:func:`result_type`), integer inputs of ``exp``/``log``/``tanh``/``mean``/
  division become float32 (int64 and uint64: float64), and sums of integers
  are int64 (unsigned: uint64). Unsigned 16- to 64-bit tensors compute
  through int64 (PyTorch has no arithmetic for them) and keep their type.
* JAX arrays are immutable, torch tensors are not. The port keeps the JAX
  package's semantics by never letting two tensors share memory behind the
  user's back: an op whose torch result is a view of its input (reshape,
  transpose, basic indexing, ``astype`` to the same type) copies it. Writes
  (``x.data = v``, ``x.data -= lr * x.grad``, ``x.data[i] = v``,
  ``x[i] = v``, ``x += v``) go into the tensor's own memory where the
  result has its shape, type and device, which a CUDA graph needs (``jit``);
  else, or where the memory is shared with another ``Tensor`` (``_wrap`` of
  the same array), they rebind it as the JAX package does. A write between
  an op and its ``backward`` changes what that backward reads (the JAX
  package's backward keeps the old array).
* In-place ops are forbidden on grad-requiring tensors while grad mode is
  on; comparisons return bool tensors off the tape; a binary op on two
  devices raises ``RuntimeError`` naming both.
* ``wrap_pure`` records a pure torch function as one node whose VJP is
  ``torch.func.vjp``'s; ``remat_pure`` recomputes the forward in the
  backward instead of keeping its residuals.

float32 products (``matmul``, and those inside ``wrap_pure`` functions and
their VJPs) run without TF32 whatever the global setting, as the JAX
package computes them in full float32.
"""
from __future__ import annotations

import builtins
import contextlib
from typing import Callable, Optional, Sequence

import numpy as np
import torch

# no_grad/enable_grad re-exported, as the JAX module does
from ..autograd import enable_grad, is_grad_enable, no_grad  # noqa: F401
from ..device import Device

__all__ = [
    "Graph", "Tensor", "add", "sub", "mul", "div", "pow", "matmul", "abs",
    "sum", "mean", "min", "max", "argmax", "argmin", "maximum", "minimum",
    "exp", "log", "sign", "reshape", "transpose", "swapaxes", "concat",
    "sigmoid", "tanh", "wrap_pure", "remat_pure", "result_type",
]

# ---------------------------------------------------------------------- #
#                                 types                                  #
# ---------------------------------------------------------------------- #
_NP_TORCH = {
    np.dtype(np.bool_): torch.bool, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16, np.dtype(np.uint32): torch.uint32,
    np.dtype(np.uint64): torch.uint64, np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64, np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
}
_TORCH_NP = {t: n for n, t in _NP_TORCH.items()}
# types PyTorch stores but cannot compute with: they compute through int64
_WIDE_UNSIGNED = (torch.uint16, torch.uint32, torch.uint64)

# JAX's type promotion lattice (jax/_src/dtypes.py), with its weak Python
# int ("i*") and float ("f*"); a join that lands on a weak type takes the
# x64 default, int64 or float64
_CODE = {torch.bool: "b", torch.uint8: "u8", torch.uint16: "u16",
         torch.uint32: "u32", torch.uint64: "u64", torch.int8: "i8",
         torch.int16: "i16", torch.int32: "i32", torch.int64: "i64",
         torch.float16: "f16", torch.bfloat16: "bf16",
         torch.float32: "f32", torch.float64: "f64"}
_TYPE = {c: t for t, c in _CODE.items()}
_TYPE.update({"i*": torch.int64, "f*": torch.float64})
_EDGES = {"b": ("i*",), "i*": ("u8", "i8"), "u8": ("i16", "u16"),
          "u16": ("i32", "u32"), "u32": ("i64", "u64"), "u64": ("f*",),
          "i8": ("i16",), "i16": ("i32",), "i32": ("i64",), "i64": ("f*",),
          "f*": ("bf16", "f16"), "bf16": ("f32",), "f16": ("f32",),
          "f32": ("f64",), "f64": ()}


def _upper(code, memo={}):
    if code not in memo:
        up = {code}
        for nxt in _EDGES[code]:
            up |= _upper(nxt)
        memo[code] = frozenset(up)
    return memo[code]


def _join(a: str, b: str) -> str:
    common = _upper(a) & _upper(b)
    return next(c for c in common if common <= _upper(c))


def _code(x) -> str:
    if isinstance(x, torch.dtype):
        return _CODE[x]
    if isinstance(x, torch.Tensor):
        return _CODE[x.dtype]
    if isinstance(x, (bool, np.bool_)):
        return "b"
    if isinstance(x, int):
        return "i*"
    if isinstance(x, float):
        return "f*"
    return _CODE[torch_dtype(np.asarray(x).dtype)]


def result_type(*operands) -> torch.dtype:
    """The JAX package's result type (x64) of tensors, ``torch.dtype``s and
    Python scalars (weakly typed, as in JAX)."""
    code = _code(operands[0])
    for x in operands[1:]:
        code = _join(code, _code(x))
    return _TYPE[code]


def _inexact(dtype: torch.dtype) -> torch.dtype:
    """The float type JAX computes ``exp``, ``mean`` or ``/`` of
    ``dtype`` in: float32 for bool and integers up to 32 bits, float64 for
    64-bit ones."""
    if dtype.is_floating_point:
        return dtype
    return torch.float64 if dtype in (torch.int64, torch.uint64) \
        else torch.float32


def torch_dtype(dtype) -> Optional[torch.dtype]:
    """``None``, a ``torch.dtype``, or anything ``np.dtype`` takes ->
    ``torch.dtype``."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return _NP_TORCH[np.dtype(dtype)]


def _np_dtype(dtype: torch.dtype):
    """``np.dtype`` of a torch type; bfloat16 (NumPy has none) stays a
    ``torch.dtype``."""
    return _TORCH_NP.get(dtype, dtype)


def _compute(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) if t.dtype in _WIDE_UNSIGNED else t


def _cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t if t.dtype == dtype else t.to(dtype)


@contextlib.contextmanager
def _full_f32():
    """float32 products without TF32, the global setting restored after."""
    prec = torch.get_float32_matmul_precision()
    if prec != "highest":
        torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if prec != "highest":
            torch.set_float32_matmul_precision(prec)


def _shares(out: torch.Tensor, *srcs: torch.Tensor) -> bool:
    ptr = out.untyped_storage().data_ptr()
    return builtins.any(s.untyped_storage().data_ptr() == ptr for s in srcs
                        if isinstance(s, torch.Tensor))


def _own(out: torch.Tensor, *srcs: torch.Tensor) -> torch.Tensor:
    """``out``, copied if it shares memory with one of ``srcs``."""
    return out.clone() if _shares(out, *srcs) else out


def _host(x, dtype: Optional[torch.dtype], device: torch.device):
    """A host value (literal, ndarray, scalar) or a raw torch tensor as a
    fresh torch tensor on ``device``: host values through ``np.array``
    (NumPy's types), cast to ``dtype`` when given."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=dtype or x.dtype,
                             copy=True)
    np_type = None if dtype is None else _np_dtype(dtype)
    arr = np.array(x, dtype=np_type if isinstance(np_type, np.dtype)
                   else None)
    if arr.dtype not in _NP_TORCH:
        raise TypeError(f"unsupported array type {arr.dtype}")
    if arr.ndim == 0:  # filled on the device: no copy from the host, which
        # a CUDA graph capture (``jit``) cannot take
        return torch.full((), arr.item(), device=device,
                          dtype=dtype or _NP_TORCH[arr.dtype])
    t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype or t.dtype)


# ---------------------------------------------------------------------- #
#                                  tape                                  #
# ---------------------------------------------------------------------- #
class Graph:
    """Global gradient tape: requires-grad tensors in creation order."""

    node_list: list = []

    @classmethod
    def _add_node(cls, node: "Tensor") -> None:
        cls.node_list.append(node)

    @classmethod
    def _free_node(cls, node: "Tensor") -> None:
        for i in range(len(cls.node_list) - 1, -1, -1):
            if cls.node_list[i] is node:
                del cls.node_list[i]
                break
        node._inputs = ()
        node._backward_fn = None
        node._grad = None

    @classmethod
    def free_graph(cls) -> None:
        for node in cls.node_list:
            node._inputs = ()
            node._backward_fn = None
        cls.node_list.clear()

    @classmethod
    def size(cls) -> int:
        return len(cls.node_list)


def _bind(t: "Tensor", data: torch.Tensor) -> None:
    """Point ``t`` at ``data``; mark the array shared if another Tensor
    holds it already."""
    if getattr(data, "_pdt_held", False):
        data._pdt_shared = True
    else:
        data._pdt_held = True
    t._data = data


def _assign(t: "Tensor", value: torch.Tensor) -> None:
    """Give ``t`` the value ``value``: written into ``t``'s own memory where
    shape, type and device match and no other Tensor holds it, else
    rebound."""
    d = t._data
    if (value.shape == d.shape and value.dtype == d.dtype
            and value.device == d.device
            and not getattr(d, "_pdt_shared", False)):
        if value is not d:
            d.copy_(value)
    else:
        _bind(t, value)


class _DataRef:
    """Mutable view returned by ``Tensor.data``: reads give torch tensors,
    and ``x.data[...] = v`` and ``x.data -= v`` write back into the owning
    tensor (:func:`_assign`), keeping the reference's idioms."""

    __slots__ = ("_t",)

    def __init__(self, t: "Tensor") -> None:
        self._t = t

    # ---- conversion protocols ----
    def __array__(self, dtype=None, copy=None):
        arr = _to_numpy(self._t._data)
        return arr.astype(dtype) if dtype is not None else arr

    # ---- introspection ----
    @property
    def shape(self):
        return tuple(self._t._data.shape)

    @property
    def dtype(self):
        return _np_dtype(self._t._data.dtype)

    @property
    def ndim(self):
        return self._t._data.dim()

    @property
    def size(self):
        return self._t._data.numel()

    def astype(self, dtype):
        return self._t._data.to(torch_dtype(dtype), copy=True)

    def item(self):
        return self._t._data.item()

    def copy(self):
        return _to_numpy(self._t._data)

    def tolist(self):
        return self._t._data.tolist()

    def __repr__(self):
        return repr(self._t._data)

    def __len__(self):
        return len(self._t._data)

    # ---- reads ----
    def __getitem__(self, key):
        d = self._t._data
        return _own(_index(d, _unwrap_key(key, d.device)), d)

    def __iter__(self):
        return iter(self._t._data.clone())

    # ---- writes ----
    def __setitem__(self, key, value):
        t = self._t
        new = t._data.clone() if getattr(t._data, "_pdt_shared", False) \
            else t._data
        _setitem(new, key, value)
        _assign(t, new)

    # ---- arithmetic on the torch array, JAX's result types ----
    def _bin(self, other, fn, reverse=False):
        a, b = self._t._data, _raw(other)
        if not isinstance(b, torch.Tensor):
            b = b if isinstance(b, (bool, int, float)) else \
                _host(b, None, a.device)
        dt = result_type(a, b)
        a = _compute(_cast(a, dt))
        if isinstance(b, torch.Tensor):
            b = _compute(_cast(b, dt))
        out = fn(b, a) if reverse else fn(a, b)
        return out.to(dt) if dt in _WIDE_UNSIGNED \
            and out.dtype == torch.int64 else out

    def __add__(self, o):
        return self._bin(o, torch.add)

    def __radd__(self, o):
        return self._bin(o, torch.add, True)

    def __sub__(self, o):
        return self._bin(o, torch.sub)

    def __rsub__(self, o):
        return self._bin(o, torch.sub, True)

    def __mul__(self, o):
        return self._bin(o, torch.mul)

    def __rmul__(self, o):
        return self._bin(o, torch.mul, True)

    def __truediv__(self, o):
        return self._bin(o, _true_div)

    def __rtruediv__(self, o):
        return self._bin(o, _true_div, True)

    def __pow__(self, o):
        return self._bin(o, torch.pow)

    def __matmul__(self, o):
        with _full_f32():
            return self._bin(o, torch.matmul)

    def __rmatmul__(self, o):
        with _full_f32():
            return self._bin(o, torch.matmul, True)

    def __neg__(self):
        return -self._t._data

    def __eq__(self, o):
        return self._bin(o, torch.eq)

    def __ne__(self, o):
        return self._bin(o, torch.ne)

    def __lt__(self, o):
        return self._bin(o, torch.lt)

    def __le__(self, o):
        return self._bin(o, torch.le)

    def __gt__(self, o):
        return self._bin(o, torch.gt)

    def __ge__(self, o):
        return self._bin(o, torch.ge)

    def __hash__(self):
        return id(self._t)


def _true_div(a, b):
    """``a / b`` with JAX's float type for integer operands."""
    if torch.is_tensor(a):
        a = _cast(a, _inexact(a.dtype))
    if torch.is_tensor(b):
        b = _cast(b, _inexact(b.dtype))
    return torch.div(a, b)


def _raw(x):
    """Underlying torch value of any Tensor/_DataRef, else ``x``."""
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, _DataRef):
        return x._t._data
    return x


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy().copy()


def _unwrap_key(key, device):
    """Normalize an indexing key: Tensors, arrays, lists and ranges become
    torch index tensors on ``device``."""
    if isinstance(key, tuple):
        return tuple(_unwrap_key(k, device) for k in key)
    if isinstance(key, (Tensor, _DataRef)):
        key = _raw(key)
    if isinstance(key, range):
        key = np.arange(key.start, key.stop, key.step)
    if isinstance(key, (list, np.ndarray)):
        key = torch.from_numpy(np.array(key))
    if isinstance(key, torch.Tensor) and key.device != device:
        key = key.to(device)
    return key


def _flips(shape, key):
    """Split negative-step slices out of ``key``: PyTorch has none. Returns
    the input dims to flip and the key with those slices made positive in
    the flipped coordinates (``a[s:e:-k]`` is ``flip(a)[n-1-s:n-1-e:k]``)."""
    items = list(key) if isinstance(key, tuple) else [key]
    used = builtins.sum(
        k.dim() if isinstance(k, torch.Tensor) and k.dtype == torch.bool
        else 0 if k is None or k is Ellipsis else 1 for k in items)
    dims, out, d = [], [], 0
    for k in items:
        if k is Ellipsis:
            d += len(shape) - used
        elif k is None:
            pass
        elif isinstance(k, slice):
            if k.step is not None and k.step < 0:
                n = shape[d]
                start, stop, step = k.indices(n)
                k = slice(n - 1 - start, n - 1 - stop, -step)
                dims.append(d)
            d += 1
        elif isinstance(k, torch.Tensor) and k.dtype == torch.bool:
            d += k.dim()
        else:
            d += 1
        out.append(k)
    return dims, (tuple(out) if isinstance(key, tuple) else out[0])


def _index(a: torch.Tensor, key):
    dims, key = _flips(a.shape, key)
    return (a.flip(dims) if dims else a)[key]


def _setitem(d: torch.Tensor, key, value) -> None:
    key = _unwrap_key(key, d.device)
    value = _raw(value)
    if not isinstance(value, torch.Tensor):
        value = value if isinstance(value, (bool, int, float)) else \
            _host(value, d.dtype, d.device)
    dims, key2 = _flips(d.shape, key)
    if dims:  # write through the flipped coordinates
        f = d.flip(dims)
        f[key2] = value
        d.copy_(f.flip(dims))
    else:
        d[key] = value


# ---------------------------------------------------------------------- #
#                                 Tensor                                 #
# ---------------------------------------------------------------------- #
class Tensor:
    """Eager tensor over a ``torch.Tensor`` participating in the global
    tape."""

    __slots__ = ("_data", "device", "requires_grad", "_grad", "_inputs",
                 "_backward_fn", "_force_backward", "__weakref__")

    def __init__(self, data, dtype=None, device=None,
                 requires_grad: bool = False, copy=None) -> None:
        if isinstance(data, Tensor):
            raise TypeError(
                "Tensor of Tensor is not allowed; use tensor.data instead.")
        if isinstance(data, _DataRef):
            data = data._t._data
        device = device if isinstance(device, Device) else Device(device)
        _bind(self, _host(data, torch_dtype(dtype), device.torch_device))
        self.device = device

        requires_grad = bool(requires_grad) and is_grad_enable()
        if requires_grad and not self._data.is_floating_point():
            raise ValueError(
                "Only Tensors of floating point dtype can require gradients!")
        self.requires_grad = requires_grad
        self._grad = None
        self._inputs = ()
        self._backward_fn = None
        self._force_backward = False
        if self.requires_grad:
            Graph._add_node(self)

    # construction fast path used by operators (no copy, no checks)
    @classmethod
    def _wrap(cls, data, device: Device, requires_grad: bool,
              share: bool = False) -> "Tensor":
        t = cls.__new__(cls)
        if share:  # a transient operand: never written
            t._data = data
        else:
            _bind(t, data)
        t.device = device
        t.requires_grad = requires_grad
        t._grad = None
        t._inputs = ()
        t._backward_fn = None
        t._force_backward = False
        if requires_grad:
            Graph._add_node(t)
        return t

    # ---------------- properties ----------------
    @property
    def is_leaf(self) -> bool:
        return self._backward_fn is None

    @property
    def data(self) -> _DataRef:
        return _DataRef(self)

    @data.setter
    def data(self, value) -> None:
        value = _raw(value)
        if not isinstance(value, torch.Tensor):
            value = _host(value, self._data.dtype, self._data.device)
        _assign(self, value)

    @property
    def torch(self) -> torch.Tensor:
        """The raw underlying ``torch.Tensor`` (the JAX package's ``.jax``
        escape hatch). Writing into it writes into this Tensor."""
        return self._data

    @property
    def grad(self):
        if self._grad is None and self.requires_grad:
            return torch.zeros_like(self._data)
        return self._grad

    @grad.setter
    def grad(self, value):
        self._grad = _raw(value) if value is not None else None

    @property
    def shape(self) -> tuple:
        return tuple(self._data.shape)

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def dtype(self):
        return _np_dtype(self._data.dtype)

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def strides(self) -> tuple:
        # numpy-style byte strides of the logical C-contiguous layout
        itemsize = self._data.element_size()
        strides, acc = [], itemsize
        for dim in reversed(self.shape):
            strides.append(acc)
            acc *= dim
        return tuple(reversed(strides))

    @property
    def T(self) -> "Tensor":
        return transpose(self)

    @property
    def xp(self):
        return self.device.xp

    # ---------------- misc ----------------
    def __repr__(self) -> str:
        return "{}({}, requires_grad={}{})".format(
            "Tensor", _to_numpy(self._data), self.requires_grad,
            ", device={}".format(self.device)
            if self.device.kind != "cpu" else "")

    def __len__(self) -> int:
        return len(self._data)

    def __array__(self, dtype=None, copy=None):
        arr = _to_numpy(self._data)
        return arr.astype(dtype) if dtype is not None else arr

    def __bool__(self):
        return bool(self._data)

    def __float__(self):
        return float(self._data)

    def __int__(self):
        return int(self._data)

    def __hash__(self):
        return id(self)

    def astype(self, new_type) -> "Tensor":
        d = self._data
        return Tensor._wrap(_own(d.to(torch_dtype(new_type)), d),
                            self.device, False)

    def numpy(self) -> np.ndarray:
        return _to_numpy(self._data)

    def item(self):
        return self._data.item()

    def tolist(self):
        return self._data.tolist()

    # ---------------- shape methods ----------------
    def reshape(self, *new_shape) -> "Tensor":
        if len(new_shape) == 1 and isinstance(new_shape[0], (tuple, list)):
            new_shape = tuple(new_shape[0])
        return reshape(self, new_shape)

    def transpose(self, *axes) -> "Tensor":
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return transpose(self, axes if axes else None)

    def swapaxes(self, axis1: int, axis2: int) -> "Tensor":
        return swapaxes(self, axis1, axis2)

    def flatten(self) -> "Tensor":
        return reshape(self, (-1,))

    # ---------------- reduce methods ----------------
    def max(self, axis=None, keepdims: bool = False) -> "Tensor":
        return max(self, axis, keepdims)

    def min(self, axis=None, keepdims: bool = False) -> "Tensor":
        return min(self, axis, keepdims)

    def mean(self, axis=None, keepdims: bool = False) -> "Tensor":
        return mean(self, axis, keepdims)

    def sum(self, axis=None, keepdims: bool = False) -> "Tensor":
        return sum(self, axis, keepdims)

    def argmax(self, axis=None, keepdims: bool = False) -> "Tensor":
        return argmax(self, axis, keepdims)

    def argmin(self, axis=None, keepdims: bool = False) -> "Tensor":
        return argmin(self, axis, keepdims)

    # ---------------- arithmetic dunders ----------------
    def __add__(self, x) -> "Tensor":
        return add(self, x)

    def __radd__(self, x) -> "Tensor":
        return add(x, self)

    def __sub__(self, x) -> "Tensor":
        return sub(self, x)

    def __rsub__(self, x) -> "Tensor":
        return sub(x, self)

    def __mul__(self, x) -> "Tensor":
        return mul(self, x)

    def __rmul__(self, x) -> "Tensor":
        return mul(x, self)

    def __matmul__(self, x) -> "Tensor":
        return matmul(self, x)

    def __rmatmul__(self, x) -> "Tensor":
        return matmul(x, self)

    def __truediv__(self, x) -> "Tensor":
        return div(self, x)

    def __rtruediv__(self, x) -> "Tensor":
        return div(x, self)

    def __pow__(self, x) -> "Tensor":
        return pow(self, x)

    def __rpow__(self, x) -> "Tensor":
        return pow(x, self)

    def __pos__(self) -> "Tensor":
        return 1 * self

    def __neg__(self) -> "Tensor":
        return 0 - self

    def __abs__(self) -> "Tensor":
        return abs(self)

    # ---------------- indexing ----------------
    def __getitem__(self, key) -> "Tensor":
        return _get_slice(self, key)

    def _check_inplace(self):
        if self.requires_grad and is_grad_enable():
            raise ValueError(
                "In-place operation is forbidden in node requiring grad.")

    def __setitem__(self, key, value) -> None:
        self._check_inplace()
        self.data[key] = value

    def _inplace(self, other, op) -> "Tensor":
        self._check_inplace()
        _assign(self, op(self.data, _raw(other)))
        return self

    def __iadd__(self, other) -> "Tensor":
        return self._inplace(other, _DataRef.__add__)

    def __isub__(self, other) -> "Tensor":
        return self._inplace(other, _DataRef.__sub__)

    def __imul__(self, other) -> "Tensor":
        return self._inplace(other, _DataRef.__mul__)

    def __itruediv__(self, other) -> "Tensor":
        return self._inplace(other, _DataRef.__truediv__)

    def __imatmul__(self, other) -> "Tensor":
        return self._inplace(other, _DataRef.__matmul__)

    # ---------------- comparisons (bool tensors, off-tape) ----------------
    def _compare(self, other, fn) -> "Tensor":
        return Tensor._wrap(self.data._bin(other, fn), self.device, False)

    def eq(self, other) -> "Tensor":
        return self._compare(other, torch.eq)

    def ne(self, other) -> "Tensor":
        return self._compare(other, torch.ne)

    def __lt__(self, other) -> "Tensor":
        return self._compare(other, torch.lt)

    def __le__(self, other) -> "Tensor":
        return self._compare(other, torch.le)

    def __gt__(self, other) -> "Tensor":
        return self._compare(other, torch.gt)

    def __ge__(self, other) -> "Tensor":
        return self._compare(other, torch.ge)

    # ---------------- autograd ----------------
    def backward(self, retain_graph: bool = False) -> None:
        # the reference's contract: ValueError for both the off-graph and
        # the non-scalar case; size-1 tensors of any shape count as scalars
        if not builtins.any(n is self for n in Graph.node_list):
            raise ValueError(
                "AD failed because this tensor is not in the graph.")
        if self.size > 1:
            raise ValueError("backward should be called only on a scalar.")

        y_id = len(Graph.node_list) - 1
        while Graph.node_list[y_id] is not self:
            y_id -= 1

        self._grad = torch.ones_like(self._data)
        _sweep_token[0] += 1

        for node in Graph.node_list[y_id::-1]:
            if node._backward_fn is not None and (
                    node._grad is not None or node._force_backward):
                needs = tuple(t.requires_grad for t in node._inputs)
                grads = node._backward_fn(node._grad, needs)
                for inp, g in zip(node._inputs, grads):
                    if g is None or not inp.requires_grad:
                        continue
                    g = _cast(_unbroadcast(g, inp._data.shape),
                              inp._data.dtype)
                    inp._grad = g if inp._grad is None else inp._grad + g
            if not retain_graph and not node.is_leaf:
                Graph._free_node(node)

    def zero_grad(self) -> None:
        self._grad = None

    # ---------------- device movement ----------------
    def to(self, device) -> "Tensor":
        device = device if isinstance(device, Device) else Device(device)
        if device != self.device:
            _bind(self, self._data.to(device.torch_device))
            if self._grad is not None:
                self._grad = self._grad.to(device.torch_device)
            self.device = device
        return self

    def cpu(self) -> "Tensor":
        return self.to("cpu")

    def cuda(self, id: int = 0) -> "Tensor":
        return self.to(Device(id))

    def tpu(self, id: int = 0) -> "Tensor":
        return self.to(Device(id))


# ---------------------------------------------------------------------- #
#                           operator machinery                           #
# ---------------------------------------------------------------------- #
def _unbroadcast(g, shape):
    """Sum a broadcast gradient back to ``shape``."""
    shape = tuple(shape)
    if tuple(g.shape) == shape:
        return g
    extra = g.dim() - len(shape)
    if extra > 0:
        g = g.sum(dim=tuple(range(extra)))
    axes = tuple(i for i, (gs, s) in enumerate(zip(g.shape, shape))
                 if s == 1 and gs != 1)
    if axes:
        g = g.sum(dim=axes, keepdim=True)
    if tuple(g.shape) != shape:
        g = g.reshape(shape)
    return g


def _coerce(x, peer: Optional[Tensor] = None) -> Tensor:
    """Scalar/array operand -> Tensor with the peer's dtype and device."""
    if isinstance(x, Tensor):
        return x
    if isinstance(x, _DataRef):
        return Tensor._wrap(x._t._data, x._t.device, False, share=True)
    dtype = peer._data.dtype if peer is not None else None
    device = peer.device if peer is not None else Device(None)
    return Tensor._wrap(_host(x, dtype, device.torch_device), device, False)


def _pair(x, y):
    if isinstance(x, Tensor):
        y = _coerce(y, x)
    elif isinstance(y, Tensor):
        x = _coerce(x, y)
    else:
        x, y = _coerce(x), _coerce(y)
    if x.device != y.device:
        raise RuntimeError(
            f"Tensors on different devices: {x.device} vs {y.device}")
    return x, y


def _promoted(x: Tensor, y: Tensor, inexact: bool = False):
    """Both operands' arrays in their JAX result type (through int64 for
    the unsigned types PyTorch cannot compute with), and that type."""
    dt = result_type(x._data, y._data)
    if inexact:
        dt = _inexact(dt)
    return _compute(_cast(x._data, dt)), _compute(_cast(y._data, dt)), dt


def _node(data, inputs: Sequence[Tensor], backward_fn: Callable) -> Tensor:
    """Create an op-output tensor, attaching tape edges when grad is on."""
    req = is_grad_enable() and builtins.any(t.requires_grad for t in inputs)
    out = Tensor._wrap(data, inputs[0].device, req)
    if req:
        out._inputs = tuple(inputs)
        out._backward_fn = backward_fn
    return out


def _partial_vjp(pure_fn, datas, inputs, remat: bool = False):
    """``torch.func.vjp`` over only the ``requires_grad`` inputs: frozen
    operands are closed over as constants, so their cotangents are never
    built. Returns ``(out, vjp_full)`` where ``vjp_full(g)`` yields a
    full-arity tuple with ``None`` at the frozen slots. With ``remat`` the
    forward runs without residuals and the VJP recomputes it."""
    diff = tuple(i for i, t in enumerate(inputs) if t.requires_grad)
    idx = frozenset(diff)

    def fn_subset(*sub):
        it = iter(sub)
        return pure_fn(*(next(it) if i in idx else d
                         for i, d in enumerate(datas)))

    primals = tuple(datas[i] for i in diff)
    with _full_f32():
        if remat:
            out = fn_subset(*primals)

            def vjp(g):
                return torch.func.vjp(fn_subset, *primals)[1](g)
        else:
            out, vjp = torch.func.vjp(fn_subset, *primals)

    def vjp_full(g):
        with _full_f32():
            it = iter(vjp(g))
        return tuple(next(it) if i in idx else None
                     for i in range(len(datas)))

    return out, vjp_full


def _vjp_node(pure_fn, *inputs: Tensor, datas=None) -> Tensor:
    """Single-output node whose backward is ``torch.func.vjp`` of
    ``pure_fn``."""
    datas = tuple(t._data for t in inputs) if datas is None else datas
    if is_grad_enable() and builtins.any(t.requires_grad for t in inputs):
        out, vjp = _partial_vjp(pure_fn, datas, inputs)
        return _node(_own(out, *datas), inputs, lambda g, needs: vjp(g))
    with _full_f32():
        out = pure_fn(*datas)
    return Tensor._wrap(_own(out, *datas), inputs[0].device, False)


_sweep_token = [0]


def wrap_pure(pure_fn, *inputs: Tensor, _remat: bool = False):
    """Record a pure torch function as tape node(s).

    ``pure_fn`` takes raw ``torch.Tensor``s and returns one tensor or a
    tuple; each output becomes its own Tensor. All outputs share one VJP
    (``torch.func.vjp``): during the reverse sweep later-created outputs
    stash their incoming gradients and the first-created output (processed
    last) runs the VJP with the full cotangent tuple (zeros for outputs
    that received none)."""
    datas = tuple(t._data for t in inputs)
    grad_on = is_grad_enable() and builtins.any(t.requires_grad
                                                for t in inputs)
    dev = inputs[0].device
    if not grad_on:
        with _full_f32():
            outs = pure_fn(*datas)
        if isinstance(outs, tuple):
            return tuple(Tensor._wrap(_own(o, *datas), dev, False)
                         for o in outs)
        return Tensor._wrap(_own(outs, *datas), dev, False)

    outs, vjp = _partial_vjp(pure_fn, datas, inputs, _remat)
    if not isinstance(outs, tuple):
        return _node(_own(outs, *datas), inputs, lambda g, needs: vjp(g))

    n_out = len(outs)
    avals = [(o.shape, o.dtype, o.device) for o in outs]
    stash = {"token": -1, "grads": [None] * n_out}

    def _ensure_fresh():
        if stash["token"] != _sweep_token[0]:
            stash["token"] = _sweep_token[0]
            stash["grads"] = [None] * n_out

    def make_backward(k):
        if k == 0:
            # the earliest-created output is processed last in the reverse
            # sweep, so every sibling's cotangent is stashed by then; it is
            # force-run even with no incoming gradient
            def head_backward(g, needs):
                _ensure_fresh()
                stash["grads"][0] = g
                if all(sg is None for sg in stash["grads"]):
                    return (None,) * len(inputs)
                cot = tuple(
                    sg if sg is not None else torch.zeros(
                        shape, dtype=dtype, device=device)
                    for sg, (shape, dtype, device) in zip(stash["grads"],
                                                          avals))
                stash["grads"] = [None] * n_out
                return vjp(cot)

            return head_backward

        def tail_backward(g, needs):
            _ensure_fresh()
            stash["grads"][k] = g
            return (None,) * len(inputs)

        return tail_backward

    out_tensors = tuple(_node(_own(o, *datas), inputs, make_backward(k))
                        for k, o in enumerate(outs))
    if out_tensors and out_tensors[0]._backward_fn is not None:
        out_tensors[0]._force_backward = True
    return out_tensors


def remat_pure(pure_fn, *inputs: Tensor):
    """``wrap_pure`` with activation rematerialization: the node keeps no
    residuals of ``pure_fn`` and its VJP recomputes the forward from the
    inputs during the reverse sweep. Gradients are ``wrap_pure``'s bit for
    bit."""
    return wrap_pure(pure_fn, *inputs, _remat=True)


# ---------------------------------------------------------------------- #
#                          arithmetic operators                          #
# ---------------------------------------------------------------------- #
def _binary(x, y, fn, backward, inexact=False) -> Tensor:
    x, y = _pair(x, y)
    xd, yd, dt = _promoted(x, y, inexact)
    out = _cast(fn(xd, yd), dt)
    return _node(out, (x, y), lambda g, needs: backward(g, needs, xd, yd,
                                                        out))


def add(x, y) -> Tensor:
    return _binary(x, y, torch.add, lambda g, needs, xd, yd, out: (g, g))


def sub(x, y) -> Tensor:
    return _binary(x, y, torch.sub, lambda g, needs, xd, yd, out: (g, -g))


def mul(x, y) -> Tensor:
    return _binary(x, y, torch.mul, lambda g, needs, xd, yd, out: (
        g * yd if needs[0] else None, g * xd if needs[1] else None))


def _div_backward(g, needs, xd, yd, out):
    inv_y = 1.0 / yd
    return (g * inv_y if needs[0] else None,
            -g * xd * inv_y * inv_y if needs[1] else None)


def div(x, y) -> Tensor:
    return _binary(x, y, torch.div, _div_backward, inexact=True)


def _pow_backward(g, needs, xd, yd, out):
    return (g * yd * torch.pow(xd, yd - 1) if needs[0] else None,
            g * out * torch.log(xd) if needs[1] else None)


def pow(x, y) -> Tensor:
    return _binary(x, y, torch.pow, _pow_backward)


def matmul(x, y) -> Tensor:
    x, y = _pair(x, y)
    xd, yd, dt = _promoted(x, y)
    node = _vjp_node(torch.matmul, x, y, datas=(xd, yd))
    if node._data.dtype != dt:  # the unsigned types compute in int64
        _bind(node, node._data.to(dt))
    return node


def _tie_backward(g, needs, xd, yd, out):
    # at exact ties BOTH operands receive the full gradient: the
    # reference's equality-mask gradient, not a 50/50 split
    return (g * (xd == out) if needs[0] else None,
            g * (yd == out) if needs[1] else None)


def maximum(x, y) -> Tensor:
    return _binary(x, y, torch.maximum, _tie_backward)


def minimum(x, y) -> Tensor:
    return _binary(x, y, torch.minimum, _tie_backward)


# ---------------------------------------------------------------------- #
#                     unary / elementwise operators                      #
# ---------------------------------------------------------------------- #
def _float_in(x: Tensor) -> torch.Tensor:
    return _cast(x._data, _inexact(x._data.dtype))


def abs(x) -> Tensor:
    x = _coerce(x)
    xd = x._data
    out = _cast(torch.abs(_compute(xd)), xd.dtype)
    return _node(out, (x,), lambda g, needs: (g * torch.sign(xd),))


def exp(x) -> Tensor:
    x = _coerce(x)
    out = torch.exp(_float_in(x))
    return _node(out, (x,), lambda g, needs: (g * out,))


def log(x) -> Tensor:
    x = _coerce(x)
    xd = _float_in(x)
    return _node(torch.log(xd), (x,), lambda g, needs: (g / xd,))


def sign(x) -> Tensor:
    x = _coerce(x)
    xd = x._data
    if xd.dtype == torch.bool:
        raise TypeError("sign does not accept dtype bool")
    out = _cast(torch.sign(_compute(xd)), xd.dtype)
    return _node(out, (x,), lambda g, needs: (torch.zeros_like(xd),))


def sigmoid(x) -> Tensor:
    x = _coerce(x)
    if not x._data.is_floating_point():
        raise TypeError(f"sigmoid does not accept dtype {x.dtype}")
    out = torch.sigmoid(x._data)
    return _node(out, (x,), lambda g, needs: (g * out * (1 - out),))


def tanh(x) -> Tensor:
    x = _coerce(x)
    out = torch.tanh(_float_in(x))
    return _node(out, (x,), lambda g, needs: (g * (1 - out * out),))


# ---------------------------------------------------------------------- #
#                               reductions                               #
# ---------------------------------------------------------------------- #
def _axes(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    return tuple(a % ndim if ndim else a for a in axes)


def _expand_reduced(g, x_shape, axis, keepdims):
    """Broadcast a reduced gradient back over the reduced axes."""
    if axis is None or keepdims:
        return torch.broadcast_to(g, x_shape)
    for a in sorted(_axes(axis, len(x_shape))):
        g = g.unsqueeze(a)
    return torch.broadcast_to(g, x_shape)


def _reduce(fn, xd, axis, keepdims, **kw):
    dims = _axes(axis, xd.dim())
    if not dims:  # a 0-d input, or no axis: the identity
        return fn(xd.unsqueeze(-1), dim=-1, **kw)
    return fn(xd, dim=dims, keepdim=bool(keepdims), **kw)


def sum(x, axis=None, keepdims: bool = False) -> Tensor:
    x = _coerce(x)
    xd = x._data
    if xd.is_floating_point():
        out = _reduce(torch.sum, xd, axis, keepdims)
    else:  # integers and bool sum in int64, unsigned types in uint64
        signed = xd.dtype not in (torch.uint8,) + _WIDE_UNSIGNED
        out = _reduce(torch.sum, _compute(xd), axis, keepdims,
                      dtype=torch.int64)
        out = out if signed else out.to(torch.uint64)
    return _node(out, (x,), lambda g, needs: (
        _expand_reduced(g, xd.shape, axis, keepdims),))


def mean(x, axis=None, keepdims: bool = False) -> Tensor:
    x = _coerce(x)
    xd = x._data
    out = _reduce(torch.mean, _float_in(x), axis, keepdims)
    scale = out.numel() / xd.numel() if xd.numel() else 1.0
    return _node(out, (x,), lambda g, needs: (
        _expand_reduced(g, xd.shape, axis, keepdims) * scale,))


def max(x, axis=None, keepdims: bool = False) -> Tensor:
    return _minmax(x, axis, keepdims, torch.amax)


def min(x, axis=None, keepdims: bool = False) -> Tensor:
    return _minmax(x, axis, keepdims, torch.amin)


def _minmax(x, axis, keepdims, fn) -> Tensor:
    x = _coerce(x)
    xd = x._data
    out = _cast(_reduce(fn, _compute(xd), axis, keepdims), xd.dtype)

    def backward(g, needs):
        full = _expand_reduced(out, xd.shape, axis, keepdims)
        gfull = _expand_reduced(g, xd.shape, axis, keepdims)
        return (gfull * (xd == full),)

    return _node(out, (x,), backward)


def _arg(x, axis, keepdims, fn) -> Tensor:
    x = _coerce(x)
    xd = _compute(x._data)
    if xd.dtype == torch.bool:
        xd = xd.to(torch.uint8)
    if axis is None:
        out = fn(xd.reshape(-1))
        if keepdims:
            out = out.reshape((1,) * xd.dim())
    else:
        out = fn(xd, dim=axis, keepdim=bool(keepdims))
    return Tensor._wrap(out, x.device, False)


def argmax(x, axis=None, keepdims: bool = False) -> Tensor:
    return _arg(x, axis, keepdims, torch.argmax)


def argmin(x, axis=None, keepdims: bool = False) -> Tensor:
    return _arg(x, axis, keepdims, torch.argmin)


# ---------------------------------------------------------------------- #
#                             shape operators                            #
# ---------------------------------------------------------------------- #
def reshape(x, new_shape) -> Tensor:
    x = _coerce(x)
    xd = x._data
    if isinstance(new_shape, int):
        new_shape = (new_shape,)
    return _node(_own(torch.reshape(xd, tuple(new_shape)), xd), (x,),
                 lambda g, needs: (g.reshape(xd.shape),))


def transpose(x, axes=None) -> Tensor:
    x = _coerce(x)
    xd = x._data
    if axes is None:
        axes = tuple(range(xd.dim() - 1, -1, -1))
    else:
        # normalize negatives BEFORE argsort (argsort((0, -1, -2)) is not
        # the inverse permutation of (0, 2, 1)); a single +ndim shift like
        # numpy, not modulo, so out-of-range axes raise
        axes = tuple(a + xd.dim() if a < 0 else a for a in axes)
        for a in axes:
            if not 0 <= a < xd.dim():
                raise np.exceptions.AxisError(a, xd.dim())
    inv = tuple(int(i) for i in np.argsort(axes))
    return _node(_own(xd.permute(axes), xd), (x,),
                 lambda g, needs: (g.permute(inv),))


def swapaxes(x, axis1: int, axis2: int) -> Tensor:
    x = _coerce(x)
    xd = x._data
    return _node(_own(torch.swapaxes(xd, axis1, axis2), xd), (x,),
                 lambda g, needs: (torch.swapaxes(g, axis1, axis2),))


def _get_slice(x, key) -> Tensor:
    x = _coerce(x)
    key = _unwrap_key(key, x._data.device)
    return _vjp_node(lambda a: _index(a, key), x)


def concat(tensors, axis: int = 0) -> Tensor:
    tensors = [_coerce(t) for t in tensors]
    dt = result_type(*(t._data for t in tensors))
    datas = [_compute(_cast(t._data, dt)) for t in tensors]
    out = _cast(torch.cat(datas, dim=axis), dt)
    sizes = [d.shape[axis] for d in datas]
    offsets = np.cumsum([0] + sizes)
    nd = out.dim()
    ax = axis % nd

    def backward(g, needs):
        grads = []
        for i, need in enumerate(needs):
            if not need:
                grads.append(None)
                continue
            idx = tuple(
                slice(int(offsets[i]), int(offsets[i + 1])) if d == ax
                else slice(None) for d in builtins.range(nd))
            grads.append(g[idx])
        return tuple(grads)

    return _node(out, tensors, backward)
