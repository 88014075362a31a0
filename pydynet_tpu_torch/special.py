"""Factory functions (counterpart of ``pydynet_tpu/special.py``).

Creation happens on the host through NumPy, its random draws from NumPy's
global stream, so ``np.random.seed(s)`` gives this package and the JAX
package the same numbers bit for bit; the result is then placed on the
requested device. Randomness inside a captured step (dropout under ``jit``)
goes through ``pydynet_tpu_torch.random`` instead.
"""
import numpy as np

from .core.tensor import Tensor


def zeros(shape, dtype=None, device=None, requires_grad: bool = False):
    return Tensor(np.zeros(shape, dtype=dtype),
                  device=device,
                  requires_grad=requires_grad)


def ones(shape, dtype=None, device=None, requires_grad: bool = False):
    return Tensor(np.ones(shape, dtype=dtype),
                  device=device,
                  requires_grad=requires_grad)


def full(shape, fill_value, dtype=None, device=None,
         requires_grad: bool = False):
    return Tensor(np.full(shape, fill_value, dtype=dtype),
                  device=device,
                  requires_grad=requires_grad)


def randn(*shape, dtype=None, device=None, requires_grad: bool = False):
    return Tensor(np.random.randn(*shape).astype(dtype) if dtype is not None
                  else np.random.randn(*shape),
                  device=device,
                  requires_grad=requires_grad)


def rand(*shape, dtype=None, device=None, requires_grad: bool = False):
    data = np.random.rand(*shape)
    if dtype is not None:
        data = data.astype(dtype)
    return Tensor(data, device=device, requires_grad=requires_grad)


def uniform(low: float,
            high: float,
            shape=None,
            dtype=None,
            device=None,
            requires_grad: bool = False):
    data = np.random.uniform(low, high, size=shape)
    if dtype is not None:
        data = data.astype(dtype)
    return Tensor(data, device=device, requires_grad=requires_grad)


def empty(shape, dtype=None, device=None, requires_grad: bool = False):
    # zeros, as in the JAX package (whose arrays have no uninitialized
    # state); callers must not read it
    return Tensor(np.zeros(shape, dtype=dtype),
                  device=device,
                  requires_grad=requires_grad)
