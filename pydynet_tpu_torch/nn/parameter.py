"""``Parameter`` (counterpart of ``pydynet_tpu/nn/parameter.py``): torch's
``nn.Parameter``, which also takes a tape ``Tensor``.

The JAX package's ``Parameter(Tensor)`` shares the Tensor's immutable
array. A torch Parameter is written in place (``p.data -= ...``), so here
it gets a copy of the Tensor's memory: writing one never changes the other,
as in the JAX package. Every torch ``nn.Parameter`` is an instance of it.
"""
import torch

from ..core.tensor import Tensor


class _ParameterMeta(type(torch.nn.Parameter)):

    def __instancecheck__(cls, instance):
        return isinstance(instance, torch.nn.Parameter)


class Parameter(torch.nn.Parameter, metaclass=_ParameterMeta):

    def __new__(cls, data=None, requires_grad: bool = True):
        if isinstance(data, Tensor):
            data = data.torch.detach().clone()
        return torch.nn.Parameter(data, requires_grad)
