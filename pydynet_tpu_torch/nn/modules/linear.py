"""Linear and Embedding (counterparts of ``pydynet_tpu/nn/modules/linear.py``).

``Linear.weight`` is (in_features, out_features) and the forward is
``x @ W + b``, the JAX package's layout and not ``torch.nn.Linear``'s, so a
state dict of one package loads into the other as it is. Parameters are made
on ``device`` (PyTorch's default device when not given) and filled from the
CPU's default generator (``nn/init.py``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .. import functional as F
from .. import init
from .module import Module


class Linear(Module):

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, dtype=None) -> None:
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty((in_features, out_features),
                                               **kw))
        self.bias = nn.Parameter(torch.empty(out_features, **kw)) \
            if bias else None
        self.reset_parameters()

    def reset_parameters(self):
        """kaiming_uniform with a = sqrt(5), bias uniform in
        +-1/sqrt(fan_in), as in the JAX package."""
        init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        if self.bias is not None:
            fan_in, _ = init._calculate_fan(self.weight)
            bound = 1 / math.sqrt(fan_in) if fan_in > 0 else 0
            init.uniform_(self.bias, -bound, bound)

    # the JAX package keeps its reference's spelling as an alias
    reset_paramters = reset_parameters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, bias={self.bias is not None}")


class Embedding(Module):
    """A (num_embeddings, embedding_dim) table drawn N(0, 1); the row of
    ``padding_idx`` is zero and gets no gradient."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, device=None, dtype=None) -> None:
        super().__init__()
        self.num_embedding = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = nn.Parameter(torch.empty(
            (num_embeddings, embedding_dim), device=device, dtype=dtype))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        init.normal_(self.weight)
        if self.padding_idx is not None:
            with torch.no_grad():
                self.weight[self.padding_idx] = 0.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.embedding(x, self.weight, self.padding_idx)

    def extra_repr(self) -> str:
        return (f"num_embeddings={self.num_embedding}, embedding_dim="
                f"{self.embedding_dim}")
