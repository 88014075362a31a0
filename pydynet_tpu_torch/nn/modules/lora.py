"""LoRA: low-rank adaptation of Linear layers (counterpart of
``pydynet_tpu/nn/modules/lora.py``).

A :class:`LoRALinear` keeps the wrapped Linear's frozen ``weight`` and
``bias`` and trains a rank-``r`` update ``delta = A B * (alpha / r)``:

* it adopts the base ``weight``/``bias`` Parameters under the same names,
  so every dotted name (``layers.0.attention.Q.weight``) is unchanged and
  the adapters appear as ``....lora_A`` / ``....lora_B``;
* the adapters keep the wrapped Linear's own layout. On the port's
  ``nn.Linear`` (the JAX package's (in, out) weight) ``lora_A`` is (in, r)
  and ``lora_B`` (r, out), as in the JAX package; on a ``torch.nn.Linear``
  (the Llama's, (out, in)) ``lora_A`` is (r, in) and ``lora_B`` (out, r),
  their transposes. So ``models/llama/convert.swap_linear``, which swaps
  every 2-D weight but the embedding, carries them between the packages
  with the Llama's other weights;
* ``A`` is drawn kaiming-uniform (a = sqrt(5)) in the JAX package's (in, r)
  layout from ``nn/init.py``'s generator, ``B`` is zero, so a freshly
  wrapped layer computes its base layer's output bit for bit.

Not ported: ``refresh_parameters``, which replays the JAX ``Module``'s
assignment-time flattening of dotted names; ``torch.nn.Module`` builds the
names from its children when asked.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .. import functional as F
from .. import init
from .linear import Linear
from .module import Module

LORA_NAMES = ("lora_A", "lora_B")


class LoRALinear(Module):
    """A frozen Linear plus a trainable rank-``r`` update:
    ``forward(x) = base(x) + dropout(x) A B * (alpha / r)`` (``alpha``
    defaults to ``r``), ``dropout`` with probability ``dropout`` in train
    mode. ``base`` is the port's ``nn.Linear`` or a ``torch.nn.Linear``."""

    def __init__(self, base, r: int, alpha: float = None,
                 dropout: float = 0.0):
        super().__init__()
        if type(base) not in (Linear, nn.Linear):
            raise TypeError(f"LoRALinear wraps a Linear, got {type(base)}")
        if r < 1:
            raise ValueError(f"rank r must be >= 1, got {r}")
        self.in_features = base.in_features
        self.out_features = base.out_features
        self.r = r
        self.alpha = float(alpha) if alpha is not None else float(r)
        self.scaling = self.alpha / r
        self.p_dropout = float(dropout)
        # torch.nn.Linear's (out, in) layout, or the JAX package's (in, out)
        self.torch_layout = type(base) is nn.Linear
        base.weight.requires_grad_(False)
        self.weight = base.weight
        if base.bias is not None:
            base.bias.requires_grad_(False)
        self.bias = base.bias
        kw = dict(device=base.weight.device, dtype=base.weight.dtype)
        a = torch.empty((self.in_features, r), **kw)
        init.kaiming_uniform_(a, a=math.sqrt(5))
        b = torch.zeros((r, self.out_features), **kw)
        if self.torch_layout:
            a, b = a.t().contiguous(), b.t().contiguous()
        self.lora_A = nn.Parameter(a)
        self.lora_B = nn.Parameter(b)

    def _low_rank(self, x):
        if self.torch_layout:
            return x @ self.lora_A.t() @ self.lora_B.t()
        return x @ self.lora_A @ self.lora_B

    def forward(self, x):
        if self.torch_layout:
            y = torch.nn.functional.linear(x, self.weight, self.bias)
        else:
            y = F.linear(x, self.weight, self.bias)
        d = F.dropout(x, self.p_dropout, training=self.training)
        return y + self._low_rank(d) * self.scaling

    def delta_array(self) -> torch.Tensor:
        """The update ``A B * scaling`` in the base weight's layout and
        type, without a gradient: what a decode snapshot adds to the weight
        (``Llama._weights``) and what :meth:`merge_` adds to it."""
        with torch.no_grad():
            a, b = self.lora_A.detach(), self.lora_B.detach()
            d = b @ a if self.torch_layout else a @ b
            return d * self.scaling

    @torch.no_grad()
    def merge_(self):
        """Fold the update into the base weight and return a plain Linear
        of the wrapped type holding the same Parameter objects."""
        self.weight.copy_(self.weight + self.delta_array().to(
            self.weight.dtype))
        cls = nn.Linear if self.torch_layout else Linear
        out = cls.__new__(cls)
        nn.Module.__init__(out)
        out.in_features, out.out_features = self.in_features, \
            self.out_features
        out.register_parameter("weight", self.weight)
        out.register_parameter("bias", self.bias)
        out.train(self.training)
        return out

    # the port's earlier names, kept for its callers
    delta = delta_array
    merge = merge_

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, r={self.r}, alpha={self.alpha}, "
                f"dropout={self.p_dropout}")


def iter_named_modules(root: nn.Module, prefix: str = ""):
    """``(dotted path, module)`` for ``root`` and every module below it, the
    tree the dotted parameter names are built from."""
    return root.named_modules(prefix=prefix)


def _swap(root: nn.Module, make) -> int:
    """Replace every child ``value`` for which ``make(name, value)`` gives
    a module by that module; returns the number replaced."""
    n = 0
    for _, mod in list(root.named_modules()):
        for name, value in list(mod.named_children()):
            new = make(name, value)
            if new is not None:
                setattr(mod, name, new)
                n += 1
    return n


def apply_lora(root: nn.Module, r: int, alpha: float = None,
               targets=("Q", "V"), dropout: float = 0.0,
               freeze: bool = True) -> int:
    """Wrap every Linear (exactly the port's ``nn.Linear`` or a
    ``torch.nn.Linear``) held under an attribute name in ``targets``
    anywhere in ``root`` with a :class:`LoRALinear`; returns the number
    wrapped. With ``freeze`` every parameter that existed before is frozen,
    so only the new ``lora_A``/``lora_B`` train."""
    targets = set(targets)
    before = list(root.parameters())

    def make(name, value):
        if name in targets and type(value) in (Linear, nn.Linear):
            return LoRALinear(value, r, alpha, dropout)
        return None

    wrapped = _swap(root, make)
    if wrapped and freeze:
        for p in before:
            p.requires_grad_(False)
    return wrapped


def merge_lora(root: nn.Module) -> int:
    """Fold every :class:`LoRALinear` under ``root`` into a plain Linear
    (weight += A B * scaling); returns the number merged. Dotted names are
    unchanged; the adapters disappear."""
    return _swap(root, lambda name, value: value.merge_()
                 if isinstance(value, LoRALinear) else None)


def lora_state_names(root: nn.Module):
    """Dotted names of every adapter parameter under ``root``."""
    return [n for n, _ in root.named_parameters()
            if n.rsplit(".", 1)[-1] in LORA_NAMES]
