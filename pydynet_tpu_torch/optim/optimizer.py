"""Adam and AdamW with the JAX package's update rules
(``pydynet_tpu/optim/optimizer.py:152-218``).

Adam's bias correction is ``a_t = sqrt(1 - beta2^t) / (1 - beta1^t)``
with t starting at 1, and the update ``p -= lr * a_t * m / (sqrt(v) +
eps)``: eps is added to ``sqrt(v)`` unscaled, which is not what
``torch.optim.Adam`` does (it divides ``sqrt(v)`` by ``sqrt(1 - beta2^t)``
before adding eps), so the two differ where ``v`` is small. The moments,
the step counter and the learning rate are tensors on the parameters'
device, so a step never waits for the host; reading ``lr`` or ``t`` does.
A parameter without a gradient steps with a zero gradient, as there.
"""
from __future__ import annotations

import torch


class Optimizer:

    def __init__(self, params) -> None:
        self.params: list[torch.Tensor] = list(params)
        self._device = (self.params[0].device if self.params
                        else torch.device("cpu"))

    @property
    def lr(self) -> float:
        return float(self._lr_tensor)

    @lr.setter
    def lr(self, value) -> None:
        if not hasattr(self, "_lr_tensor"):
            self._lr_tensor = torch.tensor(float(value), dtype=torch.float32,
                                           device=self._device)
        else:
            self._lr_tensor.fill_(float(value))

    def _zeros(self) -> list:
        """A zero buffer per parameter, of its shape, type and device."""
        return [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self):
        raise NotImplementedError


class Adam(Optimizer):

    def __init__(self, params, lr: float = 1e-3,
                 betas: tuple = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0) -> None:
        super().__init__(params)
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.m, self.v = self._zeros(), self._zeros()
        self._t_tensor = torch.ones((), dtype=torch.float32,
                                    device=self._device)

    @property
    def t(self) -> float:
        return float(self._t_tensor)

    @torch.no_grad()
    def step(self):
        lr, t = self._lr_tensor, self._t_tensor
        a_t = torch.sqrt(1 - self.beta2**t) / (1 - self.beta1**t)
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if self.weight_decay:
                g = g + self.weight_decay * p
            m.copy_(self.beta1 * m + (1 - self.beta1) * g)
            v.copy_(self.beta2 * v + (1 - self.beta2) * g * g)
            p.sub_(lr * a_t * m / (torch.sqrt(v) + self.eps))
        t.add_(1)


class AdamW(Adam):
    """Adam with decoupled weight decay: each parameter that has a gradient
    is first multiplied by ``1 - lr * weight_decay``; the moments see the raw
    gradient."""

    def __init__(self, params, lr: float = 1e-3,
                 betas: tuple = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2) -> None:
        super().__init__(params, lr, betas, eps, weight_decay=0)
        self.decoupled_weight_decay = weight_decay

    @torch.no_grad()
    def step(self):
        wd = self.decoupled_weight_decay
        if wd:
            for p in self.params:
                if p.grad is not None:
                    p.mul_(1.0 - self._lr_tensor * wd)
        super().step()
