"""SGD, Adagrad, Adadelta, Adam and AdamW with the JAX package's update
rules (``pydynet_tpu/optim/optimizer.py:77-218``), not ``torch.optim``'s.

SGD keeps ``v = momentum * v + lr * g`` and subtracts it; with Nesterov (on
by default, momentum 0.5 by default) it subtracts a further ``lr * g``.
Adagrad divides by ``sqrt(eps + G)`` with eps inside the root; Adadelta is
the JAX package's RMSProp-style accumulator ``G = rho G + (1 - rho) g^2``
and divides by ``sqrt(G + eps)``. Weight decay is added to the gradient.
The buffers keep the JAX package's names (``v`` for SGD, ``G``, ``m`` and
``v`` for Adam): the training-state checkpoint stores them by those names.

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


def _sqrt(x):
    """``sqrt(x)`` correctly rounded, as the JAX package's: PyTorch's
    vectorised float32 root on the CPU is within 0.5001 ulp, not 0.5, and
    lands one ulp off now and then, so a float32 CPU tensor is rooted in
    float64 and rounded once. The GPU's root is correctly rounded."""
    if x.is_cuda or x.dtype != torch.float32:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def _grad(p, weight_decay):
    """The gradient a step uses: zeros for a parameter without one, plus
    ``weight_decay * p``."""
    g = p.grad if p.grad is not None else torch.zeros_like(p)
    return g + weight_decay * p if weight_decay else g


class SGD(Optimizer):
    """``v = momentum * v + lr * g``, ``p -= v``; Nesterov (the default)
    also ``p -= lr * g``."""

    def __init__(self, params, lr: float, momentum: float = 0.5,
                 weight_decay: float = 0., nesterov: bool = True) -> None:
        super().__init__(params)
        self.lr = lr
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.v = self._zeros()

    @torch.no_grad()
    def step(self):
        lr = self._lr_tensor
        for p, v in zip(self.params, self.v):
            g = _grad(p, self.weight_decay)
            v.copy_(self.momentum * v + lr * g)
            p.sub_(v)
            if self.nesterov:
                p.sub_(lr * g)


class Adagrad(Optimizer):
    """``G += g^2``, ``p -= lr * g / sqrt(eps + G)``."""

    def __init__(self, params, lr: float = 1e-2, weight_decay: float = 0,
                 eps: float = 1e-10) -> None:
        super().__init__(params)
        self.lr = lr
        self.weight_decay = weight_decay
        self.eps = eps
        self.G = self._zeros()

    @torch.no_grad()
    def step(self):
        lr = self._lr_tensor
        for p, G in zip(self.params, self.G):
            g = _grad(p, self.weight_decay)
            G.copy_(G + g * g)
            p.sub_(lr * g / _sqrt(self.eps + G))


class Adadelta(Optimizer):
    """The JAX package's Adadelta, an RMSProp-style accumulator:
    ``G = rho G + (1 - rho) g^2``, ``p -= lr * g / sqrt(G + eps)``."""

    def __init__(self, params, lr: float = 1.0, rho: float = 0.9,
                 weight_decay: float = 0, eps: float = 1e-6) -> None:
        super().__init__(params)
        self.lr = lr
        self.rho = rho
        self.eps = eps
        self.weight_decay = weight_decay
        self.G = self._zeros()

    @torch.no_grad()
    def step(self):
        lr = self._lr_tensor
        for p, G in zip(self.params, self.G):
            g = _grad(p, self.weight_decay)
            G.copy_(self.rho * G + (1 - self.rho) * g * g)
            p.sub_(lr * g / _sqrt(G + self.eps))


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
            g = _grad(p, self.weight_decay)
            m.copy_(self.beta1 * m + (1 - self.beta1) * g)
            v.copy_(self.beta2 * v + (1 - self.beta2) * g * g)
            p.sub_(lr * a_t * m / (_sqrt(v) + self.eps))
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
