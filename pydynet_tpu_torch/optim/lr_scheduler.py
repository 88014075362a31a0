"""Learning-rate schedulers with the JAX package's formulas
(``pydynet_tpu/optim/lr_scheduler.py:23-137``).

Construction takes the first ``step()`` (``last_epoch`` -1 -> 0). Each step
computes the new rate from the optimizer's current one in the recursive
forms the JAX package keeps from its reference: Exponential multiplies by
``gamma ** epoch`` and Step by ``gamma ** (epoch // step_size)``, so both
compound; MultiStep multiplies by ``gamma`` once a milestone in a
``Counter``; Cosine reads the rate the step before last (``get_last_lr``)
and adds back ``(initial_lr - eta_min) (1 - cos(pi / T_max)) / 2`` at each
restart boundary. ``last_epoch != -1`` resumes: it needs the optimizer's
``initial_lr`` and seeds the lagged rate from the optimizer's (the JAX
package's fix of its reference). ``state_dict``/``load_state_dict`` carry
everything but the optimizer, for an exact resume.

The rate lives in the optimizer as a float32 tensor (``Optimizer.lr``), so
every rate read back here went through float32, as there.
"""
from __future__ import annotations

from collections import Counter
from math import cos, pi
from typing import List

from .optimizer import Optimizer


class _LRScheduler:

    def __init__(self, optimizer: Optimizer, last_epoch: int = -1) -> None:
        self.optimizer = optimizer
        self.last_epoch = last_epoch
        if last_epoch == -1:
            optimizer.initial_lr = optimizer.lr
        elif not hasattr(optimizer, "initial_lr"):
            raise AttributeError(
                "last_epoch != -1 but optimizer has no 'initial_lr'")
        else:
            self._last_lr = optimizer.lr
        self._step_count = 0
        self._get_lr_called_within_step = False
        self.step()

    def step(self) -> None:
        self._step_count += 1
        self.last_epoch += 1
        self._get_lr_called_within_step = True
        try:
            new_lr = self.get_lr()
        finally:
            self._get_lr_called_within_step = False
        self._last_lr = self.optimizer.lr
        self.optimizer.lr = new_lr

    def get_lr(self) -> float:
        raise NotImplementedError

    def get_last_lr(self) -> float:
        return self._last_lr

    def state_dict(self) -> dict:
        return {k: v for k, v in self.__dict__.items() if k != "optimizer"}

    def load_state_dict(self, state: dict) -> None:
        self.__dict__.update(state)


class ExponentialLR(_LRScheduler):
    """lr <- lr * gamma ** epoch."""

    def __init__(self, optimizer: Optimizer, gamma: float = 0.1,
                 last_epoch: int = -1) -> None:
        self.gamma = gamma
        super().__init__(optimizer, last_epoch)

    def get_lr(self) -> float:
        return self.optimizer.lr * self.gamma ** self.last_epoch


class StepLR(_LRScheduler):
    """lr <- lr * gamma ** (epoch // step_size)."""

    def __init__(self, optimizer: Optimizer, step_size: int,
                 gamma: float = 0.1, last_epoch: int = -1) -> None:
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(optimizer, last_epoch)

    def get_lr(self) -> float:
        return self.optimizer.lr * self.gamma ** (self.last_epoch //
                                                  self.step_size)


class MultiStepLR(_LRScheduler):
    """lr <- lr * gamma ** (times the epoch is a milestone)."""

    def __init__(self, optimizer: Optimizer, milestones: List[int],
                 gamma: float = 0.1, last_epoch: int = -1) -> None:
        self.milestones = Counter(milestones)
        self.gamma = gamma
        super().__init__(optimizer, last_epoch)

    def get_lr(self) -> float:
        hits = self.milestones.get(self.last_epoch, 0)
        return self.optimizer.lr * self.gamma ** hits


class CosineAnnealingLR(_LRScheduler):
    """Recursive cosine annealing towards ``eta_min`` over ``T_max``
    epochs, restarting at the (1 + 2k) T_max boundaries."""

    def __init__(self, optimizer: Optimizer, T_max: int, eta_min: float = 0,
                 last_epoch: int = -1) -> None:
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(optimizer, last_epoch)

    def get_lr(self) -> float:
        t, T = self.last_epoch, self.T_max
        base_lr = self.optimizer.initial_lr
        if t == 0:
            return base_lr
        if (t - 1 - T) % (2 * T) == 0:  # restart boundary
            return self.get_last_lr() + (base_lr - self.eta_min) * (
                1 - cos(pi / T)) / 2
        ratio = (1 + cos(pi * t / T)) / (1 + cos(pi * (t - 1) / T))
        return ratio * (self.get_last_lr() - self.eta_min) + self.eta_min
