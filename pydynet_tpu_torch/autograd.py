"""Global gradient-mode switch (counterpart of ``pydynet_tpu/autograd.py``).

A process-global boolean gates whether the tape (``core/tensor.py``) records
nodes; ``no_grad``/``enable_grad`` work both as context managers and as
decorators. The switch also sets PyTorch's own grad mode, so code that runs
``torch.nn`` modules under the port's ``no_grad`` (the package exported
``torch.no_grad`` under that name before the tape was ported) keeps working.
"""
import functools

import torch

_grad_enabled = True


def is_grad_enable() -> bool:
    return _grad_enabled


def set_grad_enabled(mode: bool) -> None:
    global _grad_enabled
    _grad_enabled = bool(mode)
    torch.set_grad_enabled(_grad_enabled)


class _GradMode:
    _mode: bool = True

    def __enter__(self) -> None:
        self._prev = (is_grad_enable(), torch.is_grad_enabled())
        set_grad_enabled(self._mode)

    def __exit__(self, exc_type, exc_value, traceback) -> None:
        global _grad_enabled
        _grad_enabled = self._prev[0]
        torch.set_grad_enabled(self._prev[1])

    def __call__(self, func):
        @functools.wraps(func)
        def decorate_context(*args, **kwargs):
            with self.__class__():
                return func(*args, **kwargs)

        return decorate_context


class no_grad(_GradMode):
    _mode = False


class enable_grad(_GradMode):
    _mode = True
