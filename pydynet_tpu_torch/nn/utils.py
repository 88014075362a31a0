"""Gradient clipping (port of ``pydynet_tpu/nn/utils.py``): the
``torch.nn.utils`` contract over ``.grad``, computed with tensor ops on the
gradients' device, so a step that clips never waits for the host."""
from __future__ import annotations

import math

import torch

__all__ = ["clip_grad_norm_", "clip_grad_value_"]


def _with_grads(parameters):
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    return [p for p in parameters if p.grad is not None]


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm: float,
                    norm_type: float = 2.0) -> torch.Tensor:
    """Scale all gradients so that their global norm is at most
    ``max_norm``, with the 1e-6 guard in the denominator; ``norm_type=inf``
    takes the largest magnitude. Parameters without a gradient are skipped.
    Returns the norm before clipping, as a tensor."""
    params = _with_grads(parameters)
    if not params:
        return torch.tensor(0.0)
    max_norm, norm_type = float(max_norm), float(norm_type)
    grads = [p.grad for p in params]
    if math.isinf(norm_type):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = sum(torch.sum(torch.abs(g) ** norm_type) for g in grads) \
            ** (1.0 / norm_type)
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(scale)
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value: float) -> None:
    """Clamp every gradient element to ``[-clip_value, clip_value]``."""
    clip_value = float(clip_value)
    for p in _with_grads(parameters):
        p.grad.clamp_(-clip_value, clip_value)
