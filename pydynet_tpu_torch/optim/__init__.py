"""Optimizers of the training path (port of ``pydynet_tpu/optim``); SGD,
Adagrad, Adadelta and the schedulers are still to port (``ROADMAP.md``)."""
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["Adam", "AdamW", "Optimizer"]
