"""Optimizers and learning-rate schedulers of the training path (port of
``pydynet_tpu/optim``)."""
from . import lr_scheduler
from .lr_scheduler import (CosineAnnealingLR, ExponentialLR, MultiStepLR,
                           StepLR)
from .optimizer import SGD, Adadelta, Adagrad, Adam, AdamW, Optimizer

__all__ = ["Adadelta", "Adagrad", "Adam", "AdamW", "CosineAnnealingLR",
           "ExponentialLR", "MultiStepLR", "Optimizer", "SGD", "StepLR",
           "lr_scheduler"]
