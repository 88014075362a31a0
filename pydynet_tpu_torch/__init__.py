"""pydynet_tpu_torch: the PyTorch / CUDA port of ``pydynet_tpu``.

It keeps the JAX package's module tree and names, computes in PyTorch, and
replaces each Pallas TPU kernel with a kernel written by hand for NVIDIA
Hopper (sm_90a). The JAX package stays the reference it is tested against.
This package never imports JAX.
"""
from torch import no_grad

from .device import device_count, is_available, resolve
from .random import default_generator, manual_seed

__all__ = ["default_generator", "device_count", "is_available",
           "manual_seed", "no_grad", "resolve"]

__version__ = "0.1.0"
