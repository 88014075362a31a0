"""The reference's ``pydynet.cuda`` module (counterpart of
``pydynet_tpu/cuda.py``): ``is_available()``, ``device_count()`` and the
current card, so scripts that probe ``cuda`` run unchanged."""
from .device import (Device, current_device, device_count, is_available,
                     set_device)

__all__ = [
    "Device", "is_available", "device_count", "current_device", "set_device"
]
