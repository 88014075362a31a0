"""Device resolution for the PyTorch port (counterpart of
``pydynet_tpu/device.py`` and ``cuda.py``).

``"cuda"``/``"cuda:N"`` resolves to an NVIDIA GPU, and so does no device at
all: the port runs on the card unless the caller asks for ``"cpu"``. Asking
for a GPU where PyTorch sees none raises: nothing in the port falls back to
the CPU on its own.
"""
from __future__ import annotations

import torch


def is_available() -> bool:
    """True when PyTorch sees a real CUDA device."""
    return torch.cuda.is_available()


def device_count() -> int:
    return torch.cuda.device_count() if is_available() else 0


def resolve(device=None) -> torch.device:
    """``None``/``"cpu"``/``"cuda[:N]"``/``torch.device`` -> ``torch.device``;
    ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` for a CUDA device when no GPU is present, and
    ``ValueError`` for any other device type."""
    name = "cuda" if device is None else device
    if str(name).partition(":")[0] not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}: use 'cpu' or "
                         "'cuda'")
    dev = torch.device(name)
    if dev.type == "cpu":
        return dev
    if not is_available():
        raise RuntimeError(f"device {str(name)!r} requested but no CUDA GPU "
                           "is available")
    index = 0 if dev.index is None else dev.index
    if index >= device_count():
        raise RuntimeError(f"bad CUDA device index {index}: only "
                           f"{device_count()} GPU(s) available")
    return torch.device("cuda", index)
