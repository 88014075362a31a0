"""Devices of the PyTorch port (counterpart of ``pydynet_tpu/device.py``).

:func:`resolve` is how the port's models and trainers pick their device:
``"cuda"``/``"cuda:N"`` resolves to an NVIDIA GPU, and so does no device at
all: they run on the card unless the caller asks for ``"cpu"``. Asking for a
GPU where PyTorch sees none raises: nothing in the port falls back to the
CPU on its own.

:class:`Device` is the JAX package's handle of one device, the ``device`` of
a tape ``Tensor`` (``core/tensor.py``): ``Device(None)`` and ``"cpu"`` are
the host, ``"cuda"``, ``"gpu"`` and ``"tpu"`` (optionally ``:N``) or an int
the N-th card, so the reference's device strings keep working. Equality
ignores the index, ``with device:`` does nothing, and a card asked for where
none exists, or an index past the last card, raises.
"""
from __future__ import annotations

import torch


def is_available() -> bool:
    """True when PyTorch sees a real CUDA device."""
    return torch.cuda.is_available()


def device_count() -> int:
    return torch.cuda.device_count() if is_available() else 0


_ACCEL_ALIASES = ("cuda", "gpu", "tpu")
_current_accel_index = 0


def current_device() -> int:
    return _current_accel_index


def set_device(device: int) -> None:
    """The card :meth:`Module.cuda` and ``Tensor.cuda()`` use."""
    global _current_accel_index
    if not is_available():
        raise RuntimeError("No accelerator device is available.")
    if not 0 <= device < device_count():
        raise ValueError(f"Bad device index {device}")
    _current_accel_index = device


class Device:
    """String/int-addressable handle for the host or one card (the JAX
    package's ``Device``, over ``torch.device``)."""

    __slots__ = ("kind", "device_id")

    def __init__(self, device=None) -> None:
        if device is None:
            self.kind, self.device_id = "cpu", None
        elif isinstance(device, Device):
            self.kind, self.device_id = device.kind, device.device_id
        elif isinstance(device, bool):
            raise ValueError(f'Unknown device "{device}"!')
        elif isinstance(device, int):
            self.kind, self.device_id = "accel", device
        elif isinstance(device, torch.device):
            if device.type == "cpu":
                self.kind, self.device_id = "cpu", None
            elif device.type == "cuda":
                self.kind = "accel"
                self.device_id = 0 if device.index is None else device.index
            else:
                raise ValueError(f'Unknown device "{device}"!')
        elif isinstance(device, str):
            name, _, idx = device.partition(":")
            if name == "cpu":
                self.kind, self.device_id = "cpu", None
            elif name in _ACCEL_ALIASES:
                self.kind = "accel"
                if idx == "":
                    self.device_id = 0
                elif idx.isdigit():
                    self.device_id = int(idx)
                else:
                    raise ValueError(f'Wrong device id "{idx}"!')
            else:
                raise ValueError(f'Unknown device "{device}"!')
        else:
            raise ValueError(f'Unknown device "{device}"!')

        if self.kind == "accel" and not is_available():
            raise RuntimeError(
                "Accelerator device is not available on this system.")

    @property
    def torch_device(self) -> torch.device:
        if self.kind == "cpu":
            return torch.device("cpu")
        if self.device_id >= device_count():
            raise RuntimeError(
                f"Bad device index {self.device_id}: only {device_count()} "
                "accelerator device(s) available")
        return torch.device("cuda", self.device_id)

    @property
    def device(self):  # the reference's attribute
        return "cpu" if self.kind == "cpu" else self.torch_device

    @property
    def xp(self):
        """The array namespace: ``numpy`` on the host, ``torch`` on the
        card."""
        if self.kind == "cpu":
            import numpy
            return numpy
        return torch

    def __repr__(self) -> str:
        if self.kind == "cpu":
            return "Device(type='cpu')"
        return "Device(type='cuda', index={})".format(self.device_id)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Device):
            other = Device(other)
        return self.kind == other.kind

    def __hash__(self):
        return hash(self.kind)

    # the reference enters the CuPy device context here; placement is
    # explicit per tensor, so this is a no-op kept for source compatibility
    # (``with x.device: x.data -= lr * x.grad``)
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        return None


def resolve(device=None) -> torch.device:
    """``None``/``"cpu"``/``"cuda[:N]"``/``torch.device``/:class:`Device` ->
    ``torch.device``; ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` for a CUDA device when no GPU is present, and
    ``ValueError`` for any other device type."""
    if isinstance(device, Device):
        return device.torch_device
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
