"""The port's ``Module`` base and containers (counterpart of
``pydynet_tpu/nn/modules/module.py``).

Every port layer is a ``torch.nn.Module`` through :class:`Module`, which adds
the JAX package's names the torch base lacks: ``move(device)``,
``set_module_state(mode)`` and ``to(Device)``. Parameters and buffers keep
torch's registration, so dotted ``state_dict`` names are unchanged.
``train(mode)`` is torch's: unlike the reference's it does not flip the
global grad switch (a deliberate difference, ROADMAP.md item 16).
``Sequential`` and ``ModuleList`` are torch's containers on this base; they
name their children "0", "1", ... as the JAX package's do.
"""
import torch

from ...device import Device


def _torch_device(device):
    if isinstance(device, Device):
        return device.torch_device
    if isinstance(device, (int, str)) and not isinstance(device, bool) \
            and (isinstance(device, int)
                 or device.partition(":")[0] in ("gpu", "tpu")):
        return Device(device).torch_device
    return device


class Module(torch.nn.Module):

    def move(self, device) -> None:
        """Move every parameter and buffer to ``device`` (a ``Device``,
        ``"cpu"``, ``"cuda[:N]"``, ``"gpu"``, ``"tpu"`` or an index) in
        place: the Parameter objects stay the same."""
        super().to(_torch_device(device))

    def set_module_state(self, mode: bool) -> None:
        """Set the training flag of this module and every module below it,
        without touching the grad switch."""
        for module in self.modules():
            module.training = bool(mode)

    def to(self, *args, **kwargs):
        """torch's ``to``, which also takes a ``Device`` or the JAX
        package's device names."""
        if args:
            args = (_torch_device(args[0]),) + args[1:]
        if "device" in kwargs:
            kwargs["device"] = _torch_device(kwargs["device"])
        return super().to(*args, **kwargs)


class Sequential(Module, torch.nn.Sequential):
    pass


class ModuleList(Module, torch.nn.ModuleList):
    pass
