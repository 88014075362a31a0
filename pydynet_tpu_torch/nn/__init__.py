"""The port's nn surface: the layers (LoRA adapters and the recurrent
layers among them), init, functional ops and gradient clipping: every layer
of ``pydynet_tpu.nn``."""
from . import functional, init, utils
from .modules import *  # noqa: F401,F403
from .modules import __all__ as _modules_all

__all__ = list(_modules_all) + ["functional", "init", "utils"]
