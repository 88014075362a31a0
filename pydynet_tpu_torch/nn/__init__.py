"""The port's nn surface: the layers, init, functional ops and gradient
clipping; what of ``pydynet_tpu.nn`` is still to port is in ``ROADMAP.md``
(RNNs, LoRA)."""
from . import functional, init, utils
from .modules import *  # noqa: F401,F403
from .modules import __all__ as _modules_all

__all__ = list(_modules_all) + ["functional", "init", "utils"]
