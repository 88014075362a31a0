"""The port's nn surface: the layers (LoRA adapters and the recurrent
layers among them), the ``Module`` base and containers, ``Parameter``, init,
functional ops and gradient clipping: every layer of ``pydynet_tpu.nn``."""
from . import functional, init, parameter, utils
from .modules import *  # noqa: F401,F403
from .modules import __all__ as _modules_all
from .parameter import Parameter

__all__ = list(_modules_all) + ["Parameter", "functional", "init",
                                "parameter", "utils"]
