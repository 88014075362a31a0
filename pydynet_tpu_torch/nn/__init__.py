"""The nn surface the Llama slice needs; the rest of ``pydynet_tpu.nn``
is still to port (``ROADMAP.md``)."""
from . import functional, utils
from .modules import CrossEntropyLoss, Loss, RMSNorm, rms_norm

__all__ = ["CrossEntropyLoss", "Loss", "RMSNorm", "functional", "rms_norm",
           "utils"]
