"""The nn surface the Llama slice needs; the rest of ``pydynet_tpu.nn``
is still to port (``ROADMAP.md``)."""
from .modules import RMSNorm, rms_norm

__all__ = ["RMSNorm", "rms_norm"]
