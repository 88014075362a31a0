from .norm import RMSNorm, rms_norm

__all__ = ["RMSNorm", "rms_norm"]
