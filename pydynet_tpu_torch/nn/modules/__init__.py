from .loss import CrossEntropyLoss, Loss
from .norm import RMSNorm, rms_norm

__all__ = ["CrossEntropyLoss", "Loss", "RMSNorm", "rms_norm"]
