"""The port's layers. Containers are PyTorch's own: ``torch.nn.Sequential``
and ``torch.nn.ModuleList`` name their children "0", "1", ... as the JAX
package's containers do, so dotted state-dict names agree."""
from .activation import GELU, LeakyReLU, ReLU, Sigmoid, SiLU, Softmax, Tanh
from .conv import Conv1d, Conv2d
from .dropout import Dropout
from .linear import Embedding, Linear
from .loss import CrossEntropyLoss, Loss, MSELoss, NLLLoss
from .norm import BatchNorm1d, BatchNorm2d, LayerNorm, RMSNorm, rms_norm
from .pool import AvgPool1d, AvgPool2d, MaxPool1d, MaxPool2d

__all__ = [
    "Sigmoid", "Tanh", "ReLU", "LeakyReLU", "Softmax", "SiLU", "GELU",
    "BatchNorm1d", "BatchNorm2d", "LayerNorm", "RMSNorm", "rms_norm",
    "Conv1d", "Conv2d",
    "MaxPool1d", "MaxPool2d", "AvgPool1d", "AvgPool2d",
    "Dropout",
    "Linear", "Embedding",
    "MSELoss", "NLLLoss", "CrossEntropyLoss", "Loss",
]
