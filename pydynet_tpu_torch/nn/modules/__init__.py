"""The port's layers, each a ``torch.nn.Module`` through the port's
:class:`Module` base. The containers ``Sequential`` and ``ModuleList`` are
torch's on that base: they name their children "0", "1", ... as the JAX
package's containers do, so dotted state-dict names agree."""
from .activation import GELU, LeakyReLU, ReLU, Sigmoid, SiLU, Softmax, Tanh
from .conv import Conv1d, Conv2d
from .dropout import Dropout
from .linear import Embedding, Linear
from .loss import CrossEntropyLoss, Loss, MSELoss, NLLLoss
from .lora import LoRALinear, apply_lora, merge_lora
from .module import Module, ModuleList, Sequential
from .norm import BatchNorm1d, BatchNorm2d, LayerNorm, RMSNorm, rms_norm
from .pool import AvgPool1d, AvgPool2d, MaxPool1d, MaxPool2d
from .rnn import GRU, LSTM, RNN, GRUCell, LSTMCell, RNNCell

__all__ = [
    "Sigmoid", "Tanh", "ReLU", "LeakyReLU", "Softmax", "SiLU", "GELU",
    "BatchNorm1d", "BatchNorm2d", "LayerNorm", "RMSNorm", "rms_norm",
    "Conv1d", "Conv2d",
    "MaxPool1d", "MaxPool2d", "AvgPool1d", "AvgPool2d",
    "Dropout",
    "RNNCell", "LSTMCell", "GRUCell", "RNN", "LSTM", "GRU",
    "Linear", "Embedding",
    "LoRALinear", "apply_lora", "merge_lora",
    "MSELoss", "NLLLoss", "CrossEntropyLoss", "Loss",
    "Module", "Sequential", "ModuleList",
]
