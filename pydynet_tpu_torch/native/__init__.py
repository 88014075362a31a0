"""Native (C++) host components, bound with ctypes (counterpart of
``pydynet_tpu/native``).

Built with g++ at first use into ``build/pydynet_tpu_torch/`` at the root of
the checkout, named by a hash of the source. Every consumer keeps a
pure-Python fallback, so the package works without a compiler: the native
engine is a speed tier of a host component, not a kernel.
"""
from .build import load_library, native_available
from .tokenizer_binding import NativeVocab

__all__ = ["NativeVocab", "load_library", "native_available"]
