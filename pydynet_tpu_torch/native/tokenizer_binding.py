"""ctypes binding for the C++ tokenizer engine (``tokenizer.cpp``; the JAX
package's ``native/tokenizer_binding.py``)."""
from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from .build import load_library


class NativeVocab:
    """Greedy best-score merge encoder over a (tokens, scores) vocab.

    Same semantics as the Python loop in ``models/llama/tokenizer.py``,
    much faster on long prompts. Construct via :meth:`create` (None when
    the native library is unavailable).
    """

    def __init__(self, lib, handle) -> None:
        self._lib = lib
        self._handle = handle

    @classmethod
    def create(cls, tokens: List[str], scores: List[float]) \
            -> Optional["NativeVocab"]:
        lib = load_library("tokenizer")
        if lib is None:
            return None
        lib.pdt_vocab_create.restype = ctypes.c_void_p
        lib.pdt_vocab_create.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
        ]
        lib.pdt_encode.restype = ctypes.c_int64
        lib.pdt_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64
        ]
        lib.pdt_vocab_free.argtypes = [ctypes.c_void_p]

        encoded = [t.encode("utf-8") for t in tokens]
        blob = b"".join(encoded)
        offsets = np.zeros(len(encoded) + 1, np.int64)
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        scores_arr = np.asarray(scores, np.float32)

        handle = lib.pdt_vocab_create(
            blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(encoded),
            scores_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if not handle:
            return None
        return cls(lib, handle)

    def encode(self, text: str) -> List[int]:
        data = text.encode("utf-8")
        cap = max(16, len(data) + 8)
        out = np.empty(cap, np.int32)
        n = self._lib.pdt_encode(
            self._handle, data, len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        if n < 0:
            raise RuntimeError("native tokenizer output overflow")
        return out[:n].tolist()

    def __del__(self):
        try:
            if self._handle:
                self._lib.pdt_vocab_free(self._handle)
        except Exception:
            pass
