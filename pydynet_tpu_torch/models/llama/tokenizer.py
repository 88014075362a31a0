"""SentencePiece-style BPE tokenizer over a JSON vocab ({"tokens","scores"}).

Behavior parity with PyDyNet's ``llm/llama/tokenizer.py`` (greedy
best-score pair merging, bos=1/eos=2, <s>/</s> stripping on decode), but
lookups use a hash map instead of the reference's O(V) list.index scan, so
encoding is O(n^2) instead of O(n^2 * V).

When the vocab file is missing, a byte-level fallback vocab is synthesized
so CLIs and benchmarks still run end to end.

A copy of ``pydynet_tpu/models/llama/tokenizer.py``: the merge runs in the
port's C++ engine (``pydynet_tpu_torch/native/``, built with g++ at first
use) where it builds, else in the pure-Python loop below, with the same
tokens.
"""
import json
import os
from typing import List


class Tokenizer:

    def __init__(self, model_path: str = None):
        if model_path is not None and os.path.exists(model_path):
            with open(model_path, "r", encoding="utf-8") as f:
                model = json.load(f)
            self.vocab: List[str] = model["tokens"]
            self.scores: List[float] = model["scores"]
        else:
            # byte-level fallback: specials + 256 single-byte tokens
            self.vocab = ["<unk>", "<s>", "</s>"] + [chr(i)
                                                     for i in range(256)]
            self.scores = [0.0] * len(self.vocab)
        self.bos_id = 1
        self.eos_id = 2
        self._index = {}
        for i, tok in enumerate(self.vocab):
            # first occurrence wins, matching list.index semantics
            self._index.setdefault(tok, i)
        # the native merge engine; None -> the pure-Python loop below
        from ...native import NativeVocab
        self._native = NativeVocab.create(self.vocab, self.scores)

    def str_lookup(self, token: str) -> int:
        return self._index.get(token, -1)

    def encode(self, text: str, add_bos: bool = True,
               add_eos: bool = False) -> List[int]:
        if self._native is not None:
            tokens = self._native.encode(text)
            if add_bos:
                tokens.insert(0, self.bos_id)
            if add_eos:
                tokens.append(self.eos_id)
            return tokens

        tokens = []
        for char in text:
            idx = self.str_lookup(char)
            if idx >= 0:
                tokens.append(idx)

        # greedy merge: repeatedly fuse the adjacent pair whose merged token
        # has the best score
        while True:
            best_score, best_id, best_idx = -1e10, -1, -1
            for i in range(len(tokens) - 1):
                merged = self.vocab[tokens[i]] + self.vocab[tokens[i + 1]]
                idx = self.str_lookup(merged)
                if idx != -1 and self.scores[idx] > best_score:
                    best_score, best_id, best_idx = self.scores[idx], idx, i
            if best_idx == -1:
                break
            tokens[best_idx:best_idx + 2] = [best_id]

        if add_bos:
            tokens.insert(0, self.bos_id)
        if add_eos:
            tokens.append(self.eos_id)
        return tokens

    def decode(self, ids: List[int]) -> str:
        # out-of-vocab ids (possible under the byte-level fallback vocab,
        # where the model's 32k ids exceed the synthesized table) decode to ''
        text = "".join(self.vocab[i] if 0 <= i < len(self.vocab) else ""
                       for i in ids)
        # remove the literal bos/eos markers.  Deliberate fix vs the
        # reference (tokenizer.py:65): str.strip("<s>") strips the CHARACTER
        # SET {'<','s','>'}, so e.g. "snakes" decoded to "nake"
        for marker in ("<s>", "</s>"):
            while text.startswith(marker):
                text = text[len(marker):]
            while text.endswith(marker):
                text = text[:-len(marker)]
        return text
