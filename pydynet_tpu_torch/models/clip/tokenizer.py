"""OpenAI CLIP BPE tokenizer (a copy of ``pydynet_tpu/models/clip/
tokenizer.py``, which imports no JAX).

Byte<->unicode tables, lowest-rank pair merges, ``</w>`` end-of-word markers
and CLIP's text-splitting pattern, through the ``regex`` module's ``\\p``
classes when it is installed and an ASCII ``re`` pattern when it is not.
``ftfy`` is optional; without it the cleanup is ``html.unescape`` twice.

When the merges file (``bpe_simple_vocab_16e6.txt.gz``, beside this module
in ``data/``) is missing, a byte-level fallback vocab is built with the
start and end tokens at CLIP's ids 49406 and 49407, so the CLIP CLIs run
without it and the end token stays the highest id (the text encoder pools
the position of the largest id).
"""
from __future__ import annotations

import gzip
import html
import os
from functools import lru_cache

try:
    import regex as re
    _PAT = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""", re.IGNORECASE)
except ImportError:
    import re
    _PAT = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+""", re.IGNORECASE)


@lru_cache()
def default_bpe() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data/bpe_simple_vocab_16e6.txt.gz")


@lru_cache()
def bytes_to_unicode():
    """Reversible byte -> printable-unicode mapping (BPE works on strings)."""
    byte_ints = (list(range(ord("!"), ord("~") + 1)) +
                 list(range(ord("\xa1"), ord("\xac") + 1)) +
                 list(range(ord("\xae"), ord("\xff") + 1)))
    char_ints = byte_ints[:]
    n = 0
    for b in range(2**8):
        if b not in byte_ints:
            byte_ints.append(b)
            char_ints.append(2**8 + n)
            n += 1
    return dict(zip(byte_ints, [chr(c) for c in char_ints]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    try:
        import ftfy
        text = ftfy.fix_text(text)
    except ImportError:
        pass
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    import re as _re
    return _re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:

    def __init__(self, bpe_path: str = None) -> None:
        if bpe_path is None:
            bpe_path = default_bpe()
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]

        if os.path.exists(bpe_path):
            with gzip.open(bpe_path) as f:
                merges = f.read().decode("utf-8").split("\n")
            merges = merges[1:49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in merges]
            for merge in merges:
                vocab.append("".join(merge))
        else:
            merges = []

        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        # specials at CLIP's positions: with the merges file the running
        # length is exactly 49406; the offline byte-level fallback pins
        # them there explicitly so the id space matches the documented
        # 49408 contract (model.py pools the eot position by argmax of
        # ids, which relies on eot being the HIGHEST id)
        sot = len(vocab) if merges else 49406
        self.encoder["<|startoftext|>"] = sot
        self.encoder["<|endoftext|>"] = sot + 1
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"

        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)

        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str):
        bpe_tokens = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in _PAT.findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t]
                              for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens) -> str:
        # ids with no vocab entry (possible under the offline fallback's
        # sparse 49408-id space) decode to "" like the llama fallback
        text = "".join(self.decoder.get(int(t), "") for t in tokens)
        data = bytearray(self.byte_decoder[c] for c in text
                         if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace").replace("</w>", " ")
