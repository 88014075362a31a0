"""The port's C++ merge engine (``pydynet_tpu_torch/native/``) against the
JAX package's ``NativeVocab`` and the pure-Python merge, on the cases of
``tests/test_native.py``. g++ builds it here; no GPU is involved."""
import json

import numpy as np
import pytest
import torch

from pydynet_tpu.models.llama.tokenizer import Tokenizer as JTokenizer
from pydynet_tpu.native import NativeVocab as JNativeVocab

from pydynet_tpu_torch import native
from pydynet_tpu_torch.models.llama.tokenizer import Tokenizer

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

VOCAB = {
    "tokens": ["<unk>", "<s>", "</s>", "a", "b", "c", "ab", "abc", "bc",
               "ca"],
    "scores": [0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 5.0, 9.0, 6.0, 4.0],
}
TEXTS = ["abc", "cab", "aabbcc", "abcabcabc", "xyz abc", "", "a", "ccabba"]


def python_ids(tok, text, **kw):
    tok._native, saved = None, tok._native
    try:
        return tok.encode(text, **kw)
    finally:
        tok._native = saved


@pytest.fixture
def vocab_path(tmp_path):
    path = str(tmp_path / "tok.json")
    with open(path, "w") as f:
        json.dump(VOCAB, f)
    return path


def test_builds_here_and_is_keyed_by_the_source():
    assert native.native_available()
    lib = native.build.library_path("tokenizer")
    assert lib.parent == native.build.BUILD_DIR and lib.exists()
    assert lib.name.startswith("libtokenizer_")


@pytest.mark.parametrize("text", TEXTS)
def test_merge_matches_jax_and_python(vocab_path, text):
    tok, jtok = Tokenizer(vocab_path), JTokenizer(vocab_path)
    assert tok._native is not None
    jv = JNativeVocab.create(VOCAB["tokens"], VOCAB["scores"])
    got = tok.encode(text, add_bos=False)
    assert got == jv.encode(text) == python_ids(tok, text, add_bos=False)
    assert got == jtok.encode(text, add_bos=False)


@pytest.mark.parametrize("flags", [dict(add_bos=True, add_eos=True),
                                   dict(add_bos=False)])
def test_unicode_and_flags_match_jax(flags):
    tok, jtok = Tokenizer(None), JTokenizer(None)
    ids = tok.encode("héllo wörld", **flags)
    assert ids == jtok.encode("héllo wörld", **flags)
    assert ids == python_ids(tok, "héllo wörld", **flags)


def test_long_text_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    base = [chr(97 + i) for i in range(26)]
    merges = ["".join(rng.choice(base, 2)) for _ in range(400)]
    merges += ["".join(rng.choice(base, 3)) for _ in range(400)]
    tokens = ["<unk>", "<s>", "</s>"] + base + merges
    scores = [0.0] * 3 + [1.0] * 26 + rng.uniform(2, 10, len(merges)).tolist()
    path = str(tmp_path / "tok.json")
    with open(path, "w") as f:
        json.dump({"tokens": tokens, "scores": scores}, f)
    tok = Tokenizer(path)
    text = "".join(rng.choice(base, 600))
    got = tok.encode(text, add_bos=False)
    assert got == JNativeVocab.create(tokens, scores).encode(text)
    assert got == python_ids(tok, text, add_bos=False)


def test_no_compiler_means_the_python_merge(vocab_path, monkeypatch):
    """Without a compiler the tokenizer keeps the JAX package's contract:
    the pure-Python merge runs, with the same tokens."""
    monkeypatch.setattr(native.build, "_CACHE", {})
    monkeypatch.setattr(native.build, "library_path",
                        lambda name: native.build.BUILD_DIR / "missing.so")
    monkeypatch.setattr(native.build, "_compile", lambda name, lib: False)
    tok = Tokenizer(vocab_path)
    assert tok._native is None
    for text in TEXTS:
        assert tok.encode(text) == JTokenizer(vocab_path).encode(text)
