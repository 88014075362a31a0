"""Beam search and prompt-lookup speculative decoding in the port, against
the JAX package on the CPU.

``Llama.generate_beam`` and ``Llama.generate_speculative``
(``models/llama/speculative.py``) run on the scan lane's float weights;
weights come from a seeded JAX model through ``params_from_tpu``. Streams
are float32 and must equal the JAX package's token for token, greedy and
sampled (the threefry key stream of ``random.py``), with the same stats
(``tests/test_llama.py:1261-1540``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import pydynet_tpu as pdn
from pydynet_tpu.models.llama import speculative as jspec
from pydynet_tpu.models.llama.model import Llama as JLlama

from pydynet_tpu_torch import random as prandom
from pydynet_tpu_torch.models.llama import Llama, params_from_tpu
from pydynet_tpu_torch.models.llama import speculative as tspec

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

# tests/test_serve_xla.py's tiny config
CFG = dict(vocab_size=256, embed_dim=32, n_heads=2, ffn_dim=64,
           max_seq_len=64, max_batch_size=2, n_layers=2)
# tests/test_llama.py:1342's speculative config: a small vocabulary whose
# random-weight streams fall into loops, so drafts are accepted
SPEC_CFG = dict(vocab_size=64, embed_dim=32, n_heads=2, ffn_dim=48,
                max_seq_len=96, max_batch_size=1, n_layers=2)
PERIODIC = np.array([[1, 7, 3, 1, 7, 3, 1, 7, 3, 1, 7]])


def models(seed, cfg=CFG):
    np.random.seed(seed)
    jm = JLlama(dtype=np.float32, **cfg)
    jm.eval()
    tm = Llama(**cfg, device="cpu")
    tm.load_state_dict(params_from_tpu(
        {n: p.numpy() for n, p in jm._parameters.items()}), strict=True)
    return jm, tm.eval()


@pytest.fixture(scope="module")
def spec_models():
    return models(21, SPEC_CFG)


def greedy(tm, ids, total):
    return [int(t[0, 0]) for t in tm.generate(ids, total, fused=False)]


@pytest.mark.parametrize("W", [1, 4])
def test_generate_beam_matches_jax(W):
    """``generate_beam`` at W = 1 and 4, with length penalties 1 and 0 and
    an ``eos_id`` that the beams reach (frozen beams, truncation), token
    for token against the JAX package's; W = 1 is the greedy stream."""
    jm, tm = models(1)
    ids = np.array([[1, 5, 9, 4]])
    g = greedy(tm, ids, 30)
    if W == 1:
        assert tm.generate_beam(ids, 30, num_beams=1, eos_id=-1) == g
    for kw in (dict(eos_id=-1), dict(eos_id=-1, length_penalty=0.0),
               dict(eos_id=g[6]), dict(eos_id=g[0])):
        with pdn.no_grad():
            want = jm.generate_beam(ids, 30, num_beams=W, **kw)
        got = tm.generate_beam(ids, 30, num_beams=W, **kw)
        assert got == want, kw
    assert tm.generate_beam(ids, 4, num_beams=W) == []


def test_generate_beam_ties_go_to_the_lower_index():
    """Equal scores keep ``lax.top_k``'s order: a head whose logits are all
    equal makes every step a V-way tie, which the lowest token ids win."""
    _, tm = models(2)
    with torch.no_grad():
        tm.lm_head.weight.zero_()
        tm.lm_head.bias.zero_()
    assert tm.generate_beam(np.array([[3, 4]]), 8, num_beams=3,
                            eos_id=-1) == [0] * 6


@pytest.mark.parametrize("Kg", [(7, 3), (4, 2), (1, 1)])
def test_generate_speculative_greedy_matches_jax(spec_models, Kg):
    """Greedy speculation: the JAX package's stream and stats (iterations,
    accepted drafts, the tail), equal to ``generate(fused=False)``, on a
    periodic, an arbitrary and a unigram-loop prompt."""
    jm, tm = spec_models
    K, g = Kg
    for ids in (PERIODIC, np.array([[9, 41, 5, 60, 2, 33, 17]]),
                np.array([[4, 4, 4, 4]])):
        with pdn.no_grad():
            want, wstats = jm.generate_speculative(ids, 40, draft_k=K,
                                                   ngram=g)
        got, stats = tm.generate_speculative(ids, 40, draft_k=K, ngram=g)
        assert got.dtype == np.int64 and np.array_equal(got, want)
        assert stats == wstats
        assert got.tolist() == greedy(tm, ids, 40)
        assert stats["tokens"] == (1 + stats["iterations"]
                                   + stats["accepted_drafts"]
                                   + stats["tail_tokens"])
    _, stats = tm.generate_speculative(PERIODIC, 80, draft_k=K, ngram=g)
    assert K == 1 or stats["accepted_drafts"] > 0


@pytest.mark.parametrize("kw", [
    dict(temperature=1.0, seed=3),
    dict(temperature=0.7, top_k=8, seed=11),
    dict(temperature=1.3, top_p=0.9, seed=5),
    dict(temperature=0.9, top_k=20, top_p=0.8, seed=0)])
def test_generate_speculative_sampled_matches_jax(spec_models, kw):
    """Speculative sampling: the key stream threaded as the JAX package's
    (the prefill's draw, one split for the loop, the rest for the tail), the
    float64 acceptance draws and the residual draw give the JAX package's
    stream and stats."""
    jm, tm = spec_models
    for ids, total in ((PERIODIC, 60), (np.array([[4, 4, 4, 4]]), 30)):
        with pdn.no_grad():
            want, wstats = jm.generate_speculative(ids, total, draft_k=4,
                                                   ngram=2, **kw)
        got, stats = tm.generate_speculative(ids, total, draft_k=4, ngram=2,
                                             **kw)
        assert np.array_equal(got, want) and stats == wstats, (kw, ids)


def test_speculative_top_k1_is_greedy_and_short_requests(spec_models):
    """``top_k=1`` makes every draw the argmax: the greedy stream at any
    temperature; a total at or below the prompt yields nothing."""
    _, tm = spec_models
    ids = np.array([[1, 5, 9, 5, 9, 5, 9]])
    toks, stats = tm.generate_speculative(ids, 30, draft_k=4, ngram=2,
                                          temperature=5.0, top_k=1, seed=11)
    assert toks.tolist() == greedy(tm, ids, 30) and stats["tokens"] == 23
    toks, stats = tm.generate_speculative(ids, 7)
    assert toks.shape == (0,) and stats["tokens"] == 0


def test_lookup_draft_matches_jax():
    """The drafting rule on random buffers with heavy repeats, the gram's
    and the draft's starts clamped into the buffer, against the JAX
    package's ``lookup_draft``."""
    rng = np.random.default_rng(3)
    S = 64
    for trial in range(12):
        seq = rng.integers(0, 5, size=S).astype(np.int32)
        tseq = torch.from_numpy(seq.astype(np.int64))
        for g, K in ((3, 7), (2, 4), (1, 2), (5, 3)):
            for n in (1, g + 1, 9, 17, 40, S - K - 1, S - 1):
                want = np.asarray(jspec.lookup_draft(jnp.asarray(seq),
                                                     jnp.int32(n), K, g))
                got = tspec.lookup_draft(tseq, n, K, g).numpy()
                assert np.array_equal(got, want), (trial, g, K, n)


def test_spec_accept_extra_matches_jax():
    """One acceptance step on random logits, drafts that are accepted now
    and then and keys in turn: the same tokens and accepted count as the
    JAX package's ``spec_accept_extra``, with and without filters."""
    from pydynet_tpu.models.llama.model import filter_logits as jfilter

    rng = np.random.default_rng(0)
    V, K = 11, 3
    logits = rng.standard_normal((K + 1, V)).astype(np.float32) * 2.0
    draft = np.argmax(logits[:K], -1).astype(np.int64)
    draft[1] = 4  # one draft off the argmax: rejections too
    tl, td = torch.from_numpy(logits), torch.from_numpy(draft)
    seen = set()
    for temperature, top_k, top_p in ((1.3, None, 0.9), (0.8, 5, None),
                                      (1.0, None, None)):
        f = jfilter(jnp.asarray(logits), jnp.float32(temperature), top_k,
                    top_p)
        assert np.isfinite(np.asarray(f)).any()
        t = torch.tensor(temperature, dtype=torch.float32)
        for seed in range(40):
            key = jax.random.PRNGKey(seed)
            want, wa = jspec.spec_accept_extra(
                jnp.asarray(logits), jnp.asarray(draft, jnp.int32), key,
                jnp.float32(temperature), top_k, top_p)
            got, a = tspec.spec_accept_extra(tl, td, prandom.PRNGKey(seed),
                                             t, top_k, top_p)
            assert int(a) == int(wa)
            assert got.tolist() == np.asarray(want).tolist(), seed
            seen.add(int(a))
    assert len(seen) > 1  # accepted and rejected drafts both came up


def test_forward_all_positions_matches_jax():
    """``forward_logits_one(all_positions=True)``: (B, L, V) float32 logits
    at every position, within float32 rounding of the JAX package's, its
    last row the default return's."""
    jm, tm = models(4)
    ids = np.array([[1, 5, 9, 4, 7], [2, 7, 3, 3, 8]])
    w = tm._weights(None)
    ck, cv = tm._empty_caches(2, torch.float32)
    tok = torch.as_tensor(ids)
    got = tm.forward_logits_one(w, ck, cv, tok, 0, all_positions=True)
    jm._decode_fns = jm._decode_fns or jm._make_decode_fns()
    with pdn.no_grad():
        jck, jcv = jm._empty_caches(2, jnp.float32)
        want, _, _ = jm._xla_forward_logits_all(
            jm._weights(None), jck, jcv, jnp.asarray(ids, jnp.int32), 0)
    assert got.shape == (2, 5, 256) and got.dtype == torch.float32
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-4
    ck, cv = tm._empty_caches(2, torch.float32)
    assert torch.equal(got[:, -1], tm.forward_logits_one(w, ck, cv, tok, 0))


@pytest.mark.parametrize("flags", [["--beams", "2"],
                                   ["--speculative", "--draft-k", "3",
                                    "--ngram", "2"]])
def test_infer_beams_and_speculative_like_jax(tmp_path, capsys, flags):
    """``infer --beams`` and ``--speculative`` print the JAX package's CLI's
    text on the same weights (every parameter loaded with ``--finetuned``,
    the head's bias keeping the tokens in the byte range), and its summary
    line's note."""
    from llm.llama import infer as jinfer
    from pydynet_tpu_torch.models.llama import infer, params_to_tpu

    src = Llama(infer.VOCAB_SIZE, infer.DIM, infer.N_HEADS, infer.FFN_DIM,
                infer.MAX_SEQ_LEN, infer.MAX_BATCH, infer.N_LAYERS,
                device="cpu", generator=torch.Generator().manual_seed(16))
    params = params_to_tpu(dict(src.named_parameters()))
    params["lm_head.bias"][259:] = -100.0
    full = tmp_path / "full.npz"
    np.savez(full, **params)
    common = ["--no-warmup", "--random-init", "--max-new-tokens", "10",
              "--prompt", "", "--finetuned", str(full)] + flags
    capsys.readouterr()
    with pdn.no_grad():
        jinfer.main(common + ["--no-cuda"])
    jout = capsys.readouterr().out
    assert infer.main(common + ["--device", "cpu"]) > 0
    out = capsys.readouterr().out
    note = "beam=2" if "--beams" in flags else "drafts accepted"
    assert note in out and note in jout
    text = [o.split("Token count")[0].strip().splitlines()[-1]
            for o in (out, jout)]
    assert text[0] == text[1] != ""
