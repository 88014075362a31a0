"""The port's sampled decode against the JAX package's, on the CPU:
``generate(temperature > 0)`` on the scan lane and on the fused lane (the
JAX package's decode kernels in interpret mode, the port's through their
plain versions: the tensors are on the CPU), the sampled ``LlamaServer`` on
both lanes, the logits and sampled gates and the CLIs' sampling flags.

Weights come from a seeded JAX model and reach the port through
``params_from_tpu``. Both sides draw from the same threefry key stream; the
Gumbel transform's float32 ``log`` differs by ulps between the frameworks,
so a draw is held equal where its top two perturbed scores are at least
1e-5 apart: a stream is compared up to its first draw below that gap,
which must lie past half the stream. A server run has no such draw
(asserted), so its streams must be equal.
"""
import functools

import numpy as np
import pytest
import torch

import pydynet_tpu as pdn
from pydynet_tpu.models.llama.model import Llama as JLlama
from pydynet_tpu.models.llama.serve import LlamaServer as JServer
from pydynet_tpu.ops import decode_step as jdsk
from pydynet_tpu.utils import fidelity as jfid

from pydynet_tpu_torch import random as prandom
from pydynet_tpu_torch.models.llama import Llama, params_from_tpu
from pydynet_tpu_torch.models.llama.serve import LlamaServer
from pydynet_tpu_torch.ops import decode_step as tdsk
from pydynet_tpu_torch.utils import fidelity as tfid

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

NEAR_TIE = 1e-5
# tests/test_llama.py's sampling config (generate), tests/test_serve.py's
# (the server)
TINY = dict(vocab_size=256, embed_dim=32, n_heads=2, ffn_dim=64,
            max_seq_len=32, max_batch_size=3, n_layers=2)
SERVE_CFG = dict(TINY, max_seq_len=64, max_batch_size=2)
FULL = dict(temperature=1.3, top_k=17, top_p=0.95, seed=11,
            repetition_penalty=1.2)


def models(seed, cfg=TINY):
    """A seeded JAX model and its port, with the same weights."""
    np.random.seed(seed)
    jm = JLlama(dtype=np.float32, **cfg)
    jm.eval()
    tm = Llama(**cfg, device="cpu")
    tm.load_state_dict(params_from_tpu(
        {n: p.numpy() for n, p in jm._parameters.items()}), strict=True)
    return jm, tm.eval()


@pytest.fixture
def gaps(monkeypatch):
    """Each port draw's per-row gap between its two largest perturbed
    scores, in draw order."""
    rec = []
    real = prandom.categorical

    def spy(key, logits):
        shape = (tuple(logits.shape) if key.dim() == 1
                 else tuple(logits.shape[1:]))
        top2 = (prandom.gumbel(key, shape) + logits).topk(2, -1).values
        rec.append((top2[..., 0] - top2[..., 1]).reshape(-1).numpy())
        return real(key, logits)

    monkeypatch.setattr(prandom, "categorical", spy)
    return rec


@pytest.fixture
def interp(monkeypatch):
    """The JAX package's decode kernels in interpret mode."""
    for name in ("fused_decode_token", "fused_decode_token_batched"):
        monkeypatch.setattr(jdsk, name, functools.partial(
            getattr(jdsk, name), interpret=True))


@pytest.fixture
def step_calls(monkeypatch):
    """The port's decode-step wrapper calls: (B, emit_logits) each."""
    calls = []
    for name in ("fused_decode_token", "fused_decode_token_batched"):
        real = getattr(tdsk, name)

        def spy(*args, _real=real, **kwargs):
            calls.append((args[1].shape[0],
                          bool(kwargs.get("emit_logits", False))))
            return _real(*args, **kwargs)

        monkeypatch.setattr(tdsk, name, spy)
    return calls


def rows(gen):
    """A generate stream as a (T, B) array."""
    return np.concatenate([t.numpy() for t in gen], axis=1).T


def assert_equal_to_near_tie(got, want, draw_gaps):
    """Each row equal up to its first draw whose perturbed top-2 gap is
    below NEAR_TIE, which lies past half the stream."""
    assert got.shape == want.shape
    g = np.stack(draw_gaps)  # (T, B), one draw a token
    assert g.shape == got.shape
    for b in range(got.shape[1]):
        near = np.nonzero(g[:, b] < NEAR_TIE)[0]
        cut = int(near[0]) if len(near) else got.shape[0]
        assert cut > got.shape[0] // 2, (b, cut)
        assert np.array_equal(got[:cut, b], want[:cut, b]), (b, got, want)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("kw", [FULL, dict(temperature=0.9, top_k=40,
                                           seed=3)],
                         ids=["all-filters", "top-k"])
def test_sampled_generate_scan_lane_matches_jax(B, kw, gaps):
    jm, tm = models(7)
    ids = np.array([[1, 5, 9], [2, 7, 3], [30, 20, 10]])[:B]
    with pdn.no_grad():
        want = rows(jm.generate(ids, 20, chunk=6, fused=False, **kw))
    got = rows(tm.generate(ids, 20, chunk=6, fused=False, **kw))
    assert got.shape == (17, B)
    assert_equal_to_near_tie(got, want, gaps)


@pytest.mark.parametrize("B", [1, 3])
def test_sampled_generate_fused_lane_matches_jax(B, interp, gaps,
                                                 step_calls):
    """K1 (B=1) and K2 (B=3) in emit_logits mode, once a decode step; the
    argmax mode is never called."""
    jm, tm = models(8)
    ids = np.array([[1, 5, 9], [2, 7, 3], [30, 20, 10]])[:B]
    with pdn.no_grad():
        want = rows(jm.generate(ids, 20, chunk=6, fused=True, **FULL))
    # fused=True: at B=1 fused=None takes the NumPy lane on the CPU
    got = rows(tm.generate(ids, 20, chunk=6, fused=True, **FULL))
    assert_equal_to_near_tie(got, want, gaps)
    assert step_calls == [(B, True)] * (20 - 3 - 1)


def test_sampled_generate_int8_head_is_deterministic(step_calls):
    """int8-head composes with sampling: the same seed gives the same
    stream twice, through K1's emit mode."""
    _, tm = models(8)
    ids = np.array([[1, 5, 9]])
    kw = dict(FULL, quant="int8-head")
    a, b = rows(tm.generate(ids, 20, **kw)), rows(tm.generate(ids, 20, **kw))
    assert np.array_equal(a, b) and a.shape == (17, 1)
    assert step_calls == [(1, True)] * 32


@pytest.mark.parametrize("kw", [dict(temperature=1.0, seed=3),
                                dict(temperature=0.9, seed=5, top_k=7),
                                dict(temperature=1.0, seed=7, top_p=0.9,
                                     repetition_penalty=1.3)],
                         ids=["plain", "top-k", "top-p-rep"])
def test_bucketed_prefill_sampling_matches_jax(kw, gaps):
    """tests/test_llama.py's bucketed-prefill sampling test: L=5 pads to 8,
    and the repetition penalty's seen marks ignore the padding; the port
    buckets as the JAX package does, so it equals JAX's stream with and
    without bucketing."""
    jm, tm = models(9)
    ids = np.array([[1, 5, 9, 4, 7]])
    with pdn.no_grad():
        want = rows(jm.generate(ids, 22, chunk=4, fused=False, **kw))
        unbucketed = rows(jm.generate(ids, 22, chunk=4, fused=False,
                                      bucket_prefill=False, **kw))
    got = rows(tm.generate(ids, 22, chunk=4, **kw))
    assert_equal_to_near_tie(got, want, gaps)
    assert_equal_to_near_tie(got, unbucketed, gaps)


@pytest.mark.parametrize("B", [1, 3])
def test_sampled_generate_kv_int8_matches_jax(B, interp, gaps, step_calls):
    """The int8 KV cache samples through K2's emit mode, at B=1 too."""
    jm, tm = models(10)
    ids = np.array([[1, 5, 9], [2, 7, 3], [30, 20, 10]])[:B]
    kw = dict(FULL, kv_quant="int8")
    with pdn.no_grad():
        want = rows(jm.generate(ids, 18, chunk=5, fused=True, **kw))
    got = rows(tm.generate(ids, 18, chunk=5, **kw))
    assert_equal_to_near_tie(got, want, gaps)
    assert step_calls == [(B, True)] * (18 - 3 - 1)


def test_sampling_modes():
    """tests/test_llama.py's test_generate_sampling_modes on the port:
    top_k=1 and top_p=0 are greedy at any temperature, a tiny temperature
    is greedy, a seed gives the same stream twice and another seed
    another stream."""
    _, tm = models(11)
    ids = np.array([[1, 5, 9]])
    greedy = rows(tm.generate(ids, 20))
    for kw in (dict(temperature=5.0, top_k=1), dict(temperature=1e-4),
               dict(temperature=2.0, top_p=0.0)):
        for fused in (True, False):
            assert np.array_equal(rows(tm.generate(ids, 20, fused=fused,
                                                   **kw)), greedy), kw
    a = rows(tm.generate(ids, 20, temperature=1.0, seed=7))
    assert np.array_equal(a, rows(tm.generate(ids, 20, temperature=1.0,
                                              seed=7)))
    assert not np.array_equal(a, rows(tm.generate(ids, 20, temperature=1.0,
                                                  seed=8)))


REQUESTS = [([1, 5, 9], dict(temperature=5.0, top_k=40)),
            ([2, 7, 3], dict()),
            ([30, 20], dict(temperature=0.9, top_p=0.9, seed=42)),
            ([4, 4, 4, 4], dict(temperature=0.0)),
            ([3, 1, 4, 1, 5], dict(seed=-7)),
            ([9, 8], dict(top_k=5))]


def serve_both(jm, tm, requests, **kw):
    """Serve ``requests`` [(prompt, overrides)] (8 new tokens each) on the
    JAX server and on the port's; returns (jax streams, port streams)."""
    kw = dict(dict(batch_size=2, chunk=4, eos_id=-1, seed=3), **kw)
    with pdn.no_grad():
        js = JServer(jm, **kw)
        jr = [js.submit(p, max_new_tokens=8, **o) for p, o in requests]
        jd = js.run()
    ts = LlamaServer(tm, **kw)
    tr = [ts.submit(p, max_new_tokens=8, **o) for p, o in requests]
    td = ts.run()
    return [jd[r].tokens for r in jr], [td[r].tokens for r in tr]


@pytest.mark.parametrize("lane", ["fused", "xla"])
@pytest.mark.parametrize("defaults", [dict(), dict(temperature=0.8,
                                                   top_k=50, top_p=0.9)],
                         ids=["greedy-server", "sampling-server"])
def test_sampled_server_matches_jax(lane, defaults, interp, gaps):
    """Per-request overrides, seeded (negative too) and unseeded requests
    and greedy overrides, on a greedy and a sampling server, slots
    recycled (6 requests on 2 slots), on both lanes."""
    jm, tm = models(14, SERVE_CFG)
    want, got = serve_both(jm, tm, REQUESTS, lane=lane, **defaults)
    assert gaps and min(g.min() for g in gaps) >= NEAR_TIE
    assert got == want and all(len(t) == 8 for t in got)


def test_seeded_request_is_fleet_independent(interp, gaps):
    """tests/test_serve.py's per-request seed test: a seeded request's
    tokens are the same alone, in a crowded fleet of another size
    submitted last, and on a server with another seed; and JAX's."""
    jm, tm = models(16, SERVE_CFG)
    target = ([1, 5, 9], dict(temperature=1.0, top_k=60, seed=42))
    others = [([2, 7, 3], dict(temperature=0.7, seed=0)),
              ([30, 20, 10], dict(temperature=0.8, seed=1)),
              ([4, 4, 4], dict(temperature=0.9, seed=2))]
    want, alone = serve_both(jm, tm, [target])
    crowded = serve_both(jm, tm, others + [target], batch_size=4)[1][-1]
    other_seed = serve_both(jm, tm, [target], seed=99999)[1][0]
    assert min(g.min() for g in gaps) >= NEAR_TIE
    assert alone == want and crowded == alone[0] and other_seed == alone[0]


def test_sampled_first_token_is_drawn(interp, gaps):
    """tests/test_serve.py's first-token test: the admission token of a
    sampled request is drawn, so it changes with the seed, and equals
    JAX's for each seed."""
    jm, tm = models(13, SERVE_CFG)
    firsts = []
    for seed in range(4):
        want, got = serve_both(jm, tm, [([1, 5, 9], {})], batch_size=1,
                               chunk=2, temperature=5.0, seed=seed)
        assert got == want
        firsts.append(got[0][0])
    assert min(g.min() for g in gaps) >= NEAR_TIE
    assert len(set(firsts)) > 1, firsts


def test_server_runs_the_emit_mode_only_for_sampling_fleets(step_calls):
    """A chunk runs K2's emit mode when an active slot samples; a fleet
    whose rows all override to greedy runs the argmax mode, on a sampling
    server too, and streams exactly the greedy server's tokens."""
    _, tm = models(17, SERVE_CFG)
    prompts = [[1, 5, 9], [2, 7, 3]]
    srv = LlamaServer(tm, batch_size=2, chunk=4, eos_id=-1,
                      temperature=0.9, seed=3)
    rids = [srv.submit(p, max_new_tokens=8, temperature=0.0)
            for p in prompts]
    done = srv.run()
    assert step_calls == [(2, False)] * srv.dispatched_steps
    greedy = LlamaServer(tm, batch_size=2, chunk=4, eos_id=-1)
    gr = [greedy.submit(p, max_new_tokens=8) for p in prompts]
    gd = greedy.run()
    assert [done[r].tokens for r in rids] == [gd[r].tokens for r in gr]
    del step_calls[:]
    srv = LlamaServer(tm, batch_size=2, chunk=4, eos_id=-1)
    srv.submit(prompts[0], max_new_tokens=8, temperature=0.8)
    srv.submit(prompts[1], max_new_tokens=8)
    srv.run()
    assert step_calls == [(2, True)] * srv.dispatched_steps


def test_submit_checks_sampling_arguments():
    _, tm = models(18, SERVE_CFG)
    srv = LlamaServer(tm, batch_size=2, lane="xla")
    for kw in (dict(top_k=0), dict(top_p=0.0), dict(top_p=1.5),
               dict(temperature=-1.0)):
        with pytest.raises(ValueError):
            srv.submit([1, 2, 3], **kw)
    with pytest.raises(ValueError, match="int32"):
        srv.submit([1, 2, 3], temperature=0.5, seed=2**31)
    assert srv.submit([1, 2, 3], temperature=0.5, seed=-2**31) == 0


def test_logits_and_sampled_gates_match_jax(interp):
    """bench.py's logits-head-f32 and sampled-t0.8-k50-p0.9 gates: the
    port's and JAX's pass on the same model, and their emitted logits
    agree within float32 noise."""
    jm, tm = models(19)
    ids = np.array([[1, 5, 9, 4]])
    truth = tfid.greedy_truth(tm, ids, 12)[0]
    with pdn.no_grad():
        jdiff, jok = jfid.gate_fused_logits(jm, ids, truth)
        jchk, jsok, jagree = jfid.gate_fused_sampled(jm, ids, truth)
        jf, _ = jfid._teacher_forced_logits(jm, ids, truth)
    diff, ok = tfid.gate_fused_logits(tm, ids, truth)
    checked, sok, agree = tfid.gate_fused_sampled(tm, ids, truth)
    tf, _ = tfid._teacher_forced_logits(tm, ids, truth)
    assert jok and ok and diff < 1e-4 and jdiff < 1e-4
    assert checked == jchk == 11 and sok and jsok and agree == 1.0
    np.testing.assert_allclose(tf.numpy(), jf, atol=1e-5)


def test_clis_take_the_sampling_flags(capsys, step_calls):
    """``--temperature/--top-k/--top-p/--seed`` (and infer's
    ``--repetition-penalty``) sample through the emit modes; ``--seed``
    seeds the sampler, not the weights."""
    from pydynet_tpu_torch.models.llama import infer, serve_cli

    flags = ["--temperature", "0.8", "--top-k", "50", "--top-p", "0.9"]
    assert infer.main(["--random-init", "--device", "cpu",
                       "--max-new-tokens", "20", "--seed", "5",
                       "--repetition-penalty", "1.1", *flags]) > 0
    assert step_calls and all(e for _, e in step_calls)
    del step_calls[:]
    assert serve_cli.main(["--random-init", "--device", "cpu",
                           "--batch-size", "2", "--chunk", "4",
                           "--max-new-tokens", "6", "--dtype", "float32",
                           "--prompt", "There was a boy", "--seed", "5",
                           *flags]) > 0
    assert step_calls and all(e for _, e in step_calls)
    out = capsys.readouterr().out
    assert "from seed 0" in out and out.count("--- [") == 1
