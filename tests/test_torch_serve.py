"""The port's batched decode and continuous-batching server against the JAX
package's, on the CPU.

Weights come from a seeded JAX model and reach the port through
``params_from_tpu``. The JAX batched Pallas kernel runs in interpret mode,
as ``tests/test_serve.py`` runs it; the port's batched step runs the
kernel's plain version because the tensors are on the CPU. Streams are
float32 (and int8-head) and must be equal token for token.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydynet_tpu as pdn
from pydynet_tpu.models.llama.model import Llama as JLlama
from pydynet_tpu.models.llama.serve import LlamaServer as JServer
from pydynet_tpu.ops import decode_step as jdsk

from pydynet_tpu_torch.models.llama import Llama, params_from_tpu
from pydynet_tpu_torch.models.llama.serve import LlamaServer
from pydynet_tpu_torch.ops import decode_step as tdsk

# tests/test_serve.py's tiny config
CFG = dict(vocab_size=256, embed_dim=32, n_heads=2, ffn_dim=64,
           max_seq_len=64, max_batch_size=2, n_layers=2)


@pytest.fixture
def interp_kernels(monkeypatch):
    """JAX's batched kernel in interpret mode (tests/test_serve.py)."""
    monkeypatch.setattr(jdsk, "fused_decode_token_batched",
                        functools.partial(jdsk.fused_decode_token_batched,
                                          interpret=True))


@pytest.fixture
def batched_calls(monkeypatch):
    """Count the port's fused_decode_token_batched calls (on the CPU they
    run the plain version, which the launch counter does not count)."""
    calls = []
    real = tdsk.fused_decode_token_batched

    def spy(*args, **kwargs):
        calls.append(args[1].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(tdsk, "fused_decode_token_batched", spy)
    return calls


def models(seed, **over):
    """A seeded JAX model and its port, with the same weights."""
    cfg = dict(CFG, **over)
    np.random.seed(seed)
    jm = JLlama(dtype=np.float32, **cfg)
    jm.eval()
    tm = Llama(**cfg, device="cpu")
    tm.load_state_dict(params_from_tpu(
        {n: p.numpy() for n, p in jm._parameters.items()}), strict=True)
    return jm, tm.eval()


def standalone(tm, prompt, n_new, **kw):
    """The port's single-prompt stream of n_new tokens, prefill token
    first (``max_new_tokens`` of generate bounds the total length)."""
    return [int(t[0, 0]) for t in tm.generate(np.asarray([prompt]),
                                              len(prompt) + n_new, **kw)]


def serve_both(jm, tm, requests, **kw):
    """Serve ``requests`` [(prompt, max_new_tokens)] on a JAX server and on
    the port's with the same options; returns (jax streams, port streams,
    port server)."""
    with pdn.no_grad():
        js = JServer(jm, **kw)
        jr = [js.submit(p, max_new_tokens=n) for p, n in requests]
        jd = js.run()
    ts = LlamaServer(tm, **kw)
    tr = [ts.submit(p, max_new_tokens=n) for p, n in requests]
    td = ts.run()
    assert set(jd) == set(jr) and set(td) == set(tr)
    return [jd[r].tokens for r in jr], [td[r].tokens for r in tr], ts


@pytest.mark.parametrize("quant", [None, "int8-head"])
def test_fused_step_batched_matches_jax_kernel(quant, interp_kernels):
    """Five consecutive batched steps from pos 5 over random cache rows,
    rows starting at [0, 2, 5, 0] (row 2 sees only its new row at pos 5):
    equal tokens, and caches equal to 1e-5 once JAX's lane padding is
    stripped (only summation order differs)."""
    jm, tm = models(1)
    N, B, S, D = CFG["n_layers"], 4, CFG["max_seq_len"], CFG["embed_dim"]
    rng = np.random.default_rng(2)
    ck = (rng.standard_normal((N, B, S, D)) * 0.3).astype(np.float32)
    cv = (rng.standard_normal((N, B, S, D)) * 0.3).astype(np.float32)
    pad = ((0, 0),) * 3 + ((0, jdsk.lane_pad_dim(D) - D),)
    jck, jcv = np.pad(ck, pad), np.pad(cv, pad)
    tck, tcv = torch.from_numpy(ck), torch.from_numpy(cv)
    starts = np.array([0, 2, 5, 0], np.int32)
    jw = jm._fused_weights(None, quant)
    tw = tm._fused_weights(None, quant)
    step = jm._make_fused_decode_fns()[6]
    toks = np.array([7, 100, 3, 250], np.int32)
    for pos in range(5, 10):
        jn, jck, jcv = step(jw, jck, jcv, jnp.asarray(toks), pos,
                            starts=jnp.asarray(starts))
        tn = tm.fused_step_batched(
            tw, tck, tcv, torch.from_numpy(toks),
            torch.tensor([pos], dtype=torch.int32),
            starts=torch.from_numpy(starts))
        assert tn.dtype == torch.int32 and tn.shape == (B,)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_allclose(tck.numpy(), np.asarray(jck)[..., :D],
                                   atol=1e-5)
        np.testing.assert_allclose(tcv.numpy(), np.asarray(jcv)[..., :D],
                                   atol=1e-5)
        toks = tn.numpy()


@pytest.mark.parametrize("quant", [None, "int8-head"])
def test_batched_generate_matches_jax(quant, interp_kernels, batched_calls):
    """B=3 greedy generate on the fused lane: the port's default lane
    against JAX's ``generate(fused=True)``, token for token."""
    jm, tm = models(3, max_batch_size=3)
    ids = np.array([[1, 5, 9], [2, 7, 3], [30, 20, 10]])
    with pdn.no_grad():
        want = np.concatenate([t.numpy() for t in jm.generate(
            ids, 14, chunk=4, fused=True, quant=quant)], 1)
    rows = list(tm.generate(ids, 14, chunk=4, quant=quant))
    assert all(r.shape == (3, 1) and r.dtype == torch.int32 for r in rows)
    np.testing.assert_array_equal(torch.cat(rows, 1).numpy(), want)
    assert batched_calls == [3] * (14 - 3 - 1)  # one step a decode token


def test_server_matches_standalone_and_jax(interp_kernels):
    """test_serve.py:40: three requests on two slots, so one is admitted
    at a shifted position, each equal to its standalone stream."""
    jm, tm = models(9)
    prompts = [[1, 5, 9], [2, 7, 3, 11], [30, 20]]
    want, got, srv = serve_both(jm, tm, [(p, 8) for p in prompts],
                                batch_size=2, chunk=4, eos_id=-1)
    assert got == want
    assert got == [standalone(tm, p, 8, fused=False) for p in prompts]
    assert len(prompts) > srv.B


def test_server_capacity_rewind(interp_kernels):
    """test_serve.py:61: filling the cache truncates the request, rewinds
    the fleet, and a later request still matches standalone."""
    jm, tm = models(10)
    want, got, srv = serve_both(jm, tm, [([1, 5, 9], 1000)], batch_size=2,
                                chunk=16, eos_id=-1)
    assert got == want
    assert srv._finished[0].truncated and srv._pos == 0
    r2 = srv.submit([4, 8], max_new_tokens=6)
    assert srv.run()[r2].tokens == standalone(tm, [4, 8], 6, fused=False)


def test_server_idle_rewind_gives_full_headroom(interp_kernels):
    """test_serve.py:104: a request admitted to a drained server gets the
    whole cache as headroom."""
    jm, tm = models(14)
    _, _, srv = serve_both(jm, tm, [([1, 5, 9], 40)], batch_size=1,
                           chunk=8, eos_id=-1)
    assert srv._pos > 20
    r2 = srv.submit([2, 7, 3], max_new_tokens=40)
    done = srv.run()
    assert not done[r2].truncated
    assert done[r2].tokens == standalone(tm, [2, 7, 3], 40, fused=False)
    with pdn.no_grad():
        js = JServer(jm, batch_size=1, chunk=8, eos_id=-1)
        js.submit([2, 7, 3], max_new_tokens=40)
        assert js.run()[0].tokens == done[r2].tokens


def test_server_eos_frees_slot(interp_kernels):
    """test_serve.py:150: a request that meets EOS stops without emitting
    it, and its slot serves the next request."""
    jm, tm = models(12)
    probe = standalone(tm, [1, 5, 9], 8, fused=False)
    eos = probe[2]
    want, got, _ = serve_both(jm, tm, [([1, 5, 9], 8), ([2, 7, 3], 4)],
                              batch_size=1, chunk=4, eos_id=eos)
    assert got == want
    assert got[0] == probe[:2]
    exp2 = standalone(tm, [2, 7, 3], 4, fused=False)
    assert got[1] == (exp2[:exp2.index(eos)] if eos in exp2 else exp2)


def test_server_heavy_turnover_mixed_lengths(interp_kernels):
    """test_serve.py:175: B=4 slots, 10 requests of mixed prompt lengths
    (per-length admission groups, power-of-two sub-waves, dispatch-time
    slot attribution); every stream equals standalone and the JAX
    server's."""
    jm, tm = models(13, max_batch_size=4)
    rng = np.random.RandomState(5)
    prompts = [[int(x) for x in rng.randint(3, 250,
                                            size=rng.choice([2, 3, 5]))]
               for _ in range(10)]
    want, got, _ = serve_both(jm, tm, [(p, 6) for p in prompts],
                              batch_size=4, chunk=4, eos_id=-1)
    assert got == want
    assert got == [standalone(tm, p, 6, fused=False) for p in prompts]


def test_server_int8_head_matches_standalone(interp_kernels):
    """test_serve.py:257, int8-head: the request admitted at pos0 = 0
    equals ``generate(quant="int8-head")`` (rows are independent), every
    first token comes from the full-precision prefill, and the port's
    streams equal the JAX server's."""
    jm, tm = models(12)
    prompts = [[1, 5, 9], [2, 7, 3, 11], [30, 20]]
    want_fp = [standalone(tm, p, 8, fused=False) for p in prompts]
    want_q0 = [int(t[0, 0]) for t in tm.generate(
        np.asarray([prompts[0], prompts[0]]), len(prompts[0]) + 8,
        quant="int8-head")]
    want, got, _ = serve_both(jm, tm, [(p, 8) for p in prompts],
                              batch_size=2, chunk=4, eos_id=-1,
                              quant="int8-head")
    assert got == want
    assert got[0] == want_q0
    assert all(len(g) == 8 and g[0] == w[0] for g, w in zip(got, want_fp))


def test_server_fixed_chunk_tail_trim(interp_kernels):
    """test_serve.py:356: chunk 7 does not divide S - len(prompt); the
    steps past the cache end are trimmed, so the request truncates at
    exactly S tokens."""
    jm, tm = models(15)
    S = CFG["max_seq_len"]
    want, got, _ = serve_both(jm, tm, [([1, 5, 9], 10_000)], batch_size=2,
                              chunk=7, eos_id=-1)
    assert got == want
    assert len(got[0]) == 1 + (S - 3)
    assert all(0 <= t < CFG["vocab_size"] for t in got[0])


def test_server_stream_incremental(interp_kernels):
    """test_serve.py:458: stream() yields each request's tokens in order,
    over several yields, the admission token included, and they add up to
    run()'s streams and the JAX server's."""
    jm, tm = models(17)
    prompts = [[1, 5, 9], [2, 7, 3], [30, 20]]
    want, ref, _ = serve_both(jm, tm, [(p, 10) for p in prompts],
                              batch_size=2, chunk=4, eos_id=-1)
    assert ref == want
    srv = LlamaServer(tm, batch_size=2, chunk=4, eos_id=-1)
    rids = [srv.submit(p, max_new_tokens=10) for p in prompts]
    got = {r: [] for r in rids}
    yields = {r: 0 for r in rids}
    for rid, toks in srv.stream():
        got[rid].extend(toks)
        yields[rid] += 1
    assert [got[r] for r in rids] == ref
    assert [srv._finished[r].tokens for r in rids] == ref
    assert all(v >= 2 for v in yields.values()), yields


def test_server_step_does_not_leak_admit_credits(interp_kernels):
    """test_serve.py:496: step() clears the admission-credit buffer, so a
    later stream() replays no stale first tokens."""
    _, tm = models(18)
    srv = LlamaServer(tm, batch_size=2, chunk=4, eos_id=-1)
    r1 = srv.submit([1, 5, 9], max_new_tokens=4)
    srv.step()
    assert srv._admit_credits == []
    while not srv._finished.get(r1):
        srv.step()
    r2 = srv.submit([2, 7], max_new_tokens=4)
    got = []
    for rid, toks in srv.stream():
        assert rid == r2
        got.extend(toks)
    assert got == srv._finished[r2].tokens
    assert got == standalone(tm, [2, 7], 4, fused=False)


def test_server_dispatches_one_batched_step_per_token(batched_calls):
    """Every decode step of the server is one batched-kernel call over all
    slots, the clamped filler steps of a fixed chunk included."""
    _, tm = models(19)
    srv = LlamaServer(tm, batch_size=2, chunk=4, eos_id=-1)
    for p in ([1, 5, 9], [2, 7, 3, 11], [30, 20]):
        srv.submit(p, max_new_tokens=6)
    srv.run()
    assert srv.dispatched_steps > 0
    assert batched_calls == [2] * srv.dispatched_steps


def test_unported_options_raise(batched_calls):
    _, tm = models(20)
    cases = [dict(kv_quant="int8", lane="xla"), dict(prefix_cache=True),
             dict(dtype=torch.float16)]
    for kw in cases:
        with pytest.raises(NotImplementedError):
            LlamaServer(tm, **kw)
    # flash prefill admissions run and serve the dense admissions' streams
    served = []
    for flash in (True, False):
        srv = LlamaServer(tm, batch_size=2, chunk=4, eos_id=-1,
                          flash_prefill=flash)
        rids = [srv.submit(p, max_new_tokens=6) for p in ([1, 5, 9], [2, 7])]
        done = srv.run()
        served.append([done[r].tokens for r in rids])
    assert served[0] == served[1] and all(len(t) == 6 for t in served[0])
    with pytest.raises(NotImplementedError, match="Sampling"):
        LlamaServer(tm, speculative=4)
    # the int8 KV cache and int8/int4 layers run on the batched step, one
    # call a dispatched step
    for kw in (dict(kv_quant="int8"), dict(quant="int8"), dict(quant="int4"),
               dict(lane="fused", quant="int4")):
        del batched_calls[:]
        srv = LlamaServer(tm, batch_size=2, chunk=4, eos_id=-1, **kw)
        assert srv._lane == "fused"
        rid = srv.submit([1, 5, 9], max_new_tokens=6)
        assert len(srv.run()[rid].tokens) == 6
        assert batched_calls == [2] * srv.dispatched_steps > []
    # a grouped-query model and a fleet above 32 slots: the batched step
    # (the narrow mode; K2's row groups), one call over all slots a step
    gqa = Llama(**dict(CFG, n_kv_heads=1), device="cpu")
    for model, batch in ((gqa, 2), (tm, 33)):
        del batched_calls[:]
        srv = LlamaServer(model, batch_size=batch, chunk=1, eos_id=-1)
        assert srv._lane == "fused"
        assert srv._ck.shape[-1] == model.n_kv_heads * model.head_dim
        rid = srv.submit([1, 5, 9], max_new_tokens=2)
        assert len(srv.run()[rid].tokens) == 2
        assert batched_calls == [batch] * srv.dispatched_steps > []
    wide = Llama(**dict(CFG, embed_dim=512, n_heads=1),  # head_dim > 256
                 device="cpu")
    with pytest.raises(NotImplementedError, match="Big-dims"):
        LlamaServer(wide)
    srv = LlamaServer(tm, batch_size=2)
    with pytest.raises(ValueError):
        srv.submit(list(range(1, CFG["max_seq_len"] + 1)))
    # generate at B>1: options not ported raise, B above the kernel's rows
    # raises, and nothing reroutes to the plain lane
    ids = np.array([[1, 5, 9], [2, 7, 3]])
    flash = [r.tolist() for r in tm.generate(ids, 8, flash_prefill=True)]
    assert len(flash) == 5 and flash == [r.tolist()
                                         for r in tm.generate(ids, 8)]
    for kw in (dict(kv_quant="int8"), dict(quant="int8")):
        del batched_calls[:]
        assert len(list(tm.generate(ids, 8, **kw))) == 5
        assert batched_calls == [2] * 4
    del batched_calls[:]
    assert len(list(tm.generate(np.ones((33, 3), np.int64), 5))) == 2
    assert batched_calls == [33]
    del batched_calls[:]
    assert len(list(gqa.generate(ids, 8))) == 5
    assert batched_calls == [2] * 4
    del batched_calls[:]
    assert len(list(gqa.generate(ids, 8, fused=False))) == 5
    assert not batched_calls


def test_serve_cli_runs_on_cpu_and_refuses_missing_gpu(tmp_path, capsys,
                                                       batched_calls):
    from pydynet_tpu_torch.models.llama import serve_cli

    prompts = tmp_path / "prompts.txt"
    prompts.write_text("Once upon a time\n\nThe little red hen\n")
    rate = serve_cli.main([
        "--random-init", "--device", "cpu", "--batch-size", "2", "--chunk",
        "4", "--max-new-tokens", "6", "--dtype", "float32", "--quant",
        "int8-head", "--prompt", "There was a boy", "--prompts-file",
        str(prompts), "--weights", str(tmp_path / "none.npz"), "--stream"])
    out = capsys.readouterr().out
    assert rate > 0 and out.count("--- [") == 3
    assert "tokens/s aggregate" in out and batched_calls
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            serve_cli.main(["--random-init", "--max-new-tokens", "6"])
