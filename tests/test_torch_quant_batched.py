"""The port's batched decode step with int8 and int4 layers and with the int8
KV cache (K2's ``qlayers``, ``q4`` and ``kv_int8`` modes, and
``quantize_kv``) against the JAX package's, on the CPU.

Weights come from a seeded JAX Llama and reach the port through
``params_from_tpu``. The JAX batched step runs its Pallas kernel in
interpret mode, as ``tests/test_serve.py`` does; the port's runs its plain
version because the tensors are on the CPU. Caches hold the same rows in
both packages: the JAX ones lane-padded with zeros, which change no row's
amax.
"""
import functools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import pydynet_tpu as pdn
from pydynet_tpu.models.llama.model import Llama as JLlama
from pydynet_tpu.models.llama.serve import LlamaServer as JServer
from pydynet_tpu.ops import decode_step as jds

from pydynet_tpu_torch.models.llama import Llama, params_from_tpu
from pydynet_tpu_torch.models.llama.model import (FUSED_MATS,
                                                  decode_quant_kwargs,
                                                  decode_weight_args)
from pydynet_tpu_torch.models.llama.serve import LlamaServer
from pydynet_tpu_torch.ops import decode_step as tds

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

# test_torch_quant_decode.py's tiny size, three rows
TINY = dict(vocab_size=256, embed_dim=32, n_heads=2, ffn_dim=64,
            max_seq_len=32, max_batch_size=3, n_layers=2)
B = 3
STARTS = np.array([0, 2, 5], np.int32)  # row 2 starts at the first step


@pytest.fixture
def interp_kernels(monkeypatch):
    """JAX's batched kernel in interpret mode (tests/test_serve.py)."""
    monkeypatch.setattr(jds, "fused_decode_token_batched",
                        functools.partial(jds.fused_decode_token_batched,
                                          interpret=True))


@pytest.fixture
def batched_calls(monkeypatch):
    """The port's fused_decode_token_batched calls, by their mode (on the
    CPU they run the plain version, which the launch counter does not
    count)."""
    calls = []
    real = tds.fused_decode_token_batched

    def spy(*args, **kwargs):
        calls.append((args[1].shape[0], kwargs.get("scales") is not None,
                      bool(kwargs.get("q4")), kwargs.get("sk") is not None))
        return real(*args, **kwargs)

    monkeypatch.setattr(tds, "fused_decode_token_batched", spy)
    return calls


def models(seed, **over):
    cfg = dict(TINY, **over)
    np.random.seed(seed)
    jm = JLlama(dtype=np.float32, **cfg)
    jm.eval()
    tm = Llama(**cfg, device="cpu")
    tm.load_state_dict(params_from_tpu(
        {n: p.numpy() for n, p in jm._parameters.items()}), strict=True)
    return jm, tm.eval()


def _jax_step(jw, pos, toks, ck, cv, **kw):
    """JAX's batched step with emit_logits, in interpret mode, laid out as
    its model's ``fused_step_batched`` lays it out."""
    V, S = TINY["vocab_size"], TINY["max_seq_len"]
    q = "_q" if "s_attn" in jw else ""
    return jds.fused_decode_token_batched(
        pos, jw["tok"][jnp.asarray(toks)].astype(jnp.float32), jw["cosD"],
        jw["sinD"], jw["rot"], jw["hmask_pad"], jw["norm2"],
        *(jw[name + q] for name in FUSED_MATS), jw["in_norm2"],
        jw["post_norm2"], jw["head_wq"] if "head_s" in jw else jw["head_w"],
        jw["head_b2"], ck, cv, vt=jds.pick_vt(V, TINY["embed_dim"]),
        sb=jds.pick_sb(S), interpret=True, emit_logits=True,
        starts=jnp.asarray(STARTS), s_attn=jw.get("s_attn"),
        s_ffn=jw.get("s_ffn"), head_s=jw.get("head_s"), q4="q4" in jw, **kw)


def _random_rows(seed):
    N, S, D = TINY["n_layers"], TINY["max_seq_len"], TINY["embed_dim"]
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((N, B, S, D)) * 0.5).astype(np.float32)
            for _ in range(2)]


def _pad(c):
    D = c.shape[-1]
    return np.pad(c, ((0, 0),) * (c.ndim - 1) + ((0, jds.lane_pad_dim(D) - D),))


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quant_batched_logits_match_jax_kernel(quant):
    """Four B=3 steps from pos 5 over seeded random cache rows, rows
    starting at 0, 2 and 5, JAX's logits from its kernel against the port's
    plain step, each row's activations quantized with its own scale:
    float32 throughout and the same integer products, so they differ by
    summation order (1e-6) unless an activation lands within that of a
    rounding boundary and quantizes one step apart, which moves a logit by
    about max |w| * amax / 127 (1e-3 here): logits within 1e-3, the same
    argmax, caches within 1e-3 (``test_quant_step_logits_match_jax_kernel``'s
    tolerances)."""
    jm, tm = models(1)
    jw = jm._fused_weights(None, quant)
    tw = tm._fused_weights(None, quant)
    D = TINY["embed_dim"]
    ck, cv = _random_rows(2)
    jck, jcv = jnp.asarray(_pad(ck)), jnp.asarray(_pad(cv))
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    toks = np.array([17, 200, 3], np.int32)
    for pos in range(5, 9):
        want, jck, jcv = _jax_step(jw, pos, toks, jck, jcv)
        want = np.asarray(want)
        got = tds.decode_token_batched_logits_ref(
            torch.tensor([pos], dtype=torch.int32), torch.from_numpy(toks),
            *decode_weight_args(tw), tck, tcv, n_heads=TINY["n_heads"],
            starts=torch.from_numpy(STARTS), **decode_quant_kwargs(tw))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      want.argmax(-1))
        np.testing.assert_allclose(tck.numpy(), np.asarray(jck)[..., :D],
                                   atol=1e-3)
        np.testing.assert_allclose(tcv.numpy(), np.asarray(jcv)[..., :D],
                                   atol=1e-3)
        toks = want.argmax(-1).astype(np.int32)


def test_kv_int8_batched_logits_match_jax_kernel():
    """The same four steps with float32 weights and the int8 KV cache
    (rows and scales from one ``quantize_kv``): logits within 1e-4 (float32
    in both, summation order apart; a query or K/V element a rounding step
    apart moves a score by about |x| * s / 127); the int8 caches never more
    than one apart, equal on at least 99 % of entries; the scales within
    rtol 1e-6."""
    jm, tm = models(4)
    jw = jm._fused_weights(None, None)
    tw = tm._fused_weights(None, None)
    D = TINY["embed_dim"]
    (tck, tsk), (tcv, tsv) = (tds.quantize_kv(torch.from_numpy(c))
                              for c in _random_rows(3))
    jck, jcv = jnp.asarray(_pad(tck.numpy())), jnp.asarray(_pad(tcv.numpy()))
    jsk, jsv = jnp.asarray(tsk.numpy()), jnp.asarray(tsv.numpy())
    toks = np.array([17, 200, 3], np.int32)
    for pos in range(5, 9):
        want, jck, jcv, jsk, jsv = _jax_step(jw, pos, toks, jck, jcv,
                                             sk=jsk, sv=jsv)
        want = np.asarray(want)
        got = tds.decode_token_batched_logits_ref(
            torch.tensor([pos], dtype=torch.int32), torch.from_numpy(toks),
            *decode_weight_args(tw), tck, tcv, n_heads=TINY["n_heads"],
            starts=torch.from_numpy(STARTS), sk=tsk, sv=tsv)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
        for mine, theirs in ((tck, jck), (tcv, jcv)):
            diff = np.abs(mine.numpy().astype(np.int32)
                          - np.asarray(theirs)[..., :D].astype(np.int32))
            assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
        np.testing.assert_allclose(tsk.numpy(), np.asarray(jsk), rtol=1e-6)
        np.testing.assert_allclose(tsv.numpy(), np.asarray(jsv), rtol=1e-6)
        toks = want.argmax(-1).astype(np.int32)


def test_quantize_kv_matches_jax():
    """quantize_kv bit for bit against JAX's on seeded float32 rows, bf16
    rows, all-zero rows (scale floored at 1e-10, zeros kept) and bf16 rows
    whose x / s lands exactly on a half-integer (rounded to even)."""
    rng = np.random.default_rng(5)
    f32 = (rng.standard_normal((3, 7, 40)) * 3).astype(np.float32)
    f32[0, 2] = 0.0
    half = np.zeros((4, 16), np.float32)
    half[:, 0] = 127.0  # s = 1, so x / s is x itself
    half[:, 1:] = np.arange(-7.5, 7.5)[None]
    half[1] *= 2.0  # s = 2: still exact half-integers
    half[2, 0] = -127.0
    half[3] = 0.0
    bf = np.concatenate([half, (rng.standard_normal((4, 16)) * 5)
                         .astype(np.float32)]).astype(ml_dtypes.bfloat16)
    for rows, tdtype in ((f32, torch.float32), (bf, torch.bfloat16)):
        want_q, want_s = jds.quantize_kv(jnp.asarray(rows))
        got_q, got_s = tds.quantize_kv(
            torch.from_numpy(rows.astype(np.float32)).to(tdtype))
        assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    q, s = tds.quantize_kv(torch.from_numpy(half))
    assert q[0, 1:].tolist() == [-8, -6, -6, -4, -4, -2, -2, 0, 0, 2, 2, 4,
                                 4, 6, 6]
    assert q[3].abs().max() == 0 and float(s[3]) == np.float32(1e-10)


def stream_rows(gen):
    return np.concatenate([t.numpy() for t in gen], 1)


@pytest.mark.parametrize("ids,kw", [
    (np.array([[1, 5, 9], [2, 7, 3], [30, 20, 10]]), dict(quant="int8")),
    (np.array([[1, 5, 9], [2, 7, 3], [30, 20, 10]]), dict(quant="int4")),
    (np.array([[1, 5, 9], [2, 7, 3], [30, 20, 10]]), dict(kv_quant="int8")),
    (np.array([[1, 5, 9]]), dict(kv_quant="int8"))],
    ids=["b3-int8", "b3-int4", "b3-kvint8", "b1-kvint8"])
def test_generate_matches_jax_fused(ids, kw, interp_kernels, batched_calls):
    """generate at B=3 with int8 and int4 layers and with the int8 KV cache,
    and at B=1 with the int8 KV cache, token for token against the JAX
    package's ``generate(fused=True)`` (its batched kernel in interpret
    mode): one batched-step call a decode token in the mode's format, B=1
    included, the prefill token from the float weights in both. All four
    streams are equal at every step at this seed; at seed 8 the int8 one
    flips at a near-tie (JAX's top-2 margin 1.3e-4, one activation
    quantized a step apart)."""
    jm, tm = models(3)
    Bq = ids.shape[0]
    with pdn.no_grad():
        want = stream_rows(jm.generate(ids, 16, chunk=5, fused=True, **kw))
        plain = stream_rows(jm.generate(ids, 16, fused=False))
    got = list(tm.generate(ids, 16, chunk=5, **kw))
    assert all(r.shape == (Bq, 1) and r.dtype == torch.int32 for r in got)
    np.testing.assert_array_equal(torch.cat(got, 1).numpy(), want)
    np.testing.assert_array_equal(want[:, 0], plain[:, 0])
    quant = kw.get("quant")
    assert batched_calls == [(Bq, quant is not None, quant == "int4",
                              "kv_quant" in kw)] * (16 - 3 - 1)


PROMPTS = [[1, 5, 9], [2, 7, 3, 11], [30, 20]]


@pytest.mark.parametrize("kw", [dict(kv_quant="int8"), dict(quant="int8")],
                         ids=["kvint8", "int8"])
def test_server_matches_jax_and_standalone(kw, interp_kernels):
    """tests/test_serve.py:201 and :257: three requests on two slots, so
    one is admitted at a shifted position. The port's streams equal the
    JAX server's; the request admitted at pos0 = 0 equals ``generate`` in
    the same mode (rows are independent); every first token comes from the
    full-precision prefill."""
    jm, tm = models(9, max_seq_len=64, max_batch_size=2)
    want_fp = [[int(t[0, 0]) for t in tm.generate(
        np.asarray([p]), len(p) + 8, fused=False)] for p in PROMPTS]
    want_q0 = [int(t[0, 0]) for t in tm.generate(
        np.asarray([PROMPTS[0], PROMPTS[0]]), len(PROMPTS[0]) + 8, **kw)]
    with pdn.no_grad():
        js = JServer(jm, batch_size=2, chunk=4, eos_id=-1, **kw)
        jr = [js.submit(p, max_new_tokens=8) for p in PROMPTS]
        jd = js.run()
    ts = LlamaServer(tm, batch_size=2, chunk=4, eos_id=-1, **kw)
    if "kv_quant" in kw:
        assert ts._ck[0].dtype == torch.int8 and ts._ck[1].min() > 0
    tr = [ts.submit(p, max_new_tokens=8) for p in PROMPTS]
    td = ts.run()
    got = [td[r].tokens for r in tr]
    assert got == [jd[r].tokens for r in jr]
    assert got[0] == want_q0
    assert all(len(g) == 8 and g[0] == w[0] for g, w in zip(got, want_fp))


def test_kv_quant_refusals_that_stay():
    """The fused lane's int8 KV cache takes float weights: any ``quant``
    with it there is a ValueError, as in the JAX package (``fused=None``
    still routes this model there); the scan lane (``fused=False`` /
    ``lane="xla"``) composes them; an unknown mode is a ValueError."""
    _, tm = models(10)
    ids = np.array([[1, 5, 9], [2, 7, 3]])
    for quant in ("int8-head", "int8", "int4"):
        for b in (1, 2):
            with pytest.raises(ValueError, match="mutually exclusive"):
                next(tm.generate(ids[:b], 8, quant=quant, kv_quant="int8"))
        with pytest.raises(ValueError, match="mutually exclusive"):
            LlamaServer(tm, batch_size=2, quant=quant, kv_quant="int8")
        with pytest.raises(ValueError, match="mutually exclusive"):
            LlamaServer(tm, batch_size=2, quant=quant, kv_quant="int8",
                        lane="fused")
        rows = list(tm.generate(ids, 8, quant=quant, kv_quant="int8",
                                fused=False))
        assert len(rows) == 5 and rows[0].shape == (2, 1)
        srv = LlamaServer(tm, batch_size=2, chunk=4, eos_id=-1, quant=quant,
                          kv_quant="int8", lane="xla")
        rid = srv.submit([1, 5, 9], max_new_tokens=5)
        assert len(srv.run()[rid].tokens) == 5
    with pytest.raises(ValueError, match="kv_quant"):
        next(tm.generate(ids, 8, kv_quant="fp4"))
    with pytest.raises(ValueError, match="kv_quant"):
        LlamaServer(tm, batch_size=2, kv_quant="fp4")
    # the wrapper: int8 caches want their scales and float weights
    w = tm._fused_weights(None, "int8-head")
    ck = torch.zeros(2, 2, 32, 32, dtype=torch.int8)
    sk = torch.ones(2, 2, 32)
    args = (torch.tensor([3], dtype=torch.int32),
            torch.tensor([1, 2], dtype=torch.int32), *decode_weight_args(w),
            ck, ck.clone())
    with pytest.raises(ValueError, match="mutually exclusive"):
        tds.fused_decode_token_batched(*args, n_heads=2, sk=sk, sv=sk,
                                       **decode_quant_kwargs(w))
    with pytest.raises(ValueError, match="sk and sv"):
        tds.fused_decode_token_batched(*args, n_heads=2, sk=sk)


def test_clis_take_kv_quant(tmp_path, capsys, batched_calls):
    """``infer --kv-quant int8`` decodes through the batched step at B=1,
    ``serve_cli --kv-quant int8`` serves through it, and both refuse it with
    ``--quant`` on the fused lane."""
    from pydynet_tpu_torch.models.llama import infer, serve_cli

    common = ["--random-init", "--device", "cpu", "--max-new-tokens", "24",
              "--dtype", "float32", "--weights", str(tmp_path / "none.npz")]
    assert infer.main(common + ["--kv-quant", "int8"]) > 0
    assert batched_calls and all(c[0] == 1 and c[3] for c in batched_calls)
    n = len(batched_calls)
    assert serve_cli.main(common + ["--batch-size", "2", "--chunk", "4",
                                    "--kv-quant", "int8"]) > 0
    assert len(batched_calls) > n and all(c[3] for c in batched_calls)
    assert capsys.readouterr().out.count("--- [") == 4
    with pytest.raises(ValueError, match="mutually exclusive"):
        infer.main(common + ["--kv-quant", "int8", "--quant", "int8"])
    with pytest.raises(ValueError, match="mutually exclusive"):
        serve_cli.main(common + ["--kv-quant", "int8", "--quant", "int4"])
