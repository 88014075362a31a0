"""Grouped-query models on the port's fused lane (the decode kernels'
narrow mode) against the JAX package, on the CPU.

A grouped-query model (``n_kv_heads < n_heads``) keeps (N, [B,] S, Hkv *
hd) cache rows on the fused lane, query head h reading KV head
``h // (H / Hkv)``; with int8/int4 layers it runs the expanded (MHA)
layout, as the JAX package does. Weights come from a seeded JAX model and
reach the port through ``params_from_tpu``. The JAX decode kernels run in
interpret mode; the port's steps run their plain versions because the
tensors are on the CPU. JAX's narrow caches are lane-padded to 128 with
zeros: the port's Dkv columns are compared with their first Dkv.
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
from pydynet_tpu_torch.models.llama import infer
from pydynet_tpu_torch.models.llama.model import (decode_quant_kwargs,
                                                  decode_weight_args)
from pydynet_tpu_torch.models.llama.serve import LlamaServer
from pydynet_tpu_torch.ops import decode_step as tdsk

# tests/test_llama.py's narrow-KV config: Dkv = 2 * 16 = 32 against D = 128
GQA = dict(vocab_size=256, embed_dim=128, n_heads=8, n_kv_heads=2,
           ffn_dim=64, max_seq_len=32, max_batch_size=3, n_layers=2)
# one layer of it: the tests that drive JAX's kernels in interpret mode
# through a whole generate or server pay for depth
GQA_1L = dict(GQA, n_layers=1)
# stories15M's widths with bench.py's GQA_15M heads (Dkv = 96), cut to one
# layer and 64 cache rows
GQA_15M = dict(vocab_size=32000, embed_dim=288, n_heads=6, n_kv_heads=2,
               ffn_dim=768, max_seq_len=64, max_batch_size=1, n_layers=1)
STARTS = np.array([0, 2, 5], np.int32)  # row 2 starts at the first step
IDS = np.array([[1, 5, 9], [2, 7, 3], [30, 20, 10]])
SAMPLED = dict(temperature=1.1, top_k=20, seed=5)


def models(seed, cfg=GQA):
    """A seeded JAX model and its port, with the same weights."""
    np.random.seed(seed)
    jm = JLlama(dtype=np.float32, **cfg)
    jm.eval()
    tm = Llama(**cfg, device="cpu")
    tm.load_state_dict(params_from_tpu(
        {n: p.numpy() for n, p in jm._parameters.items()}), strict=True)
    return jm, tm.eval()


@pytest.fixture
def interp(monkeypatch):
    """The JAX package's decode kernels in interpret mode."""
    for name in ("fused_decode_token", "fused_decode_token_batched"):
        monkeypatch.setattr(jdsk, name, functools.partial(
            getattr(jdsk, name), interpret=True))


@pytest.fixture
def step_calls(monkeypatch):
    """The port's decode-step wrapper calls: (rows, n_kv_heads, cache
    width) each."""
    calls = []
    for name in ("fused_decode_token", "fused_decode_token_batched"):
        real = getattr(tdsk, name)

        def spy(*args, _real=real, **kwargs):
            calls.append((args[1].shape[0], kwargs.get("n_kv_heads"),
                          args[17].shape[-1]))
            return _real(*args, **kwargs)

        monkeypatch.setattr(tdsk, name, spy)
    return calls


def rows(gen):
    """A generate stream as a (T, B) array."""
    return np.concatenate([t.numpy() for t in gen], axis=1).T


def _narrow_rows(cfg, seed, batch=None):
    """Seeded random narrow cache rows (N, [B,] S, Dkv), float32."""
    N, S = cfg["n_layers"], cfg["max_seq_len"]
    dkv = cfg["n_kv_heads"] * cfg["embed_dim"] // cfg["n_heads"]
    shape = (N, S, dkv) if batch is None else (N, batch, S, dkv)
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 0.5).astype(np.float32)
            for _ in range(2)]


def _pad(c):
    d = c.shape[-1]
    return np.pad(c, ((0, 0),) * (c.ndim - 1)
                  + ((0, jdsk.lane_pad_dim(d) - d),))


def _jax_steps(jm):
    """The JAX model's own (fused_step, fused_step_batched): its narrow
    keyword plumbing, the kernels as the ``interp`` fixture left them."""
    jm._fused_chunk_fn = None
    return jm._make_fused_decode_fns()[5:7]


@pytest.mark.parametrize("quant", [None, "int8-head"])
def test_k1_narrow_plain_step_matches_jax_kernel(interp, quant):
    """Two B=1 steps over seeded narrow cache rows: JAX's K1 (narrow, in
    interpret mode, emit_logits) against the port's plain step. float32 in
    both, summation order apart: logits within 1e-5 of their scale (the
    int8 head: 1e-3, an activation a rounding step apart moves a logit by
    about max |w| * amax / 127), the same argmax as the greedy mode, caches
    within 1e-5."""
    jm, tm = models(1)
    jw = jm._fused_weights(None, quant)
    tw = tm._fused_weights(None, quant)
    assert tw["wk_n"].shape == (2, 32, 128) and tw["n_kv_heads"] == 2
    assert "wk" not in tw and decode_quant_kwargs(tw)["n_kv_heads"] == 2
    fused_step, _ = _jax_steps(jm)
    ck, cv = _narrow_rows(GQA, 2)
    jck, jcv = jnp.asarray(_pad(ck)), jnp.asarray(_pad(cv))
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    tol = 1e-5 if quant is None else 1e-3
    tok = 17
    for pos in (5, 6):
        want, jck, jcv = fused_step(jw, jck, jcv, jnp.asarray([tok],
                                                               jnp.int32),
                                    pos, emit_logits=True)
        want = np.asarray(want)[0]
        args = (torch.tensor([pos], dtype=torch.int32),
                torch.tensor([tok], dtype=torch.int32),
                *decode_weight_args(tw))
        gck, gcv = tck.clone(), tcv.clone()
        got = tdsk.fused_decode_token(*args, tck, tcv, n_heads=8,
                                      emit_logits=True,
                                      **decode_quant_kwargs(tw))[0].numpy()
        greedy = tdsk.fused_decode_token(*args, gck, gcv, n_heads=8,
                                         **decode_quant_kwargs(tw))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=tol * scale)
        assert got.argmax() == want.argmax() == int(greedy[0])
        for mine, theirs in ((tck, jck), (tcv, jcv)):
            np.testing.assert_allclose(mine.numpy(),
                                       np.asarray(theirs)[..., :32],
                                       atol=1e-5)
            assert not np.asarray(theirs)[..., 32:].any()
        tok = int(want.argmax())


@pytest.mark.parametrize("kv8", [False, True], ids=["float", "kv8"])
def test_k2_narrow_plain_step_matches_jax_kernel(interp, kv8):
    """Two B=3 steps with per-row starts (row 2 starting at the first
    step) over seeded narrow rows: JAX's K2 (narrow, interpret mode,
    emit_logits) against the port's plain batched step. Float caches:
    logits within 1e-5 of their scale, caches within 1e-5. The int8 KV
    cache (rows and scales from one ``quantize_kv`` over the Dkv-wide
    rows): logits within 1e-4 of their scale (a query or K/V element a
    rounding step apart moves a score by about |x| * s / 127), int8
    entries at most one apart, scales within 1e-6 relative."""
    jm, tm = models(3)
    jw = jm._fused_weights(None, None)
    tw = tm._fused_weights(None, None)
    _, fused_step_batched = _jax_steps(jm)
    ck, cv = _narrow_rows(GQA, 4, batch=3)
    if kv8:
        (tck, tsk), (tcv, tsv) = (tdsk.quantize_kv(torch.from_numpy(c))
                                  for c in (ck, cv))
        jck = (jnp.asarray(_pad(tck.numpy())), jnp.asarray(tsk.numpy()))
        jcv = (jnp.asarray(_pad(tcv.numpy())), jnp.asarray(tsv.numpy()))
        kv = dict(sk=tsk, sv=tsv)
    else:
        tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
        jck, jcv = jnp.asarray(_pad(ck)), jnp.asarray(_pad(cv))
        kv = {}
    toks = np.array([17, 200, 3], np.int32)
    for pos in (5, 6):
        want, jck, jcv = fused_step_batched(
            jw, jck, jcv, jnp.asarray(toks), pos, emit_logits=True,
            starts=jnp.asarray(STARTS))
        want = np.asarray(want)
        got = tdsk.fused_decode_token_batched(
            torch.tensor([pos], dtype=torch.int32), torch.from_numpy(toks),
            *decode_weight_args(tw), tck, tcv, n_heads=8,
            starts=torch.from_numpy(STARTS), emit_logits=True,
            **decode_quant_kwargs(tw), **kv).numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want,
                                   atol=(1e-4 if kv8 else 1e-5) * scale)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        if kv8:
            for mine, theirs in ((tck, jck[0]), (tcv, jcv[0])):
                diff = np.abs(mine.numpy().astype(np.int32)
                              - np.asarray(theirs)[..., :32].astype(np.int32))
                assert diff.max() <= 1
            np.testing.assert_allclose(tsk.numpy(), np.asarray(jck[1]),
                                       rtol=1e-6)
            np.testing.assert_allclose(tsv.numpy(), np.asarray(jcv[1]),
                                       rtol=1e-6)
        else:
            for mine, theirs in ((tck, jck), (tcv, jcv)):
                np.testing.assert_allclose(mine.numpy(),
                                           np.asarray(theirs)[..., :32],
                                           atol=1e-5)
        toks = want.argmax(-1).astype(np.int32)


def test_k1_narrow_plain_step_at_stories15m_widths(interp):
    """One B=1 step at stories15M's widths with 2 KV heads (Dkv 96, 32,000
    vocab rows, one layer): JAX's K1 in narrow mode against the port's
    plain step, logits within 1e-5 of their scale, caches within 1e-5."""
    jm, tm = models(5, GQA_15M)
    jw = jm._fused_weights(None, None)
    tw = tm._fused_weights(None, None)
    fused_step, _ = _jax_steps(jm)
    ck, cv = _narrow_rows(GQA_15M, 6)
    pos, tok = 40, 1234
    want, jck, jcv = fused_step(jw, jnp.asarray(_pad(ck)),
                                jnp.asarray(_pad(cv)),
                                jnp.asarray([tok], jnp.int32), pos,
                                emit_logits=True)
    want = np.asarray(want)[0]
    tck, tcv = torch.from_numpy(ck), torch.from_numpy(cv)
    got = tdsk.decode_token_logits_ref(
        torch.tensor([pos], dtype=torch.int32),
        torch.tensor([tok], dtype=torch.int32), *decode_weight_args(tw),
        tck, tcv, n_heads=6, n_kv_heads=2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    assert got.argmax() == want.argmax()
    np.testing.assert_allclose(tck.numpy(), np.asarray(jck)[..., :96],
                               atol=1e-5)
    np.testing.assert_allclose(tcv.numpy(), np.asarray(jcv)[..., :96],
                               atol=1e-5)


@pytest.mark.parametrize("case", [
    dict(B=1), dict(B=3), dict(B=1, **SAMPLED), dict(B=3, **SAMPLED),
    dict(B=1, kv_quant="int8"), dict(B=3, kv_quant="int8")],
    ids=["b1", "b3", "b1-sampled", "b3-sampled", "b1-kv8", "b3-kv8"])
def test_gqa_generate_runs_narrow_kernels_and_matches_jax(case, interp,
                                                          step_calls):
    """``generate(fused=None)`` on a grouped-query model runs the narrow
    mode (K1 at B=1, K2 at B>1 and with the int8 KV cache), one call a
    decode token with 32-wide caches and ``n_kv_heads=2``, and its stream
    equals the JAX package's ``generate(fused=False)`` token for token (its
    own tests hold its narrow lane to that lane). The int8 KV cache's
    stream is held to JAX's own int8 KV lane, its narrow K2 in interpret
    mode: quantization noise parts it from the float stream here at the
    first decode step of row 0."""
    case = dict(case)
    B = case.pop("B")
    jm, tm = models(7)
    ids = IDS[:B]
    with pdn.no_grad():
        want = rows(jm.generate(ids, 12, chunk=5,
                                fused="kv_quant" in case, **case))
    got = rows(tm.generate(ids, 12, chunk=5, **case))
    assert got.shape == (9, B)
    np.testing.assert_array_equal(got, want)
    assert step_calls == [(B, 2, 32)] * 8


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_gqa_quantized_layers_run_expanded_layout(quant, step_calls):
    """int8/int4 layers of a grouped-query model: the snapshot's wk/wv and
    their scales equal the JAX package's expanded ``wk_q``/``wv_q`` (each KV
    head's rows repeated to its query group before quantizing; torch's
    (out, in) layout of JAX's (in, out)), and ``generate`` runs the
    quantized modes on (N, [B,] S, D) caches with no ``n_kv_heads``, its
    stream equal to JAX's fused lane (interpret mode): int8 at B=1 (K1),
    int4 at B=3 (K2)."""
    jm, tm = models(9, GQA_1L)
    jw = jm._fused_weights(None, quant)
    tw = tm._fused_weights(None, quant)
    assert "wk_n" not in tw and "n_kv_heads" not in tw
    for i, name in enumerate(("wk", "wv")):
        tq = tw[name + "_q"]  # (N, D, D or D / 2): the expanded rows
        assert tq.shape == (1, 128, 64 if quant == "int4" else 128)
        np.testing.assert_array_equal(tq.transpose(1, 2).numpy(),
                                      np.asarray(jw[name + "_q"]))
        np.testing.assert_array_equal(
            tw[name + "_s"].numpy(), np.asarray(jw["s_attn"])[:, 1 + i])
    jfs = jdsk.fused_decode_token
    jfb = jdsk.fused_decode_token_batched
    jdsk.fused_decode_token = functools.partial(jfs, interpret=True)
    jdsk.fused_decode_token_batched = functools.partial(jfb, interpret=True)
    try:
        jm._fused_chunk_fn = None
        B = 1 if quant == "int8" else 3
        with pdn.no_grad():
            want = rows(jm.generate(IDS[:B], 8, chunk=5, fused=True,
                                    quant=quant))
        del step_calls[:]
        got = rows(tm.generate(IDS[:B], 8, chunk=5, quant=quant))
        np.testing.assert_array_equal(got, want)
        assert step_calls == [(B, None, 128)] * 4
    finally:
        jdsk.fused_decode_token, jdsk.fused_decode_token_batched = jfs, jfb
        jm._fused_chunk_fn = None


@pytest.mark.parametrize("kw", [{}, dict(kv_quant="int8"),
                                dict(quant="int8")],
                         ids=["float", "kv8", "int8"])
def test_gqa_server_matches_jax_server(interp, kw, step_calls):
    """A grouped-query ``LlamaServer`` (B=2 slots, slot recycling, shifted
    admissions) keeps narrow (N, B, S, 32) caches (int8 layers: the
    expanded (N, B, S, 128) layout) and serves the JAX server's streams
    (its batched kernel in interpret mode) token for token."""
    jm, tm = models(11, dict(GQA_1L, max_batch_size=2))
    requests = [([1, 5, 9], 5), ([2, 7, 3, 11], 3), ([30, 20], 5)]
    with pdn.no_grad():
        js = JServer(jm, batch_size=2, chunk=4, eos_id=-1, **kw)
        jr = [js.submit(p, max_new_tokens=n) for p, n in requests]
        jd = js.run()
    srv = LlamaServer(tm, batch_size=2, chunk=4, eos_id=-1, **kw)
    width = 128 if kw.get("quant") else 32
    ck = srv._ck[0] if kw.get("kv_quant") else srv._ck
    assert ck.shape == (1, 2, 32, width)
    tr = [srv.submit(p, max_new_tokens=n) for p, n in requests]
    td = srv.run()
    assert [td[r].tokens for r in tr] == [jd[r].tokens for r in jr]
    hkv = None if kw.get("quant") else 2
    assert step_calls == [(2, hkv, width)] * srv.dispatched_steps


def test_infer_cli_decodes_gqa_checkpoint(tmp_path, step_calls, capsys):
    """A grouped-query npz (HF names, ``config.n_kv_heads``) decodes through
    the narrow mode of the fused lane from the infer CLI, with no flag."""
    jm, _ = models(13)
    P = {n: p.numpy() for n, p in jm._parameters.items()}
    hf = {"model.embed_tokens.weight": P["tok_embedding.weight"],
          "lm_head.weight": P["lm_head.weight"].T,
          "model.norm.weight": P["norm.weight"], "config.n_kv_heads": 2}
    names = {"self_attn.q_proj": "attention.Q", "self_attn.k_proj":
             "attention.K", "self_attn.v_proj": "attention.V",
             "self_attn.o_proj": "attention.O", "mlp.up_proj": "ffn.up",
             "mlp.gate_proj": "ffn.gate", "mlp.down_proj": "ffn.down"}
    for i in range(2):
        for theirs, ours in names.items():
            hf[f"model.layers.{i}.{theirs}.weight"] = \
                P[f"layers.{i}.{ours}.weight"].T
        hf[f"model.layers.{i}.input_layernorm.weight"] = \
            P[f"layers.{i}.input_norm.weight"]
        hf[f"model.layers.{i}.post_attention_layernorm.weight"] = \
            P[f"layers.{i}.post_attn_norm.weight"]
    path = tmp_path / "gqa.npz"
    np.savez(path, **hf)
    rate = infer.main(["--device", "cpu", "--weights", str(path),
                       "--max-new-tokens", "12", "--prompt", "Once"])
    assert rate > 0 and step_calls
    assert all(c[1:] == (2, 32) for c in step_calls)
    assert "tokens/s" in capsys.readouterr().out


def test_narrow_step_rejects_quantized_layers_and_bad_heads():
    """The narrow cache takes float layers only (the expanded layout runs
    int8/int4), and n_kv_heads must divide n_heads and match the caches."""
    _, tm = models(15)
    w8 = tm._fused_weights(None, "int8")
    w = tm._fused_weights(None, None)
    pos, tok = (torch.tensor([3], dtype=torch.int32),) * 2
    ck, cv = (torch.zeros(2, 32, 32) for _ in range(2))
    narrow8 = list(decode_weight_args(w8))
    narrow8[5:7] = [t[:, :32] for t in narrow8[5:7]]  # narrow wk/wv rows
    with pytest.raises(ValueError, match="expanded"):
        tdsk.fused_decode_token(pos, tok, *narrow8, ck, cv, n_heads=8,
                                n_kv_heads=2, **decode_quant_kwargs(w8))
    with pytest.raises(ValueError, match="divide"):
        tdsk.fused_decode_token(pos, tok, *decode_weight_args(w), ck, cv,
                                n_heads=8, n_kv_heads=3)
    with pytest.raises(ValueError, match="expected"):
        tdsk.fused_decode_token(pos, tok, *decode_weight_args(w), ck, cv,
                                n_heads=8)  # MHA wants 128-wide k/v rows
    assert tdsk.kernel_takes(128, 8, 64, n_kv_heads=2)
    assert not tdsk.kernel_takes(128, 8, 64, n_kv_heads=3)
    assert tdsk.batched_kernel_takes(288, 6, 768, 64, n_kv_heads=2)
