"""The port's quantized matmuls (``ops/gemv_quant.py``, ``ops/quant.py``)
and its quantized scan lane against the JAX package's, on the CPU.

Inputs are made with NumPy from a seed. The JAX kernels run in interpret
mode, as ``tests/test_gemv_quant.py`` runs them, and its model through its
``xinterp`` weights; the port's wrappers run their plain versions because
the tensors are on the CPU. The integer arithmetic is exact, so results are
compared bit for bit and token streams token for token.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import pydynet_tpu as pdn
from pydynet_tpu.models.llama.model import Llama as JLlama
from pydynet_tpu.ops import gemv_quant as jgq
from pydynet_tpu.ops import quant as jquant

from pydynet_tpu_torch.models.llama import Llama, params_from_tpu
from pydynet_tpu_torch.models.llama import model as tmodel
from pydynet_tpu_torch.ops import gemv_quant as tgq
from pydynet_tpu_torch.ops import quant as tquant
from pydynet_tpu_torch.utils import fidelity as tfid

# tests/test_gemv_quant.py's model config
CFG = dict(vocab_size=512, embed_dim=64, n_heads=4, ffn_dim=128,
           max_seq_len=64, max_batch_size=1, n_layers=2)
STORIES15M = dict(vocab_size=32000, embed_dim=288, n_heads=6, ffn_dim=768,
                  max_seq_len=1024, n_layers=6)
LLAMA2_7B = dict(vocab_size=32000, embed_dim=4096, n_heads=32,
                 ffn_dim=11008, max_seq_len=1024, n_layers=32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


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


def stream(gen):
    return [int(t[0, 0]) for t in gen]


def jstream(jm, ids, total, **kw):
    with pdn.no_grad():
        return [int(t.numpy()[0, 0]) for t in jm.generate(ids, total, **kw)]


@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_int4_matches_jax_exactly(axis):
    rng = np.random.default_rng(axis)
    w = (rng.standard_normal((40, 24)) * 0.3).astype(np.float32)
    w[:, 3] = 0.0  # all-zero channels exercise the 1e-30 floor
    w[3, :] = 0.0
    w[5, 7] = 7.5 * np.abs(w[:, 7]).max() / 7.0  # a half step of int4
    jq, js = jquant.quantize_int4(jnp.asarray(w), axis=axis)
    tq, ts = tquant.quantize_int4(t(w), axis=axis)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for a, b in zip(tquant.unpack_int4(tq), jquant.unpack_int4(jq)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        tquant.dequantize_int4(tq, ts, axis=axis).numpy(),
        np.asarray(jquant.dequantize_int4(jq, js, axis=axis)))
    tq8, ts8 = tquant.quantize_int8(t(w), axis=axis)
    jq8, js8 = jquant.quantize_int8(jnp.asarray(w), axis=axis)
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(ts8.numpy(), np.asarray(js8))
    with pytest.raises(ValueError, match="odd"):
        tquant.quantize_int4(t(w[:, :5]), axis=1)


@pytest.mark.parametrize("K", [288, 768, 512])
@pytest.mark.parametrize("M", [1, 3, 4, 8, 32, 33, 300])
def test_qmatmul_matches_jax_exactly(M, K):
    """The plain qmatmul against JAX's kernel (interpret mode) and its NumPy
    mirror, int8 and int4, across the decode-row bound (32) and the TPU's
    prefill slabs (256), at N = 864 (stories15M's fused qkv width)."""
    N = 864
    rng = np.random.default_rng(M * 1000 + K)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[0] = 0.0  # an all-zero row exercises the 1e-30 floor
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    for q4, qfn in ((False, jquant.quantize_int8),
                    (True, jquant.quantize_int4)):
        jq, js = qfn(jnp.asarray(w), 0)
        want = np.asarray(jgq.qmatmul(jnp.asarray(x), jq, js, q4=q4,
                                      interpret=True))
        np.testing.assert_array_equal(
            want, jgq.qmatmul_ref(x, np.asarray(jq), np.asarray(js), q4=q4))
        tq, ts = (tquant.quantize_int4 if q4 else tquant.quantize_int8)(
            t(w), 0)
        got = tgq.qmatmul(t(x), tq, ts, q4=q4)
        assert got.dtype == torch.float32 and got.shape == (M, N)
        np.testing.assert_array_equal(got.numpy(), want)
    xq, sx = tgq.quantize_rows(t(x))
    assert xq.dtype == torch.int8 and sx.shape == (M, 1)


def test_qmatmul_bf16_rows_and_the_vocab_width():
    """bf16 activations widen exactly; the head's N = 32000."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((4, 288)).astype(np.float32))
    x16 = x.to(torch.bfloat16)
    w = (rng.standard_normal((288, 32000)) * 0.05).astype(np.float32)
    for q4 in (False, True):
        qfn = jquant.quantize_int4 if q4 else jquant.quantize_int8
        jq, js = qfn(jnp.asarray(w), 0)
        want = jgq.qmatmul_ref(x16.float().numpy(), np.asarray(jq),
                               np.asarray(js), q4=q4)
        got = tgq.qmatmul(x16, t(np.asarray(jq)), t(np.asarray(js)), q4=q4)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("M", [2, 40])
def test_qmatmul_stacked_matches_jax_exactly(M):
    """Layer idx of stacked weights, as a Python int and as a 0-d int32
    tensor, equals JAX's qmatmul_stacked (interpret mode) bit for bit."""
    rng = np.random.default_rng(11 + M)
    L, K, N = 3, 256, 512
    x = rng.standard_normal((M, K)).astype(np.float32)
    for q4 in (False, True):
        qfn = jquant.quantize_int4 if q4 else jquant.quantize_int8
        qs = [qfn(jnp.asarray(rng.standard_normal((K, N)).astype(
            np.float32) * 0.05), 0) for _ in range(L)]
        jw = jnp.stack([q for q, _ in qs])
        js = jnp.stack([s for _, s in qs])
        tw, ts = t(np.asarray(jw)), t(np.asarray(js))
        for i in range(L):
            want = np.asarray(jgq.qmatmul_stacked(jnp.asarray(x), jw, js, i,
                                                  q4=q4, interpret=True))
            for idx in (i, torch.tensor(i, dtype=torch.int32)):
                got = tgq.qmatmul_stacked(t(x), tw, ts, idx, q4=q4)
                np.testing.assert_array_equal(got.numpy(), want)
        with pytest.raises(ValueError, match="outside"):
            tgq.qmatmul_stacked(t(x), tw, ts, L, q4=q4)


def test_qmatmul_rejects_bad_arguments():
    x = torch.zeros(2, 64)
    q, s = tquant.quantize_int8(torch.ones(64, 8), 0)
    with pytest.raises(ValueError, match="does not match"):
        tgq.qmatmul(x, q, s, q4=True)
    with pytest.raises(ValueError, match="ws"):
        tgq.qmatmul(x, q, s.double())
    with pytest.raises(ValueError, match="x:"):
        tgq.qmatmul(x.half(), q, s)
    with pytest.raises(ValueError, match="idx"):
        tgq.qmatmul_stacked(x, q[None], s[None], torch.tensor(0))
    with pytest.raises(ValueError, match="device"):
        tgq.qmatmul(x.to("meta"), q.to("meta"), s.to("meta"))


@pytest.mark.parametrize("quant", ["int8", "int4", "int8-head"])
def test_weights_xq_matches_jax_exactly(quant):
    """The scan lane's quantized snapshot equals JAX's ``_weights_xq`` on
    the same parameters: (L, K, N) matrices and (L, 1, N) scales."""
    jm, tm = models(0)
    jw = jm._weights_xq(None, quant)
    tw = tm._weights_xq(None, quant)
    mats = ["head"] + ([] if quant == "int8-head"
                       else ["wqkv", "wo", "wgu", "down"])
    for name in mats:
        for suffix in ("_xq", "_xs"):
            np.testing.assert_array_equal(tw[name + suffix].numpy(),
                                          np.asarray(jw[name + suffix]))
    assert ("q4" in tw) == ("q4" in jw) == (quant == "int4")
    assert "head_w" not in tw
    if quant != "int8-head":  # no dense copy of a quantized matrix
        assert not {"wqkv", "wo", "wgu", "down"} & set(tw)
        assert not tm._weights_cache.get((None, "dense", None))
    assert tm._weights_xq(None, quant) is tw


@pytest.mark.parametrize("quant", ["int8", "int8-head", "int4"])
@pytest.mark.parametrize("L", [3, 9])
def test_generate_quant_matches_jax(quant, L):
    """``generate(quant=q, fused=False)`` token for token against the JAX
    package's scan lane on the same weights, float32, across the prompt
    bucketing edge (3 -> 8, 9 -> 16) and two decode chunks."""
    jm, tm = models(L)
    ids = (np.arange(L)[None] * 37 + 1) % 512
    want = jstream(jm, ids, 24, fused=False, quant=quant)
    got = stream(tm.generate(ids, 24, chunk=8, fused=False, quant=quant))
    assert got == want and len(got) == 24 - L


def test_batched_rows_match_b1():
    """Activation scales are per row, so a B=2 quantized decode equals the
    two B=1 decodes row for row (``test_gemv_quant.py:171``)."""
    _, tm = models(0, max_batch_size=2)
    ids = np.array([[1, 5, 9], [1, 7, 2]])
    for quant in ("int8", "int4"):
        rows = torch.cat(list(tm.generate(ids, 20, fused=False,
                                          quant=quant)), 1)
        for b in range(2):
            assert rows[b].tolist() == stream(tm.generate(
                ids[b:b + 1], 20, fused=False, quant=quant))


def test_stacked_path_matches_per_layer(monkeypatch):
    """Above ``UNROLL_MAX_LAYERS`` layers the scan lane reads the stacked
    weights through ``qmatmul_stacked`` with a layer index; its streams
    equal the per-layer ``qmatmul`` path's (``test_gemv_quant.py:252``)."""
    _, tm = models(0, n_layers=3)
    ids = np.array([[1, 5, 9]])
    calls = []
    real = tgq.qmatmul_stacked

    def spy(*args, **kwargs):
        calls.append(int(args[3]))
        return real(*args, **kwargs)

    monkeypatch.setattr(tgq, "qmatmul_stacked", spy)
    for quant in ("int8", "int4"):
        per_layer = stream(tm.generate(ids, 20, fused=False, quant=quant))
        assert not calls
        monkeypatch.setattr(tmodel, "UNROLL_MAX_LAYERS", 1)
        stacked = stream(tm.generate(ids, 20, fused=False, quant=quant))
        monkeypatch.setattr(tmodel, "UNROLL_MAX_LAYERS", 16)
        assert stacked == per_layer, (quant, stacked, per_layer)
        # prefill and 16 decode steps, 4 matmuls on each of 3 layers
        assert calls == ([0] * 4 + [1] * 4 + [2] * 4) * 17
        calls.clear()


def test_int4_vs_dequantized_truth():
    """int4's weight error would swamp a dense comparison; against the same
    model with its weights round-tripped through int4 (``dequant_inplace``,
    equal to JAX's ``dequant_int4_inplace``), the lane differs only by the
    activation quantization (``test_gemv_quant.py:135``)."""
    jm, tm = models(0)
    truth_model = models(0)[1]
    tfid.dequant_int4_inplace(truth_model)
    from pydynet_tpu.utils.fidelity import dequant_int4_inplace
    dequant_int4_inplace(jm)
    for name, p in truth_model.named_parameters():
        want = jm._parameters[name].numpy()
        got = p.detach().numpy()
        np.testing.assert_array_equal(got.T if got.ndim == 2 and
                                      name != "tok_embedding.weight"
                                      else got, want)
    ids = np.array([[1, 5, 9]])
    truth = stream(truth_model.generate(ids, 24, fused=False))
    got = stream(tm.generate(ids, 24, fused=False, quant="int4"))
    agree = np.mean([a == b for a, b in zip(truth, got)])
    assert agree >= 0.75, (agree, got, truth)
    # the teacher-forced majority gate of the same lane
    tr, mg, tp = tfid.scan_truth(truth_model, ids, 16)
    assert tr[:, 0].tolist() == truth[:16]
    checked, ok, frac = tfid.gate_scan_argmax(tm, ids, tr, mg, tp,
                                              quant="int4", min_agree=0.75)
    assert checked == 16 and ok, frac
    with pytest.raises(ValueError):
        tfid.dequant_inplace(truth_model, "int2")


def test_scan_gate_confident_steps():
    """The confident-step gate passes the lane against its own truth and
    fails a lane that emits other tokens."""
    _, tm = models(2)
    ids = np.array([[1, 5, 9]])
    tr, mg, tp = tfid.scan_truth(tm, ids, 12)
    assert tr[:, 0].tolist() == stream(tm.generate(ids, 15, fused=False))
    checked, ok, frac = tfid.gate_scan_argmax(tm, ids, tr, mg, tp)
    assert checked > 0 and ok and frac == 1.0
    checked, ok, _ = tfid.gate_scan_argmax(tm, ids, (tr + 1) % 512, mg, tp)
    assert checked > 0 and not ok


def _dims(cfg):
    """A Llama of ``cfg``'s dims with no parameters, for the routing rule."""
    m = Llama.__new__(Llama)
    nn.Module.__init__(m)
    for k, v in cfg.items():
        setattr(m, k, v)
    m.n_kv_heads = cfg.get("n_kv_heads", cfg["n_heads"])
    m.head_dim = cfg["embed_dim"] // cfg["n_heads"]
    return m


@pytest.mark.parametrize("quant", [None, "int8-head", "int8", "int4"])
@pytest.mark.parametrize("cfg", [STORIES15M, LLAMA2_7B, CFG,
                                 dict(CFG, embed_dim=36, ffn_dim=60),
                                 dict(CFG, n_kv_heads=2)],
                         ids=["stories15M", "7B", "tiny", "unaligned", "gqa"])
def test_routing_rule_is_the_jax_rule(cfg, quant):
    """The port's copy of the JAX routing predicate equals JAX's
    ``_fused_decode_supported`` as a function of the dims."""
    m = _dims(cfg)
    assert m._tpu_fused_supported(quant) == \
        JLlama._fused_decode_supported(m, quant)


def test_routing_at_stories15m_and_7b():
    """``fused=None``: the fused lane where the port's kernels take the
    model, format and batch (int8/int4 on K1 at B=1, on K2 at B>1 and in a
    server); the scan lane where the JAX rule sends it (7B with int8/int4,
    or a batch K2 does not take at 7B); else raise."""
    small, big = _dims(STORIES15M), _dims(LLAMA2_7B)
    for B in (1, 4, 32):
        assert small.use_fused(None, B) and small.use_fused("int8-head", B)
        for quant in ("int8", "int4"):
            # K1's qlayers / q4 at B=1, K2's at B>1 and in a server
            assert small.use_fused(quant, B)
            assert small.use_fused(quant, B, batched=True)
            assert not small.use_fused(quant, B, fused=False)
            assert not big.use_fused(quant, B)
            assert not big.use_fused(quant, B, batched=True)
    for quant in ("int8", "int4"):  # K1 would take 7B, the JAX rule not
        with pytest.raises(NotImplementedError, match="Big-dims"):
            big.use_fused(quant, 1, fused=True)
    assert big.use_fused(None, 1) and big.use_fused(None, 4)  # K1, K2
    assert not big.use_fused(None, 8) and not big.use_fused("int8-head", 8)
    with pytest.raises(NotImplementedError, match="Big-dims"):
        big.use_fused(None, 8, fused=True)
    for B in (33, 64):  # K2's row groups: any B at stories15M
        assert small.use_fused(None, B) and small.use_fused("int4", B)
    with pytest.raises(ValueError, match="quant"):
        small.use_fused("fp8", 1)
