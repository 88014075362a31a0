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
from pydynet_tpu_torch.ops import gemv_quant as tgq
from pydynet_tpu_torch.ops import quant as tquant
from pydynet_tpu_torch.utils import fidelity as tfid

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

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


@pytest.mark.parametrize("M", [1, 4, 40])
def test_qmatmul_float16_rows_match_jax_exactly(M):
    """float16 rows (the decode kernel's M <= 32 and the prefill kernel's
    rows) widen exactly to float32 and quantize by the same rule: qmatmul
    and qmatmul_stacked (a Python and a device index) equal JAX's kernels
    in interpret mode on the same float16 rows bit for bit, int8 and int4,
    float32 out; and on rows of exact .5 steps (``half_step_rows``, exact
    in float16) the rounding is half to even as there."""
    rng = np.random.default_rng(40 + M)
    L, K, N = 2, 256, 512
    for x in (rng.standard_normal((M, K)).astype(np.float16),
              half_step_rows(M, K, rng).astype(np.float16)):
        for q4 in (False, True):
            qfn = jquant.quantize_int4 if q4 else jquant.quantize_int8
            qs = [qfn(jnp.asarray(rng.standard_normal((K, N)).astype(
                np.float32) * 0.05), 0) for _ in range(L)]
            jw = jnp.stack([q for q, _ in qs])
            js = jnp.stack([s for _, s in qs])
            tw, ts = t(np.asarray(jw)), t(np.asarray(js))
            want = np.asarray(jgq.qmatmul(jnp.asarray(x), qs[1][0],
                                          qs[1][1], q4=q4, interpret=True))
            assert want.dtype == np.float32
            got = tgq.qmatmul(t(x), tw[1], ts[1], q4=q4)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
            want = np.asarray(jgq.qmatmul_stacked(jnp.asarray(x), jw, js, 1,
                                                  q4=q4, interpret=True))
            for idx in (1, torch.tensor(1, dtype=torch.int32)):
                np.testing.assert_array_equal(
                    tgq.qmatmul_stacked(t(x), tw, ts, idx, q4=q4).numpy(),
                    want)
        xq, sx = tgq.quantize_rows(t(x))
        rq, rs = tgq.quantize_rows_ref(t(x.astype(np.float32)))
        assert torch.equal(xq, rq) and torch.equal(sx, rs)


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


def half_step_rows(M, K, rng):
    """Rows whose ``x * 127 / amax`` lands exactly on .5 steps in most
    entries: amax 254 (a scale of 127 / 254 = 0.5, exact) and odd
    integers, signed, so half to even and half away from zero differ;
    row 1 is all zero (the 1e-30 floor) and a -0.0 sits in row 0."""
    x = (2 * rng.integers(-127, 127, (M, K)) + 1).astype(np.float32)
    x[:, 0] = 254.0
    x[0, 1] = -0.0
    if M > 1:
        x[1] = 0.0
    return x


@pytest.mark.parametrize("M", [1, 3, 4, 32])
def test_half_steps_round_to_even_as_jax(M):
    """Rows on exact .5 steps pin the rounding (half to even, as
    ``jnp.round``): the port's row quantization and product equal JAX's
    kernel in interpret mode bit for bit, int8 and int4, float32 and
    bfloat16 rows (these integers are exact in bfloat16)."""
    rng = np.random.default_rng(M)
    K, N = 64, 96
    x = half_step_rows(M, K, rng)
    xq = tgq.quantize_rows_ref(t(x))[0].numpy()
    assert xq[0, 0] == 127 and set(np.abs(xq[2:, 1:]).ravel() % 2) <= {0}
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        xt = t(x).to(dtype)
        for q4, qfn in ((False, jquant.quantize_int8),
                        (True, jquant.quantize_int4)):
            jq, js = qfn(jnp.asarray(w), 0)
            want = np.asarray(jgq.qmatmul(jnp.asarray(xt.float().numpy()),
                                          jq, js, q4=q4, interpret=True))
            got = tgq.qmatmul(xt, t(np.asarray(jq)), t(np.asarray(js)),
                              q4=q4)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("K, q4", [(65, False), (66, False), (67, False),
                                   (66, True), (70, True), (74, True)])
def test_k_tails_match_jax(K, q4):
    """K with 1 to 3 bytes past a multiple of 4, and int4 halves (K / 2 =
    33, 35, 37) that are no multiple of 4: the port against JAX's kernel
    in interpret mode, bit for bit."""
    rng = np.random.default_rng(K)
    x = rng.standard_normal((3, K)).astype(np.float32)
    w = (rng.standard_normal((K, 40)) * 0.05).astype(np.float32)
    qfn = jquant.quantize_int4 if q4 else jquant.quantize_int8
    jq, js = qfn(jnp.asarray(w), 0)
    want = np.asarray(jgq.qmatmul(jnp.asarray(x), jq, js, q4=q4,
                                  interpret=True))
    got = tgq.qmatmul(t(x), t(np.asarray(jq)), t(np.asarray(js)), q4=q4)
    np.testing.assert_array_equal(got.numpy(), want)


# every quantized product of stories15M and Llama-2-7B: fused qkv, wo,
# fused gate/up, down, head
DECODE_SHAPES = {"stories15M": ((288, 864), (288, 288), (288, 1536),
                                (768, 288), (288, 32000)),
                 "7B": ((4096, 12288), (4096, 4096), (4096, 22016),
                        (11008, 4096), (4096, 32000))}


@pytest.mark.parametrize("q4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("model", list(DECODE_SHAPES))
def test_decode_plan_within_the_card(model, q4):
    """The decode kernel's launch plan at every shape of both models and
    every M in 1..32: a portable cluster whose blocks each hold rows and
    together cover K, whole ring stages, shared memory within a block's
    227 KB, a grid the card takes, and row tiles covering M with at most
    32 int32 sums a thread; at 7B every shape puts a block on each of the
    132 SMs at least, none of them streaming under 16 KB of weights."""
    for K, N in DECODE_SHAPES[model]:
        kst = K // 2 if q4 else K
        tiles = -(-N // tgq.DECODE_COLS)
        for M in range(1, tgq.MAX_DECODE_ROWS + 1):
            cluster, rows, chunk, mt, wm, stages, smem = tgq.decode_plan(
                q4, M, K, N)
            assert 1 <= cluster <= tgq.MAX_CLUSTER
            assert rows % tgq.DECODE_STAGE_ROWS == 0
            assert (cluster - 1) * rows < kst <= cluster * rows
            assert tgq.DECODE_STAGE_ROWS <= chunk <= rows
            assert chunk % tgq.DECODE_STAGE_ROWS == 0
            assert stages in (2, tgq.DECODE_STAGES)
            assert smem <= tgq.SMEM_MAX and tiles <= 65535
            assert mt in (1, 2, 4, 8) and wm in (1, 2, 4)
            assert M <= mt * wm <= max(8, 2 * M) and (wm == 1 or mt == 8)
            assert mt * 4 <= 32
            if model == "7B":
                assert cluster * tiles >= tgq.SMS
                last = kst - (cluster - 1) * rows
                assert min(rows, last) * tgq.DECODE_COLS > 16 * 1024
    # a K too long for one chunk of rows in shared memory is staged in
    # several (at M = 32, 64 KB of int8 rows take 2048 packed rows)
    cluster, rows, chunk, *_ = tgq.decode_plan(q4, 32, 32768, 256)
    assert chunk < rows and rows % chunk == 0


def test_qmatmul_rejects_bad_arguments():
    x = torch.zeros(2, 64)
    q, s = tquant.quantize_int8(torch.ones(64, 8), 0)
    with pytest.raises(ValueError, match="does not match"):
        tgq.qmatmul(x, q, s, q4=True)
    with pytest.raises(ValueError, match="ws"):
        tgq.qmatmul(x, q, s.double())
    with pytest.raises(ValueError, match="x:"):
        tgq.qmatmul(x.double(), q, s)
    assert torch.equal(tgq.qmatmul(x.half(), q, s), tgq.qmatmul(x, q, s))
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
    """The scan lane runs every layer product through ``qmatmul_stacked``
    with the layer's device index; its streams equal, bit for bit, the same
    lane with each product through ``qmatmul`` on that layer's weights
    (``test_gemv_quant.py:252``)."""
    _, tm = models(0, n_layers=3)
    ids = np.array([[1, 5, 9]])
    calls = []
    real = tgq.qmatmul_stacked

    def spy(*args, **kwargs):
        calls.append(int(args[3]))
        return real(*args, **kwargs)

    def per_layer(x, wq_all, ws_all, idx, q4=False):
        return tgq.qmatmul(x, wq_all[int(idx)], ws_all[int(idx)], q4=q4)

    for quant in ("int8", "int4"):
        monkeypatch.setattr(tgq, "qmatmul_stacked", spy)
        stacked = stream(tm.generate(ids, 20, fused=False, quant=quant))
        # prefill and 16 decode steps, 4 matmuls on each of 3 layers
        assert calls == ([0] * 4 + [1] * 4 + [2] * 4) * 17
        calls.clear()
        monkeypatch.setattr(tgq, "qmatmul_stacked", per_layer)
        assert stream(tm.generate(ids, 20, fused=False,
                                  quant=quant)) == stacked, quant
        w = tm._weights_xq(None, quant)
        x = torch.randn(5, 64, generator=torch.Generator().manual_seed(1))
        for name in ("wqkv", "wo", "wgu"):
            for i in range(3):
                assert torch.equal(
                    real(x, w[name + "_xq"], w[name + "_xs"],
                         w["layer_ids"][i], q4=quant == "int4"),
                    per_layer(x, w[name + "_xq"], w[name + "_xs"], i,
                              q4=quant == "int4"))


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
