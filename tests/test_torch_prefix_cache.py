"""The scan lane's int8 KV cache and prefix cache in the port, against the
JAX package on the CPU.

``generate(kv_quant="int8", fused=False)`` carries (int8 rows, per-(row,
head) float32 scales) caches through the prefill and the decode, with float,
int8 or int4 weights; ``LlamaServer(lane="xla", kv_quant=..., prefix_cache=
...)`` serves on them, and its prefix cache reuses a resident slot's rows
for a shared prompt prefix. Weights come from a seeded JAX model through
``params_from_tpu``; the JAX package's quantized matmuls run in interpret
mode, the port's their plain versions. Streams are float32 and must be
equal token for token, and the prefix cache's counters equal
(``tests/test_serve_xla.py``, ``tests/test_llama.py:606``).
"""
import numpy as np
import pytest
import torch

import pydynet_tpu as pdn
from pydynet_tpu.models.llama.model import Llama as JLlama
from pydynet_tpu.models.llama.serve import LlamaServer as JServer

from pydynet_tpu_torch.models.llama import Llama, params_from_tpu
from pydynet_tpu_torch.models.llama.serve import LlamaServer

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

# tests/test_serve_xla.py's tiny config
CFG = dict(vocab_size=256, embed_dim=32, n_heads=2, ffn_dim=64,
           max_seq_len=64, max_batch_size=2, n_layers=2)
PA = [1, 5, 9, 4, 7, 2, 8, 3, 6, 1, 2, 4]          # 12 tokens
PB = PA[:10] + [7, 5]                               # lcp 10 -> kb 8


def models(seed, **over):
    cfg = dict(CFG, **over)
    np.random.seed(seed)
    jm = JLlama(dtype=np.float32, **cfg)
    jm.eval()
    tm = Llama(**cfg, device="cpu")
    tm.load_state_dict(params_from_tpu(
        {n: p.numpy() for n, p in jm._parameters.items()}), strict=True)
    return jm, tm.eval()


def jrows(jm, ids, total, **kw):
    with pdn.no_grad():
        return np.concatenate([t.numpy() for t in jm.generate(
            ids, total, fused=False, **kw)], 1)


def trows(tm, ids, total, **kw):
    return torch.cat(list(tm.generate(ids, total, fused=False, **kw)),
                     1).numpy()


def standalone(tm, prompt, n_new, **kw):
    return trows(tm, np.asarray([prompt]), len(prompt) + n_new, **kw)[0] \
        .tolist()


def jserve(jm, script, **kw):
    """Run ``script(server)`` on a JAX server; returns what it returns and
    the server."""
    with pdn.no_grad():
        srv = JServer(jm, **kw)
        return script(srv), srv


def both(jm, tm, script, **kw):
    """``script`` on the JAX server and on the port's, with the same
    keyword arguments: returns (JAX result, port result, port server), the
    results with each server's prefix-cache counters appended."""
    out = []
    for make, m in ((JServer, jm), (LlamaServer, tm)):
        with pdn.no_grad():
            srv = make(m, **kw)
            res = script(srv)
        out.append((res, srv.prefix_hits, srv.prefix_rows_reused))
    return out[0], out[1], srv


XLA = dict(batch_size=2, chunk=4, eos_id=-1, lane="xla")


# ------------------- generate with the int8 KV cache ----------------------
@pytest.mark.parametrize("quant", [None, "int4"])
@pytest.mark.parametrize("B", [1, 3])
def test_generate_kv_quant_scan_lane_matches_jax(quant, B):
    """``generate(kv_quant="int8", fused=False)`` at B=1 and 3, with float
    and int4 weights, token for token against the JAX package's scan lane:
    two decode chunks and a bucket-padded prompt."""
    jm, tm = models(8, max_seq_len=32, max_batch_size=3)
    ids = np.array([[1, 5, 9], [2, 7, 3], [30, 20, 10]])[:B]
    want = jrows(jm, ids, 14, chunk=5, quant=quant, kv_quant="int8")
    got = trows(tm, ids, 14, chunk=5, quant=quant, kv_quant="int8")
    assert got.shape == (B, 11) and np.array_equal(got, want)


def test_generate_kv_quant_sampled_flash_unbucketed():
    """The int8 pairs under sampling, the flash prefill (which attends the
    unquantized fresh rows, as the JAX package's) and an unpadded prefill:
    each against the JAX package's same call."""
    jm, tm = models(8, max_seq_len=32, max_batch_size=3)
    ids = np.array([[1, 5, 9, 4, 2], [2, 7, 3, 3, 8]])
    for kw in (dict(temperature=0.8, top_k=20, seed=3),
               dict(flash_prefill="interpret"),
               dict(bucket_prefill=False, quant="int8")):
        tkw = dict(kw, flash_prefill=True) if "flash_prefill" in kw else kw
        want = jrows(jm, ids, 16, chunk=4, kv_quant="int8", **kw)
        assert np.array_equal(trows(tm, ids, 16, chunk=4, kv_quant="int8",
                                    **tkw), want), kw


def test_kv_quant_caches_are_int8_pairs():
    """The scan lane's int8 KV cache: (int8 (N, B, S, Hkv, hd), float32
    (N, B, S, Hkv)) pairs, zero scales where nothing was written, each
    written row's scale its (row, head) absmax / 127."""
    _, tm = models(8)
    ck, cv = tm._empty_caches(2, torch.float32, "int8")
    assert ck[0].dtype == torch.int8 and ck[0].shape == (2, 2, 64, 2, 16)
    assert ck[1].dtype == torch.float32 and ck[1].shape == (2, 2, 64, 2)
    assert not ck[1].any()
    w = tm._weights(None)
    tm.prefill(w, ck, cv, np.array([[1, 5, 9], [2, 7, 3]]))
    rows = ck[0][:, :, :3].float() * ck[1][:, :, :3, :, None]
    assert torch.equal(ck[0][:, :, :3].abs().amax(-1).float(),
                       torch.full((2, 2, 3, 2), 127.0))
    assert (rows.abs().amax(-1) / ck[1][:, :, :3] - 127).abs().max() < 1e-4
    assert not ck[1][:, :, 3:].any()


@pytest.mark.parametrize("qkv", [(None, None), ("int8", "int8"),
                                 ("int8", None), ("int4", "int8")])
def test_chunk_invariance_quant_by_kv_quant(qkv):
    """The oracle of ``tests/test_llama.py:642-650``: chunk 5 and chunk 3
    decode the same tokens under every weight format and KV format (the
    per-step arithmetic is the same; only the read-backs move)."""
    quant, kv = qkv
    _, tm = models(8, max_seq_len=32, max_batch_size=3)
    ids = np.array([[1, 5, 9], [2, 7, 3], [30, 20, 10]])
    a = trows(tm, ids, 14, chunk=5, quant=quant, kv_quant=kv)
    b = trows(tm, ids, 14, chunk=3, quant=quant, kv_quant=kv)
    assert a.shape == (3, 11) and np.array_equal(a, b)


# ---------------- the scan-lane server with the int8 KV cache --------------
def submit_run(requests):
    """A script: submit ``requests`` [(prompt, n)], run, return streams."""
    def script(srv):
        rids = [srv.submit(p, max_new_tokens=n) for p, n in requests]
        done = srv.run()
        return [done[r].tokens for r in rids]
    return script


@pytest.mark.parametrize("quant", [None, "int4"])
def test_xla_lane_kv_quant_matches_standalone_and_jax(quant):
    """``tests/test_serve_xla.py:102`` and ``:123``: int8-KV serving on the
    scan lane, with float and int4 weights, three requests on two slots (a
    recycled slot's shifted admission: K rows dequantized, rotated and
    requantized), equal to the JAX server's streams and to standalone
    ``generate(kv_quant="int8", fused=False)``."""
    jm, tm = models(13 if quant is None else 17)
    prompts = [[1, 5, 9], [2, 7, 3], [30, 20]]
    (want, *_), (got, *_), srv = both(
        jm, tm, submit_run([(p, 6) for p in prompts]), quant=quant,
        kv_quant="int8", **XLA)
    assert isinstance(srv._ck, tuple) and srv._ck[0].dtype == torch.int8
    assert got == want
    assert got == [standalone(tm, p, 6, quant=quant, kv_quant="int8")
                   for p in prompts]


def test_xla_lane_kv_quant_sampled_matches_jax():
    """A sampling int8-KV server on the scan lane, seeded and unseeded
    requests, against the JAX server's streams."""
    jm, tm = models(5)

    def script(srv):
        rids = [srv.submit([1, 6, 2], max_new_tokens=8, temperature=0.9,
                           top_k=17, top_p=0.95, seed=1234),
                srv.submit([7, 7], max_new_tokens=6, temperature=0.7),
                srv.submit([3, 1, 4, 1, 5], max_new_tokens=6)]
        done = srv.run()
        return [done[r].tokens for r in rids]

    (want, *_), (got, *_), _ = both(jm, tm, script, kv_quant="int8", **XLA)
    assert got == want


# ------------------------------ prefix cache ------------------------------
def warm_then(first, second, n1=6, n2=6, **extra):
    """A script: admit ``first`` alone (one step), then ``second``, run;
    returns both streams."""
    def script(srv):
        r1 = srv.submit(first, max_new_tokens=n1)
        srv.step()
        r2 = srv.submit(second, max_new_tokens=n2, **extra)
        srv.run()
        return [srv._finished[r1].tokens, srv._finished[r2].tokens]
    return script


@pytest.mark.parametrize("quant", [None, "int4"])
def test_prefix_cache_reuses_and_matches(quant):
    """``tests/test_serve_xla.py:200``: a request sharing 10 prompt tokens
    with a resident slot reuses 8 rows (suffix-only prefill) and emits the
    standalone stream; streams and counters equal the JAX server's."""
    jm, tm = models(21, max_seq_len=128)
    want, got, _ = both(jm, tm, warm_then(PA, PB), quant=quant,
                        prefix_cache=True, **XLA)
    assert got == want and got[1:] == (1, 8)
    assert got[0] == [standalone(tm, PA, 6, quant=quant),
                      standalone(tm, PB, 6, quant=quant)]


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_prefix_cache_kv_quant_reuse(quant):
    """``tests/test_serve_xla.py:144``, with int8 and int4 weights: int8
    donor rows are dequantized, re-rotated and requantized on reuse; the
    port's streams and counters equal the JAX server's, and the first
    request's equals the no-reuse server's."""
    jm, tm = models(21, max_seq_len=128)
    sys_prefix = [9, 8, 7, 6, 5, 4, 3, 2]
    p1, p2 = sys_prefix + [10, 11], sys_prefix + [12, 13]
    want, got, _ = both(jm, tm, warm_then(p1, p2), quant=quant,
                        kv_quant="int8", prefix_cache=True, **XLA)
    assert got == want and got[1] >= 1 and got[2] >= len(sys_prefix)
    (plain, hits, _), _, _ = both(jm, tm, warm_then(p1, p2), quant=quant,
                                  kv_quant="int8", prefix_cache=False,
                                  **XLA)
    assert hits == 0 and plain[0] == got[0][0]


def test_prefix_cache_donor_survives_finish_and_recycling():
    """``tests/test_serve_xla.py:224``: a finished request's rows stay donor
    material; PB recycles PA's own slot (self-donation) and matches
    standalone ``generate``, as on the JAX server."""
    jm, tm = models(22, max_seq_len=128)
    pc = [2, 7, 4, 4, 1, 3, 9, 2, 5]
    requests = [(PA, 5), (pc, 16), (PB, 5)]
    want, got, _ = both(jm, tm, submit_run(requests), prefix_cache=True,
                        **XLA)
    assert got == want and got[1] == 1
    assert got[0] == [standalone(tm, p, n) for p, n in requests]


def test_prefix_cache_seeded_sampling_unchanged():
    """``tests/test_serve_xla.py:254``: a seeded sampled request's stream is
    the same whether its prefix rows were reused or prefilled, and equal to
    the JAX server's."""
    jm, tm = models(23, max_seq_len=128)
    kw = dict(max_new_tokens=8, temperature=0.9, top_k=17, seed=77)

    def warm(srv):
        srv.submit(PA, max_new_tokens=6)
        srv.step()
        rb = srv.submit(PB, **kw)
        srv.run()
        return srv._finished[rb].tokens

    def cold(srv):
        rb = srv.submit(PB, **kw)
        srv.run()
        return srv._finished[rb].tokens

    want, got, _ = both(jm, tm, warm, prefix_cache=True, **XLA)
    assert got == want and got[1] == 1
    (alone, hits, _), _, _ = both(jm, tm, cold, prefix_cache=False, **XLA)
    assert hits == 0 and alone == got[0]


def test_prefix_cache_invalidated_on_rewind():
    """``tests/test_serve_xla.py:280``: draining the fleet rewinds the
    shared position and kills the donors; a later matching prompt admits in
    full and decodes its standalone stream."""
    jm, tm = models(24, max_seq_len=128)

    def script(srv):
        srv.submit(PA, max_new_tokens=4)
        srv.run()
        rb = srv.submit(PB, max_new_tokens=5)
        return srv.run()[rb].tokens

    want, got, _ = both(jm, tm, script, prefix_cache=True, **XLA)
    assert got == want and got[1] == 0
    assert got[0] == standalone(tm, PB, 5)


def test_prefix_cache_requires_xla_lane():
    """``tests/test_serve_xla.py:300``: the fused lane has no row reuse."""
    _, tm = models(0)
    with pytest.raises(ValueError, match="prefix_cache"):
        LlamaServer(tm, batch_size=2, lane="fused", prefix_cache=True)
    with pytest.raises(ValueError, match="prefix_cache"):
        LlamaServer(tm, batch_size=2, prefix_cache=True)  # routed fused


def test_prefix_cache_multi_turn_reuses_generated_rows():
    """``tests/test_serve_xla.py:308``: residency grows with the decoded
    tokens, so a follow-up quoting the first exchange reuses rows past the
    first prompt; against the JAX server."""
    jm, tm = models(25, max_seq_len=128)
    pa = [1, 5, 9, 4, 7, 2]
    out_a = standalone(tm, pa, 10)
    pb = pa + out_a[:8] + [3, 11]

    def script(srv):
        ra = srv.submit(pa, max_new_tokens=10)
        srv.submit([2, 7, 4], max_new_tokens=60)  # keeps the fleet busy
        for _ in range(20):
            if ra in srv._finished:
                break
            srv.step()
        assert ra in srv._finished
        rb = srv.submit(pb, max_new_tokens=5)
        return srv.run()[rb].tokens

    want, got, _ = both(jm, tm, script, prefix_cache=True, **XLA)
    assert got == want and got[1:] == (1, 8)
    assert got[0] == standalone(tm, pb, 5)


def test_prefix_cache_invalidated_on_weight_update():
    """``tests/test_serve_xla.py:344``: a new weight snapshot kills the
    donors (their rows were computed under the old weights)."""
    jm, tm = models(26, max_seq_len=128)

    def script(srv):
        srv.submit(PA, max_new_tokens=30)
        srv.step()
        assert any(srv._resident)
        srv.model._weights_cache.clear()  # what a fine-tune step does
        rb = srv.submit(PB, max_new_tokens=5)
        return srv.run()[rb].tokens

    want, got, _ = both(jm, tm, script, prefix_cache=True, **XLA)
    assert got == want and got[1] == 0
    assert got[0] == standalone(tm, PB, 5)


def test_find_donor_rules():
    """The host half alone: the longest common prefix rounded down to a
    power of two, at least 8 rows, one suffix token left, and a slot
    re-admitted in the wave donating only to itself."""
    _, tm = models(0, max_seq_len=128)
    srv = LlamaServer(tm, prefix_cache=True, **XLA)
    srv._resident = [(0, tuple(range(1, 21)), 5), (1, tuple(range(1, 8)), 0)]
    assert srv._find_donor(list(range(1, 21)) + [99], 1, set()) == (0, 5, 16)
    assert srv._find_donor(list(range(1, 13)), 1, set()) == (0, 5, 8)
    assert srv._find_donor(list(range(1, 9)), 1, set()) is None  # 7 < 8
    assert srv._find_donor(list(range(1, 21)), 1, {0}) is None
    assert srv._find_donor(list(range(1, 21)), 0, {0}) == (0, 5, 16)
