"""The port's NumPy BLAS decode lane (``models/llama/cpu_decode.py``,
``generate(fused="numpy")``) against the JAX package's, on the CPU.

Weights come from a seeded JAX model through ``params_from_tpu``; both
lanes are NumPy loops over the same float32 numbers, so greedy and sampled
streams must be equal token for token."""
import numpy as np
import pytest
import torch

import pydynet_tpu as pdn
from pydynet_tpu.models.llama.model import Llama as JLlama

from pydynet_tpu_torch.models.llama import Llama, params_from_tpu
from pydynet_tpu_torch.models.llama import cpu_decode

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

TINY = dict(vocab_size=256, embed_dim=32, n_heads=2, ffn_dim=64,
            max_seq_len=32, max_batch_size=1, n_layers=2)
# tests/test_llama.py's narrow-KV config: Dkv = 2 * 16 = 32 against D = 128
GQA = dict(vocab_size=256, embed_dim=128, n_heads=8, n_kv_heads=2,
           ffn_dim=64, max_seq_len=32, max_batch_size=1, n_layers=2)
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9, seed=7)
IDS = np.array([[1, 5, 9]])


def models(cfg, seed):
    np.random.seed(seed)
    jm = JLlama(dtype=np.float32, **cfg)
    jm.eval()
    tm = Llama(**cfg, device="cpu")
    tm.load_state_dict(params_from_tpu(
        {n: p.numpy() for n, p in jm._parameters.items()}), strict=True)
    return jm, tm.eval()


def stream(gen):
    return [int(np.asarray(t)[0, 0]) for t in gen]


@pytest.fixture
def lane_calls(monkeypatch):
    """Count the port's numpy_decode calls."""
    calls = []
    real = cpu_decode.numpy_decode

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(cpu_decode, "numpy_decode", spy)
    return calls


@pytest.mark.parametrize("cfg", [TINY, GQA], ids=["tiny", "gqa"])
@pytest.mark.parametrize("seed", [0, 3])
def test_greedy_stream_matches_jax(cfg, seed, lane_calls):
    jm, tm = models(cfg, seed)
    with pdn.no_grad():
        want = stream(jm.generate(IDS, 24, fused="numpy"))
    assert len(want) == 21
    assert stream(tm.generate(IDS, 24, fused="numpy")) == want
    # fused=None on a CPU float32 B=1 model takes the same lane
    assert stream(tm.generate(IDS, 24)) == want
    assert lane_calls == [1, 1]


@pytest.mark.parametrize("cfg", [TINY, GQA], ids=["tiny", "gqa"])
@pytest.mark.parametrize("rep", [None, 1.3])
def test_sampled_stream_matches_jax(cfg, rep):
    jm, tm = models(cfg, 1)
    with pdn.no_grad():
        want = stream(jm.generate(IDS, 24, fused="numpy",
                                  repetition_penalty=rep, **SAMPLED))
    got = stream(tm.generate(IDS, 24, fused="numpy",
                             repetition_penalty=rep, **SAMPLED))
    assert got == want
    assert got != stream(tm.generate(IDS, 24, fused="numpy"))


def test_logits_match_jax_lane_bit_for_bit():
    """One token through the layers: the two lanes' float32 logits are the
    same bits (the same NumPy operations on the same weights)."""
    from pydynet_tpu.models.llama import cpu_decode as jcd

    jm, tm = models(GQA, 2)
    jw, tw = jcd.build_np_weights(jm), cpu_decode.build_np_weights(tm)
    for k in jw:
        np.testing.assert_array_equal(tw[k], np.asarray(jw[k]), err_msg=k)
    js, ts = jcd._State(jm, np.float32), cpu_decode._State(tm, np.float32)
    for pos, tok in enumerate([1, 5, 9, 77]):
        want = jcd._advance(jm, jw, js, tok, pos, True)
        got = cpu_decode._advance(tm, tw, ts, tok, pos, True)
        np.testing.assert_array_equal(got, want)


def test_length_edges_match_jax():
    jm, tm = models(TINY, 4)
    for max_new in (2, 3, 4, 40):
        with pdn.no_grad():
            want = stream(jm.generate(IDS, max_new, fused="numpy"))
        assert stream(tm.generate(IDS, max_new, fused="numpy")) == want
        assert len(want) == max(0, min(max_new, 32) - 3)


def test_routing_rule(lane_calls):
    """``fused="numpy"`` refuses what the lane does not run, with the JAX
    package's ValueError; ``fused=None`` leaves it for B > 1, a quantized or
    cast request, or a bfloat16 model."""
    _, tm = models(TINY, 5)
    for kw in (dict(quant="int8-head"), dict(kv_quant="int8"),
               dict(dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match="numpy"):
            next(tm.generate(IDS, 8, fused="numpy", **kw))
        assert len(stream(tm.generate(IDS, 8, **kw))) == 5
    ids3 = np.array([[1, 5, 9], [2, 7, 3], [30, 20, 10]])
    with pytest.raises(ValueError, match="numpy"):
        next(tm.generate(ids3, 8, fused="numpy"))
    assert len(list(tm.generate(ids3, 8))) == 5
    bf = Llama(**TINY, device="cpu", dtype=torch.bfloat16).eval()
    with pytest.raises(ValueError, match="numpy"):
        next(bf.generate(IDS, 8, fused="numpy"))
    assert len(stream(bf.generate(IDS, 8))) == 5
    assert lane_calls == []
    # the lane yields the other lanes' rows: (1, 1) int32 CPU tensors
    rows = list(tm.generate(IDS, 8, fused="numpy"))
    assert all(r.shape == (1, 1) and r.dtype == torch.int32 for r in rows)
    assert lane_calls == [1]


def test_snapshot_is_cached_and_dropped_with_the_weights():
    _, tm = models(TINY, 6)
    first = stream(tm.generate(IDS, 12, fused="numpy"))
    snap = tm._weights_cache[("numpy",)]
    assert stream(tm.generate(IDS, 12, fused="numpy")) == first
    assert tm._weights_cache[("numpy",)] is snap
    with torch.no_grad():
        tm.lm_head.bias.add_(torch.arange(256.0) * 10.0)
    tm.load_state_dict(tm.state_dict())
    assert ("numpy",) not in tm._weights_cache
    assert stream(tm.generate(IDS, 12, fused="numpy")) == [255] * 9
