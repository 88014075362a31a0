"""The port's continuous-batching server on the scan lane
(``LlamaServer(lane="xla")``) against its own standalone ``generate`` and
the JAX package's scan-lane server, on the CPU.

Weights come from a seeded JAX model and reach the port through
``params_from_tpu``. The JAX server's quantized matmuls run in interpret
mode (its ``xinterp`` weights); the port's run their plain versions because
the tensors are on the CPU. Streams are float32 and must be equal token for
token, a request admitted at a shifted position in a recycled slot included
(``tests/test_serve_xla.py``).
"""
import numpy as np
import pytest
import torch

import pydynet_tpu as pdn
from pydynet_tpu.models.llama.model import Llama as JLlama
from pydynet_tpu.models.llama.serve import LlamaServer as JServer

from pydynet_tpu_torch.models.llama import Llama, params_from_tpu
from pydynet_tpu_torch.models.llama.serve import LlamaServer
from pydynet_tpu_torch.ops import gemv_quant as tgq

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

# tests/test_serve_xla.py's tiny config
CFG = dict(vocab_size=256, embed_dim=32, n_heads=2, ffn_dim=64,
           max_seq_len=64, max_batch_size=2, n_layers=2)


def models(seed, **over):
    cfg = dict(CFG, **over)
    np.random.seed(seed)
    jm = JLlama(dtype=np.float32, **cfg)
    jm.eval()
    tm = Llama(**cfg, device="cpu")
    tm.load_state_dict(params_from_tpu(
        {n: p.numpy() for n, p in jm._parameters.items()}), strict=True)
    return jm, tm.eval()


def standalone(tm, prompt, n_new, **kw):
    """The port's scan-lane stream of n_new tokens, prefill token first."""
    return [int(t[0, 0]) for t in tm.generate(
        np.asarray([prompt]), len(prompt) + n_new, fused=False, **kw)]


def serve_both(jm, tm, requests, **kw):
    """Serve ``requests`` [(prompt, max_new_tokens)] on the JAX server and
    on the port's; returns (jax streams, port streams, port server)."""
    with pdn.no_grad():
        js = JServer(jm, **kw)
        jr = [js.submit(p, max_new_tokens=n) for p, n in requests]
        jd = js.run()
    ts = LlamaServer(tm, **kw)
    tr = [ts.submit(p, max_new_tokens=n) for p, n in requests]
    td = ts.run()
    assert set(jd) == set(jr) and set(td) == set(tr)
    return [jd[r].tokens for r in jr], [td[r].tokens for r in tr], ts


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_xla_lane_matches_standalone_and_jax(quant):
    """Three requests on two slots (one admitted at a shifted position in a
    recycled slot): each stream equals standalone ``generate(fused=False,
    quant=...)`` and the JAX scan-lane server's."""
    jm, tm = models({None: 9, "int8": 3, "int4": 3}[quant])
    prompts = [[1, 5, 9], [2, 7, 3, 11], [30, 20]]
    want, got, srv = serve_both(jm, tm, [(p, 8) for p in prompts],
                                batch_size=2, chunk=4, eos_id=-1,
                                lane="xla", quant=quant)
    assert srv._lane == "xla" and len(prompts) > srv.B
    assert got == want
    assert got == [standalone(tm, p, 8, quant=quant) for p in prompts]


def test_xla_lane_heavy_turnover_int8_head():
    """B=4 slots, 10 requests of mixed prompt lengths (power-of-two
    admission sub-waves) with the int8 head, against the JAX server."""
    jm, tm = models(13, max_batch_size=4)
    rng = np.random.RandomState(5)
    prompts = [[int(x) for x in rng.randint(3, 250,
                                            size=rng.choice([2, 3, 5]))]
               for _ in range(10)]
    want, got, _ = serve_both(jm, tm, [(p, 6) for p in prompts],
                              batch_size=4, chunk=4, eos_id=-1, lane="xla",
                              quant="int8-head")
    assert got == want
    assert got == [standalone(tm, p, 6, quant="int8-head") for p in prompts]


def test_xla_lane_tail_trim_and_rewind():
    """chunk 7 does not divide S - len(prompt): the filler steps past the
    cache end run with clamped positions and are trimmed, the request
    truncates at exactly S tokens as on the JAX server, and the drained
    fleet rewinds for the next request."""
    jm, tm = models(15)
    S = CFG["max_seq_len"]
    want, got, srv = serve_both(jm, tm, [([1, 5, 9], 10_000)], batch_size=2,
                                chunk=7, eos_id=-1, lane="xla")
    assert got == want and len(got[0]) == 1 + (S - 3)
    assert srv._finished[0].truncated and srv._pos == 0
    r2 = srv.submit([4, 8], max_new_tokens=6)
    assert srv.run()[r2].tokens == standalone(tm, [4, 8], 6)


def test_xla_lane_auto_routes():
    """A model the port's fused kernels do not take (head_dim 260 > 256)
    and the JAX rule sends to the scan lane (ffn 60 is not 8-aligned)
    serves there without being asked (``test_serve_xla.py:179``)."""
    jm, tm = models(11, embed_dim=520, ffn_dim=60)
    assert not tm._tpu_fused_supported() and not jm._fused_decode_supported()
    prompts = [[1, 5, 9], [2, 7, 3]]
    want, got, srv = serve_both(jm, tm, [(p, 6) for p in prompts],
                                batch_size=2, chunk=4, eos_id=-1)
    assert srv._lane == "xla" and got == want
    assert got == [standalone(tm, p, 6) for p in prompts]


def test_xla_lane_quant_runs_the_quantized_matmuls(monkeypatch):
    """Every decode step of an int4 server is four quantized matmuls a
    layer, each through ``qmatmul_stacked`` with the layer's index, and one
    ``qmatmul`` for the head, on all slots at once."""
    _, tm = models(3)
    rows, layers = [], []
    real, real_stacked = tgq.qmatmul, tgq.qmatmul_stacked

    def spy(x, *args, **kwargs):
        rows.append(x.shape[0])
        return real(x, *args, **kwargs)

    def spy_stacked(x, wq, ws, idx, **kwargs):
        layers.append((x.shape[0], int(idx)))
        return real_stacked(x, wq, ws, idx, **kwargs)

    monkeypatch.setattr(tgq, "qmatmul", spy)
    monkeypatch.setattr(tgq, "qmatmul_stacked", spy_stacked)
    srv = LlamaServer(tm, batch_size=2, chunk=4, eos_id=-1, lane="xla",
                      quant="int4")
    for p in ([1, 5, 9], [2, 7, 3, 11], [30, 20]):
        srv.submit(p, max_new_tokens=6)
    srv.run()
    steps = srv.dispatched_steps
    assert rows.count(2) == steps > 0
    per_step = [(2, i) for i in range(CFG["n_layers"]) for _ in range(4)]
    assert [x for x in layers if x[0] == 2] == per_step * steps


def test_xla_lane_unported_options_raise():
    """Speculative serving with a ``lane`` raises ``ValueError``
    "unsupported", as the JAX package's ``**extra`` rule does
    (``serve_spec.py``); the scan lane's prefix cache and int8 KV cache run
    (``test_torch_prefix_cache.py`` holds them to the JAX server)."""
    jm, tm = models(20)
    for m in (jm, tm):
        with pytest.raises(ValueError, match="unsupported"):
            (JServer if m is jm else LlamaServer)(m, lane="xla",
                                                  speculative=4)
    for kw in (dict(prefix_cache=True), dict(kv_quant="int8"),
               dict(prefix_cache=True, kv_quant="int8", quant="int4")):
        srv = LlamaServer(tm, batch_size=2, chunk=4, eos_id=-1, lane="xla",
                          **kw)
        rid = srv.submit([1, 5, 9], max_new_tokens=5)
        assert srv._lane == "xla" and len(srv.run()[rid].tokens) == 5
    with pytest.raises(ValueError, match="lane"):
        LlamaServer(tm, lane="scan")
    with pytest.raises(ValueError, match="quant"):
        LlamaServer(tm, lane="xla", quant="int2")
    # int8 layers run on either lane at this width: the batched step's
    # quantized mode on the fused lane, the quantized matmuls on the scan
    srv = LlamaServer(tm, batch_size=2, chunk=4, eos_id=-1, lane="fused",
                      quant="int8")
    rid = srv.submit([1, 5, 9], max_new_tokens=5)
    assert srv._lane == "fused" and len(srv.run()[rid].tokens) == 5
    assert LlamaServer(tm, batch_size=2, quant="int8", lane="xla",
                       dtype=torch.bfloat16)._lane == "xla"
