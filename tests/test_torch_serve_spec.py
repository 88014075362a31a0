"""The port's speculative server (``models/llama/serve_spec.py``,
``LlamaServer(speculative=K)``) against the JAX package's on the CPU:
``tests/test_serve_spec.py``'s five cases, each run on both packages with
the same weights (``params_from_tpu``), and a grouped-query model, a model
with LoRA adapters before and after the merge, and a chunk that reads
nothing back to the host. Float32 streams equal token for token, and
``spec_iterations`` / ``spec_accepted`` equal the JAX server's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydynet_tpu as pdn
from pydynet_tpu import optim as joptim
from pydynet_tpu.models.llama.model import Llama as JLlama
from pydynet_tpu.models.llama.serve import LlamaServer as JServer
from pydynet_tpu.models.llama.serve_spec import SpecLlamaServer as JSpec
from pydynet_tpu.models.llama.speculative import lookup_draft as jlookup_draft
from pydynet_tpu.nn.modules import lora as jlora

from pydynet_tpu_torch.models.llama import Llama, params_from_tpu
from pydynet_tpu_torch.models.llama.serve import LlamaServer
from pydynet_tpu_torch.models.llama.serve_spec import SpecLlamaServer
from pydynet_tpu_torch.models.llama.speculative import lookup_draft_rows

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

# tests/test_serve_spec.py's config
CFG = dict(vocab_size=256, embed_dim=32, n_heads=4, ffn_dim=64,
           max_seq_len=128, max_batch_size=2, n_layers=2)
PROMPTS = [[1, 5, 9], [2, 7, 3, 11], [30, 20, 8], [4, 4, 4, 4, 4]]


def jax_model(seed, **over):
    np.random.seed(seed)
    jm = JLlama(dtype=np.float32, **dict(CFG, **over))
    jm.eval()
    return jm


def port_of(jm, **over):
    tm = Llama(**dict(CFG, **over), device="cpu")
    tm.load_state_dict(params_from_tpu(
        {n: p.numpy() for n, p in jm._parameters.items()}), strict=False)
    return tm.eval()


def standalone(tm, prompt, n_new, quant=None):
    return [int(t[0, 0]) for t in tm.generate(
        np.asarray([prompt]), len(prompt) + n_new, fused=False, quant=quant)]


def serve_both(jm, tm, requests, **kw):
    """Serve ``requests`` [(prompt, max_new_tokens)] on both packages'
    speculative servers; returns (JAX streams, port streams, JAX server,
    port server)."""
    with pdn.no_grad():
        js = JServer(jm, **kw)
        jr = [js.submit(p, max_new_tokens=n) for p, n in requests]
        jd = js.run()
    ts = LlamaServer(tm, **kw)
    tr = [ts.submit(p, max_new_tokens=n) for p, n in requests]
    td = ts.run()
    return ([jd[r].tokens for r in jr], [td[r].tokens for r in tr], js, ts)


def assert_same_counters(js, ts):
    assert (ts.spec_iterations, ts.spec_accepted) == \
        (js.spec_iterations, js.spec_accepted)


def test_spec_server_routes_and_raises_like_jax():
    """``LlamaServer(speculative=K)`` builds the speculative server in both
    packages, with the same errors: sampled requests, the options it does
    not compose with, ``temperature > 0``, an unknown quant, no headroom."""
    jm = jax_model(51)
    tm = port_of(jm)
    for m, server, spec in ((jm, JServer, JSpec),
                            (tm, LlamaServer, SpecLlamaServer)):
        srv = server(m, speculative=5, batch_size=2, chunk=4, eos_id=-1)
        assert isinstance(srv, spec) and srv.K == 5
        with pytest.raises(ValueError, match="greedy-only"):
            srv.submit([1, 2, 3], temperature=0.8)
        with pytest.raises(ValueError, match="headroom"):
            srv.submit(list(range(1, CFG["max_seq_len"] - 3)))
        for kw in (dict(kv_quant="int8"), dict(lane="xla"),
                   dict(prefix_cache=True), dict(flash_prefill=True)):
            with pytest.raises(ValueError, match="unsupported"):
                server(m, speculative=5, **kw)
        with pytest.raises(ValueError, match="greedy-only"):
            server(m, speculative=5, temperature=0.7)
        with pytest.raises(ValueError, match="quant"):
            server(m, speculative=5, quant="int2")
    # an option left at its off value composes
    assert isinstance(LlamaServer(tm, speculative=3, prefix_cache=False,
                                  lane=None), SpecLlamaServer)


def test_spec_server_streams_match_jax_with_recycling():
    """Four requests on two slots (recycled slots admit at rows [0, L)):
    every stream equals standalone greedy ``generate(fused=False)`` and the
    JAX server's, with the same iteration and acceptance counts."""
    jm = jax_model(52)
    tm = port_of(jm)
    want = [standalone(tm, p, 8) for p in PROMPTS]
    jstreams, tstreams, js, ts = serve_both(
        jm, tm, [(p, 8) for p in PROMPTS], speculative=4, batch_size=2,
        chunk=3, eos_id=-1)
    assert tstreams == want == jstreams
    assert_same_counters(js, ts)
    assert len(PROMPTS) > ts.B


def test_spec_server_accepts_on_repetitive_text():
    """A model fine-tuned into a loop (by the JAX package, its weights then
    carried over) accepts drafts: the stream finishes in at most 8 chunks
    and ``spec_accepted`` is the JAX server's, step for step."""
    jm = jax_model(53)
    pat = ([7, 11, 13, 5] * 8)[:24]
    opt = joptim.Adam(jm.parameters(), lr=3e-2)
    jm.finetune_steps(np.asarray([pat[:-1]]), np.asarray([pat[1:]]), opt,
                      n_steps=60)
    jm.eval()
    tm = port_of(jm)
    want = standalone(tm, pat[:6], 40)
    kw = dict(speculative=6, batch_size=2, chunk=2, eos_id=-1)
    with pdn.no_grad():
        js = JServer(jm, **kw)
        jr = js.submit(pat[:6], max_new_tokens=40)
    ts = LlamaServer(tm, **kw)
    tr = ts.submit(pat[:6], max_new_tokens=40)
    steps = 0
    while ts._queue or ts.active:
        ts.step()
        with pdn.no_grad():
            js.step()
        steps += 1
        assert_same_counters(js, ts)
        assert steps < 100
    assert ts._finished[tr].tokens == want == js._finished[jr].tokens
    assert ts.spec_accepted > 0, "no draft ever accepted"
    assert steps <= 8, (steps, ts.spec_accepted)


@pytest.mark.parametrize("quant", ["int8", "int4", "int8-head"])
def test_spec_server_quant_matches_jax(quant):
    """``quant`` on the speculative server: each stream equals
    ``generate(quant=..., fused=False)`` and the JAX server's (its
    quantized matmuls in interpret mode)."""
    jm = jax_model(54)
    tm = port_of(jm)
    requests = [([3, 1, 4, 1, 5], 8), ([9, 2, 6], 6)]
    want = [standalone(tm, p, n, quant) for p, n in requests]
    jstreams, tstreams, js, ts = serve_both(
        jm, tm, requests, speculative=4, batch_size=2, chunk=3, eos_id=-1,
        quant=quant)
    assert tstreams == want == jstreams
    assert_same_counters(js, ts)


def test_spec_server_eos_and_headroom_truncation():
    """EOS finishes a request without emitting it; a slot out of
    speculative headroom (n + K + 1 > S) is truncated, as in the JAX
    server, with the same tokens."""
    jm = jax_model(55)
    tm = port_of(jm)
    first = standalone(tm, [5, 6], 1)
    jstreams, tstreams, _, ts = serve_both(
        jm, tm, [([5, 6], 8)], speculative=4, batch_size=2, chunk=3,
        eos_id=first[0])
    assert tstreams == jstreams == [[]]
    assert all(r.done for r in ts._finished.values())
    jstreams, tstreams, js, ts = serve_both(
        jm, tm, [([1, 2, 3], 1000)], speculative=4, batch_size=2, chunk=3,
        eos_id=-1)
    req = next(iter(ts._finished.values()))
    assert req.truncated and tstreams == jstreams
    assert len(req.tokens) >= CFG["max_seq_len"] - 3 - ts.K - 2
    assert_same_counters(js, ts)


def test_spec_server_grouped_query_matches_jax():
    """A grouped-query model (4 query heads, 2 KV heads): the streams and
    counters of the JAX server, and standalone greedy's streams."""
    jm = jax_model(56, n_kv_heads=2)
    tm = port_of(jm, n_kv_heads=2)
    want = [standalone(tm, p, 10) for p in PROMPTS]
    jstreams, tstreams, js, ts = serve_both(
        jm, tm, [(p, 10) for p in PROMPTS], speculative=3, batch_size=2,
        chunk=4, eos_id=-1)
    assert tstreams == want == jstreams
    assert_same_counters(js, ts)


def test_spec_server_serves_lora_adapters_then_the_merge():
    """The same fleet after ``add_lora`` (adapters with a non-zero B,
    carried from the JAX model) and after ``merge_lora``: the JAX server's
    streams both times, and the port's merged streams equal its unmerged
    ones."""
    jm = jax_model(57)
    tm = port_of(jm)
    jm.add_lora(r=4, alpha=8.0, targets=("Q", "V", "down"))
    tm.add_lora(r=4, alpha=8.0, targets=("Q", "V", "down"))
    rng = np.random.default_rng(57)
    for name in jlora.lora_state_names(jm):
        p = jm._parameters[name]
        if name.endswith("lora_B"):
            p.data = (rng.standard_normal(p.shape) * 0.2).astype(np.float32)
    tm.load_state_dict(params_from_tpu(
        {n: jm._parameters[n].numpy()
         for n in jlora.lora_state_names(jm)}), strict=False)
    jm._weights_cache.clear()
    tm._weights_cache.clear()
    requests = [(p, 9) for p in PROMPTS]
    kw = dict(speculative=4, batch_size=2, chunk=3, eos_id=-1)
    jstreams, tstreams, _, _ = serve_both(jm, tm, requests, **kw)
    assert tstreams == jstreams
    assert tstreams == [standalone(tm, p, 9) for p in PROMPTS]
    assert tm.merge_lora() == 6 and jm.merge_lora() == 6
    jmerged, tmerged, _, _ = serve_both(jm, tm, requests, **kw)
    assert tmerged == tstreams and jmerged == jstreams


def test_spec_chunk_reads_nothing_back(monkeypatch):
    """A chunk's verify iterations call no ``.item``, ``.tolist`` or
    ``.cpu``: the host reads the tokens once, after the chunk. The device
    drafts equal the JAX package's ``lookup_draft`` vmapped over the rows,
    as its server drafts."""
    jm = jax_model(58)
    tm = port_of(jm)
    srv = LlamaServer(tm, speculative=4, batch_size=2, chunk=5, eos_id=-1)
    for p in PROMPTS[:2]:
        srv.submit(p, max_new_tokens=30)
    srv._try_admit()
    seq = srv._seq[:, :srv.S].clone()
    n = srv._n.clone()
    for name in ("item", "tolist", "cpu"):
        def refuse(*args, _name=name, **kwargs):
            raise AssertionError(f"host read: Tensor.{_name}")
        monkeypatch.setattr(torch.Tensor, name, refuse)
    srv._spec_chunk(64)
    drafts = lookup_draft_rows(seq, n, 4, 3)
    monkeypatch.undo()
    want = jax.vmap(jlookup_draft, (0, 0, None, None))(
        jnp.asarray(seq.numpy().astype(np.int32)),
        jnp.asarray(n.numpy().astype(np.int32)), 4, 3)
    assert np.array_equal(drafts.numpy(), np.asarray(want))
    assert (srv._n > n).all()
