"""The port's long-prompt prefill (``flash_prefill``) against the JAX
package's, on the CPU: ``tests/test_flash_prefill.py``'s cases on the same
seeded weights.

The JAX side runs its flash route as its own tests do
(``flash_prefill="interpret"``, its Pallas kernel in interpret mode, or its
dense composite below the kernel's tiling); the port's ``True`` runs K3's
plain version, because the tensors are on the CPU. Streams are float32 and
must be equal token for token.
"""
import functools

import numpy as np
import pytest
import torch

import pydynet_tpu as pdn
from pydynet_tpu.models.llama.model import Llama as JLlama
from pydynet_tpu.models.llama.serve import LlamaServer as JServer
from pydynet_tpu.ops import decode_step as jdsk

from pydynet_tpu_torch.models.llama import Llama, params_from_tpu
from pydynet_tpu_torch.models.llama import model as tmodel
from pydynet_tpu_torch.models.llama.serve import LlamaServer
from pydynet_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

# tests/test_flash_prefill.py's config
CFG = dict(vocab_size=128, embed_dim=32, n_heads=4, ffn_dim=64,
           max_seq_len=64, max_batch_size=1, n_layers=2)


@pytest.fixture
def interp_kernels(monkeypatch):
    """JAX's fused decode kernels in interpret mode, as its tests run them
    on the CPU."""
    for name in ("fused_decode_token", "fused_decode_token_batched"):
        monkeypatch.setattr(jdsk, name, functools.partial(
            getattr(jdsk, name), interpret=True))


@pytest.fixture
def flash_calls(monkeypatch):
    """The (B, L, H, d) of every call of the port's K3 wrapper (on the CPU
    it runs the plain version, which the launch counter does not count)."""
    calls = []
    real = tfa.flash_attention_fwd

    def spy(q, k, v, scale=None):
        calls.append(tuple(q.shape))
        return real(q, k, v, scale)

    monkeypatch.setattr(tfa, "flash_attention_fwd", spy)
    return calls


def models(seed, **over):
    """tests/test_flash_prefill.py's seeded JAX model and its port, with the
    same weights."""
    cfg = dict(CFG, **over)
    np.random.seed(seed)
    jm = JLlama(dtype=np.float32, **cfg)
    jm.eval()
    tm = Llama(**cfg, device="cpu")
    tm.load_state_dict(params_from_tpu(
        {n: p.numpy() for n, p in jm._parameters.items()}), strict=True)
    return jm, tm.eval()


def stream(model, prompt, n_new, **kw):
    with pdn.no_grad():
        return [int(np.asarray(t.numpy())[0, 0])
                for t in model.generate(np.asarray([prompt]),
                                        len(prompt) + n_new, **kw)]


@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
def test_flash_prefill_stream_matches_jax(fused, interp_kernels,
                                          flash_calls):
    """The JAX package's flash prefill (``"interpret"``) and the port's
    (``True``) give the same greedy stream on the scan lane and on the fused
    lane, which is also the dense prefill's; the port's prefill calls K3
    once a layer, on the (1, 32, 4, 8) prompt padded to 32."""
    jm, tm = models(61)
    p = list(np.random.default_rng(61).integers(1, 128, 17))
    want = stream(jm, p, 12, fused=fused, flash_prefill="interpret")
    assert want == stream(jm, p, 12, fused=fused, flash_prefill=False)
    got = stream(tm, p, 12, fused=fused, flash_prefill=True)
    assert flash_calls == [(1, 32, 4, 8)] * CFG["n_layers"]
    assert got == want and len(got) == 12
    assert stream(tm, p, 12, fused=fused, flash_prefill=False) == want
    assert len(flash_calls) == CFG["n_layers"]


def test_flash_prefill_gqa_and_sampling(flash_calls):
    """A grouped-query model's K/V repeated to every query head inside the
    flash route (K3 sees 4 heads of K/V for 2 KV heads), greedy and
    sampled, as the JAX package's."""
    jm, tm = models(62, n_kv_heads=2)
    p = list(np.random.default_rng(62).integers(1, 128, 9))
    want = stream(jm, p, 10, fused=False, flash_prefill="interpret")
    assert stream(tm, p, 10, fused=False, flash_prefill=True) == want
    assert flash_calls == [(1, 16, 4, 8)] * CFG["n_layers"]
    kw = dict(fused=False, temperature=0.8, top_k=13, seed=5)
    want = stream(jm, p, 10, flash_prefill="interpret", **kw)
    assert want == stream(jm, p, 10, flash_prefill=False, **kw)
    assert stream(tm, p, 10, flash_prefill=True, **kw) == want
    assert stream(tm, p, 10, flash_prefill=False, **kw) == want


@pytest.mark.parametrize("lane", ["xla", "fused"])
def test_flash_prefill_server_admission(lane, interp_kernels, flash_calls):
    """Admission waves prefill through the flash route: the port's server
    with ``flash_prefill=True`` serves the JAX package's flash server's
    streams (``"interpret"``) and its own dense server's, one K3 call a
    layer a wave."""
    jm, tm = models(64, max_batch_size=2)
    prompts = [[1, 5, 9, 11, 2, 8, 3], [2, 7, 3, 11]]

    def serve(server, model, flash):
        with pdn.no_grad():
            srv = server(model, batch_size=2, chunk=4, eos_id=-1, lane=lane,
                         flash_prefill=flash)
            rids = [srv.submit(p, max_new_tokens=8) for p in prompts]
            done = srv.run()
        return [list(done[r].tokens) for r in rids]

    want = serve(JServer, jm, "interpret")
    assert want == serve(JServer, jm, False)
    got = serve(LlamaServer, tm, True)
    assert got == want and all(len(t) == 8 for t in got)
    assert len(flash_calls) == 2 * CFG["n_layers"]  # two waves, L 4 and 7
    assert serve(LlamaServer, tm, False) == want
    assert serve(LlamaServer, tm, None) == want
    assert len(flash_calls) == 2 * CFG["n_layers"]  # auto: dense on the CPU


def test_flash_prefill_mode_routing():
    """The routing rule: False below FLASH_PREFILL_MIN, False on the CPU at
    any length; a flash prefill with per-row ``starts`` (or off position 0)
    raises ``ValueError`` naming ``starts``, as the JAX package's does."""
    _, tm = models(65)
    w = tm._weights()
    for L in (1, tmodel.FLASH_PREFILL_MIN - 1, tmodel.FLASH_PREFILL_MIN,
              1 << 20):
        assert tmodel.flash_prefill_mode(w, L) is False
    ck, cv = tm._empty_caches(2, torch.float32)
    tokens = torch.zeros(2, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="starts"):
        tm.forward_logits_one(w, ck, cv, tokens, 0,
                              starts=torch.zeros(2, dtype=torch.int32),
                              flash=True)
    with pytest.raises(ValueError, match="starts"):
        tm.forward_logits_one(w, ck, cv, tokens, 3, flash=True)


def test_flash_prefill_mode_routes_long_prompts_on_a_gpu(monkeypatch):
    """On a GPU (its weights' device) the rule routes from
    FLASH_PREFILL_MIN on, and ``generate(flash_prefill=None)`` decides on
    the padded prompt's length."""
    class Dev:
        type = "cuda"

    class Tok:
        device = Dev()

    w = {"tok": Tok()}
    assert tmodel.flash_prefill_mode(w, tmodel.FLASH_PREFILL_MIN) is True
    assert tmodel.flash_prefill_mode(w, tmodel.FLASH_PREFILL_MIN - 1) \
        is False
    _, tm = models(67, max_seq_len=64)
    seen = []
    real = tm.prefill

    def spy(*args, flash=False, **kw):
        seen.append(flash)
        return real(*args, flash=flash, **kw)

    monkeypatch.setattr(tm, "prefill", spy)
    monkeypatch.setattr(tmodel, "FLASH_PREFILL_MIN", 32)
    monkeypatch.setattr(tmodel, "flash_prefill_mode",
                        lambda weights, L: L >= tmodel.FLASH_PREFILL_MIN)
    # fused=True: fused=None takes the NumPy lane (no prefill) for a B=1
    # float32 model on the CPU
    for L, want in ((16, False), (17, True), (32, True)):  # padded 16, 32
        stream(tm, list(range(1, L + 1)), 2, fused=True)
        assert seen.pop() is want


def test_flash_prefill_long_prompt_matches_jax(flash_calls):
    """tests/test_flash_prefill.py's long case: a 250-token prompt padded
    to 256, so the JAX package's flash route tiles it (its slow interpret
    run shows that equal to its dense prefill). The port's flash stream
    equals the JAX dense stream, K3 called on (1, 256, 2, 16) once a
    layer."""
    jm, tm = models(66, embed_dim=32, n_heads=2, max_seq_len=320)
    p = list(np.random.default_rng(66).integers(1, 128, 250))
    want = stream(jm, p, 8, fused=False, flash_prefill=False)
    assert stream(tm, p, 8, fused=False, flash_prefill=True) == want
    assert flash_calls == [(1, 256, 2, 16)] * CFG["n_layers"]
