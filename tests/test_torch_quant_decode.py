"""The port's B=1 decode step with int8 and int4 layers (K1's ``qlayers``
and ``q4`` modes) against the JAX package's, on the CPU.

Weights come from a seeded JAX Llama and reach the port through
``params_from_tpu``. The JAX fused step runs its Pallas kernel in interpret
mode, as ``tests/test_llama.py`` does; the port's runs its plain version
because the tensors are on the CPU. The port keeps torch's (out, in)
layout: its quantized matrices are the JAX ones transposed, int4 packed
along ``in`` where the JAX package packs its (in, out) matrices along
``in`` too, and its scales are one (N, out) tensor a matrix where the JAX
package packs them into (N, 8, D) and (N, 8, F) blocks for the TPU.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydynet_tpu as pdn
from pydynet_tpu.models.llama.model import Llama as JLlama
from pydynet_tpu.ops import decode_step as jds

from pydynet_tpu_torch.models.llama import Llama, params_from_tpu
from pydynet_tpu_torch.models.llama.model import (FUSED_MATS,
                                                  decode_quant_kwargs,
                                                  decode_weight_args)
from pydynet_tpu_torch.ops import decode_step as tds

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

# test_torch_llama.py's fused-capable tiny size
TINY = dict(vocab_size=256, embed_dim=32, n_heads=2, ffn_dim=64,
            max_seq_len=32, max_batch_size=1, n_layers=2)
# the JAX package's scale rows: s_attn (q, k, v, o, down), s_ffn (gate, up)
SCALE_ROWS = {"wq": ("s_attn", 0), "wk": ("s_attn", 1), "wv": ("s_attn", 2),
              "wo": ("s_attn", 3), "down": ("s_attn", 4),
              "gate_w": ("s_ffn", 0), "up_w": ("s_ffn", 1)}


def models(seed):
    np.random.seed(seed)
    jm = JLlama(dtype=np.float32, **TINY)
    jm.eval()
    params = {n: p.numpy() for n, p in jm._parameters.items()}
    tm = Llama(**TINY, device="cpu")
    tm.load_state_dict(params_from_tpu(params), strict=True)
    return jm, tm.eval()


def stream(gen):
    return [int(t.numpy()[0, 0]) for t in gen]


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_fused_weights_equal_jax_bit_for_bit(quant):
    """Each quantized layer matrix, transposed, equals the JAX package's
    ``<name>_q``; its scales equal the JAX scale block's row; the head
    likewise; the float matrices stay for the prefill."""
    jm, tm = models(0)
    jw = jm._fused_weights(None, quant)
    tw = tm._fused_weights(None, quant)
    for name in FUSED_MATS:
        np.testing.assert_array_equal(
            tw[name + "_q"].transpose(1, 2).numpy(),
            np.asarray(jw[name + "_q"]))
        block, row = SCALE_ROWS[name]
        np.testing.assert_array_equal(tw[name + "_s"].numpy(),
                                      np.asarray(jw[block])[:, row])
        assert tw[name].dtype == torch.float32  # the prefill's weights
    np.testing.assert_array_equal(tw["head_wq"].t().numpy(),
                                  np.asarray(jw["head_wq"]))
    np.testing.assert_array_equal(tw["head_s"].numpy(),
                                  np.asarray(jw["head_s"])[0])
    assert ("q4" in tw) == ("q4" in jw) == (quant == "int4")
    D, F = TINY["embed_dim"], TINY["ffn_dim"]
    half = 2 if quant == "int4" else 1
    assert tw["wq_q"].shape == (2, D, D // half)
    assert tw["down_q"].shape == (2, D, F // half)
    assert tw["head_wq"].shape == (256, D // half)


def _jax_logits(jm, jw, pos, tok, ck, cv, quant):
    """JAX's fused step with emit_logits, in interpret mode, laid out as
    its model's ``fused_step`` lays it out. Returns (logits (V,), ck, cv)."""
    V, S = TINY["vocab_size"], TINY["max_seq_len"]
    logits, ck, cv = jds.fused_decode_token(
        pos, jnp.asarray([tok], jnp.int32), jw["tok"], jw["cosD"],
        jw["sinD"], jw["rot"], jw["hmask_pad"], jw["norm2"],
        *(jw[name + "_q"] for name in FUSED_MATS), jw["in_norm2"],
        jw["post_norm2"], jw["head_wq"], jw["head_b2"], ck, cv,
        vt=jds.pick_vt(V, TINY["embed_dim"]), sb=jds.pick_sb(S),
        interpret=True, s_attn=jw["s_attn"], s_ffn=jw["s_ffn"],
        head_s=jw["head_s"], emit_logits=True, q4=quant == "int4")
    return np.asarray(logits)[0], ck, cv


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quant_step_logits_match_jax_kernel(quant):
    """Four steps from pos 3 over seeded random cache rows, JAX's logits
    from its kernel against the port's plain step: float32 throughout and
    the same integer products, so they differ by summation order in the
    norms and attention (1e-6) unless an activation lands within that of a
    rounding boundary and quantizes one step apart, which moves a logit by
    about max |w| * amax / 127 (1e-3 here): logits within 1e-3, the same
    argmax, caches within 1e-3."""
    jm, tm = models(1)
    jw = jm._fused_weights(None, quant)
    tw = tm._fused_weights(None, quant)
    N, S, D = TINY["n_layers"], TINY["max_seq_len"], TINY["embed_dim"]
    rng = np.random.default_rng(2)
    ck = (rng.standard_normal((N, S, D)) * 0.5).astype(np.float32)
    cv = (rng.standard_normal((N, S, D)) * 0.5).astype(np.float32)
    Dp = jds.lane_pad_dim(D)
    jck = jnp.asarray(np.pad(ck, ((0, 0), (0, 0), (0, Dp - D))))
    jcv = jnp.asarray(np.pad(cv, ((0, 0), (0, 0), (0, Dp - D))))
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    tok = 17
    for pos in range(3, 7):
        want, jck, jcv = _jax_logits(jm, jw, pos, tok, jck, jcv, quant)
        got = tds.decode_token_logits_ref(
            torch.tensor([pos], dtype=torch.int32),
            torch.tensor([tok], dtype=torch.int32),
            *decode_weight_args(tw), tck, tcv, n_heads=TINY["n_heads"],
            **decode_quant_kwargs(tw))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
        assert int(got.argmax()) == int(want.argmax())
        np.testing.assert_allclose(tck.numpy(), np.asarray(jck)[..., :D],
                                   atol=1e-3)
        np.testing.assert_allclose(tcv.numpy(), np.asarray(jcv)[..., :D],
                                   atol=1e-3)
        tok = int(want.argmax())


@pytest.fixture
def step_calls(monkeypatch):
    """Count the port's fused_decode_token calls (on the CPU they run the
    plain version, which the kernel's launch counter does not count)."""
    calls = []
    real = tds.fused_decode_token

    def spy(*args, **kwargs):
        calls.append(kwargs.get("q4"))
        return real(*args, **kwargs)

    monkeypatch.setattr(tds, "fused_decode_token", spy)
    return calls


@pytest.mark.parametrize("L", [3, 8, 9])
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_generate_quant_matches_jax_fused(quant, L, step_calls,
                                          monkeypatch):
    """generate(quant=int8|int4) at B=1 token for token against the JAX
    package's fused lane (its kernel in interpret mode), across the prompt
    bucketing edges, one K1 call a decode step in the format's mode; the
    prefill token comes from the float weights in both."""
    monkeypatch.setattr(jds, "fused_decode_token",
                        functools.partial(jds.fused_decode_token,
                                          interpret=True))
    jm, tm = models(L)
    ids = (np.arange(L)[None] * 37 + 1) % 256
    with pdn.no_grad():
        want = stream(jm.generate(ids, 24, chunk=8, fused=True, quant=quant))
        plain = stream(jm.generate(ids, 24, fused=False))
    got = stream(tm.generate(ids, 24, chunk=8, quant=quant))
    assert got == want and len(got) == 24 - L
    assert got[0] == plain[0]  # the prefill stays full precision
    assert step_calls == [quant == "int4"] * (24 - L - 1)
