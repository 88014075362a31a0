"""The batched decode step above 32 rows (K2's row groups) through the
port's ``generate`` and ``LlamaServer``, against the JAX package, on the
CPU.

The CUDA kernel takes its rows in groups of 32 (a warp keeps row b of a
group in lane b); its plain version, which runs here because the tensors
are on the CPU, takes each row on its own, so these tests hold the port's
wide-batch plumbing (routing, caches, starts, the server's slots) to the
JAX package's streams. Weights come from a seeded JAX model and reach the
port through ``params_from_tpu``; the JAX batched kernel runs in interpret
mode, as ``tests/test_serve.py`` runs it, where a test compares with the
JAX package's fused lane.
"""
import functools

import numpy as np
import pytest

import pydynet_tpu as pdn
from pydynet_tpu.models.llama.model import Llama as JLlama
from pydynet_tpu.ops import decode_step as jdsk

from pydynet_tpu_torch.models.llama import Llama, params_from_tpu
from pydynet_tpu_torch.models.llama.serve import LlamaServer
from pydynet_tpu_torch.ops import decode_step as tdsk

# tests/test_serve.py's tiny config with one layer: the plain batched step
# loops over 33-42 rows in Python, so depth is what these tests pay for
TINY = dict(vocab_size=256, embed_dim=32, n_heads=2, ffn_dim=64,
            max_seq_len=32, max_batch_size=2, n_layers=1)


def models(seed, **over):
    """A seeded JAX model and its port, with the same weights."""
    cfg = dict(TINY, **over)
    np.random.seed(seed)
    jm = JLlama(dtype=np.float32, **cfg)
    jm.eval()
    tm = Llama(**cfg, device="cpu")
    tm.load_state_dict(params_from_tpu(
        {n: p.numpy() for n, p in jm._parameters.items()}), strict=True)
    return jm, tm.eval()


@pytest.fixture
def interp(monkeypatch):
    """JAX's batched kernel in interpret mode."""
    monkeypatch.setattr(jdsk, "fused_decode_token_batched",
                        functools.partial(jdsk.fused_decode_token_batched,
                                          interpret=True))


@pytest.fixture
def batched_calls(monkeypatch):
    """Row counts of the port's fused_decode_token_batched calls (on the
    CPU they run the plain version, which the launch counter does not
    count)."""
    calls = []
    real = tdsk.fused_decode_token_batched

    def spy(*args, **kwargs):
        calls.append(args[1].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(tdsk, "fused_decode_token_batched", spy)
    return calls


def rows(gen):
    """A generate stream as a (T, B) array."""
    return np.concatenate([t.numpy() for t in gen], axis=1).T


def prompts(batch, seed):
    return np.random.default_rng(seed).integers(1, 256, size=(batch, 3))


@pytest.mark.parametrize("batch", [33, 40])
def test_generate_above_32_rows_matches_jax(batch, batched_calls):
    """``generate(fused=None)`` at B=33 and 40 takes the batched step, one
    call over all rows a decode token, and every row's stream equals the
    JAX package's ``generate(fused=False)``."""
    jm, tm = models(batch)
    ids = prompts(batch, batch)
    with pdn.no_grad():
        want = rows(jm.generate(ids, 9, chunk=3, fused=False))
    got = rows(tm.generate(ids, 9, chunk=3))
    assert got.shape == (6, batch)
    np.testing.assert_array_equal(got, want)
    assert batched_calls == [batch] * 5


def test_generate_above_32_rows_with_int8_kv_cache_matches_jax(
        interp, batched_calls):
    """B=33 with the int8 KV cache (its (rows, scales) cache pairs at B>32):
    the port's batched step in that mode, one call a decode token, and
    streams equal to the JAX package's fused lane with the int8 KV cache
    (its batched kernel in interpret mode). The weight formats' row groups
    are held against the plain version on the card
    (``tests/test_torch_gpu.py``)."""
    jm, tm = models(5)
    ids = prompts(33, 6)
    with pdn.no_grad():
        want = rows(jm.generate(ids, 6, chunk=5, fused=True,
                                kv_quant="int8"))
    got = rows(tm.generate(ids, 6, chunk=5, kv_quant="int8"))
    np.testing.assert_array_equal(got, want)
    assert batched_calls == [33] * 2


@pytest.mark.parametrize("batch", [33, 40])
def test_server_above_32_slots_matches_jax(batch, batched_calls):
    """A ``LlamaServer`` with 33 and 40 slots serves two requests more
    than it has slots (those two admitted into recycled slots at shifted
    positions) through one batched call over every slot a dispatched step,
    and every request's stream equals the JAX package's standalone
    ``generate(fused=False)`` of its prompt: a shifted admission's rotary
    rows agree with the unshifted ones up to float rounding, and these
    float32 streams have no near-tie."""
    jm, tm = models(batch + 1)
    rng = np.random.default_rng(batch)
    n = batch + 2
    ids = rng.integers(1, 256, size=(n, 3))
    new = rng.integers(2, 5, size=n)
    new[0] = 8  # still decoding when the last two are admitted
    with pdn.no_grad():
        want = rows(jm.generate(ids, 3 + int(new.max()), fused=False))
    srv = LlamaServer(tm, batch_size=batch, chunk=4, eos_id=-1)
    assert srv._lane == "fused" and srv._ck.shape == (1, batch, 32, 32)
    tr = [srv.submit(ids[i], max_new_tokens=int(new[i])) for i in range(n)]
    td = srv.run()
    assert [td[r].tokens for r in tr] == [want[:new[i], i].tolist()
                                          for i in range(n)]
    assert (srv._starts > 0).any()  # a recycled slot's shifted admission
    assert batched_calls == [batch] * srv.dispatched_steps > []


def test_batched_step_rows_are_independent_above_32():
    """The plain batched step at B=40 with per-row starts gives each row
    what the B=1 step gives on that row alone from its start: the contract
    the kernel's row groups keep."""
    import torch

    from pydynet_tpu_torch.models.llama.model import (decode_quant_kwargs,
                                                      decode_weight_args)

    _, tm = models(9)
    w = tm._fused_weights(None, None)
    rng = np.random.default_rng(10)
    ck = torch.from_numpy(rng.standard_normal((1, 40, 32, 32))
                          .astype(np.float32))
    cv = torch.from_numpy(rng.standard_normal((1, 40, 32, 32))
                          .astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, 256, 40).astype(np.int32))
    starts = torch.from_numpy(rng.integers(0, 12, 40).astype(np.int32))
    pos = torch.tensor([11], dtype=torch.int32)
    rck, rcv = ck.clone(), cv.clone()
    got = tdsk.fused_decode_token_batched(
        pos, toks, *decode_weight_args(w), ck, cv, n_heads=2, starts=starts,
        emit_logits=True, **decode_quant_kwargs(w))
    for b in range(40):
        one = tdsk.decode_token_logits_ref(
            pos, toks[b:b + 1], *decode_weight_args(w), rck[:, b],
            rcv[:, b], n_heads=2, start=int(starts[b]))
        torch.testing.assert_close(got[b], one, rtol=0, atol=0)
    torch.testing.assert_close(ck, rck, rtol=0, atol=0)
    assert tdsk.batched_kernel_takes(288, 6, 768, 64)
    assert tdsk.batched_kernel_takes(288, 6, 768, 1024)
    assert not tdsk.batched_kernel_takes(288, 6, 768, 65536)
