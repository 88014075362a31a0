"""float16 through the port's decode kernels, their serving and training
paths against the JAX package, on the CPU.

The JAX package runs float16 through its Pallas kernels (it checks no
float type); the port runs float16 through its kernels' float16 instances,
and on CPU tensors through their plain versions, which these tests hold
against JAX's kernels in interpret mode. Weights come from a seeded JAX
model and reach the port through ``params_from_tpu``; caches are seeded
NumPy rows rounded to float16, the same bits in both packages (JAX's lane-
padded with zeros).

Where the two round differently. Both round the normed rows to float16
before each product and keep float32 sums, the float32 residual stream and
``quantize_kv``'s rule, so the first layer's new K and V rows come from the
same inputs and differ by float32 summation order only: within one float16
ulp of the row's largest entry. JAX's kernel also rounds its online
softmax's probabilities and sums to float16 (``p.astype(cdtype)``,
``pydynet_tpu/ops/decode_step.py:411-423``); the port keeps them float32,
as its kernels do for bfloat16. So the layers after the first see inputs
that differ by about a float16 ulp of p (2^-11 relative), and their rows
and the logits get the tolerances measured below with a margin.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydynet_tpu as pdn
from pydynet_tpu import optim as joptim
from pydynet_tpu.models.llama.model import Llama as JLlama
from pydynet_tpu.models.llama.serve import LlamaServer as JServer
from pydynet_tpu.ops import decode_step as jdsk

from pydynet_tpu_torch import optim as toptim
from pydynet_tpu_torch.models.llama import Llama, params_from_tpu
from pydynet_tpu_torch.models.llama.model import (decode_quant_kwargs,
                                                  decode_weight_args)
from pydynet_tpu_torch.models.llama.serve import LlamaServer
from pydynet_tpu_torch.ops import decode_step as tdsk
from pydynet_tpu_torch.utils import fidelity as tfid

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

TINY = dict(vocab_size=256, embed_dim=32, n_heads=2, ffn_dim=64,
            max_seq_len=32, max_batch_size=3, n_layers=2)
# tests/test_torch_gqa.py's narrow-KV config: Dkv = 2 * 16 = 32 of D = 128
GQA = dict(vocab_size=256, embed_dim=128, n_heads=8, n_kv_heads=2,
           ffn_dim=64, max_seq_len=32, max_batch_size=3, n_layers=2)
STARTS = np.array([0, 2, 5], np.int32)  # row 2 starts at the first step
# logits against JAX's, as a share of their largest |value|: float layers
# 4e-3 (measured up to 1.6e-3 over two seeds and every float mode); with
# a quantized matmul 5e-2 (measured up to 2.5e-2: an activation pushed
# across a rounding boundary by JAX's float16 p quantizes one step apart
# and moves a logit by about max |w| * amax / 127)
LOGITS_RTOL = {"float": 4e-3, "quant": 5e-2}
# the rows of the layers after the first, absolute (values O(1)): float
# layers 2^-7 (measured up to 3.9e-3), quantized layers 1/8 (up to 0.078:
# a whole int4 or int8 step of an activation, carried through wo, the FFN
# and the residual)
DEEP_ATOL = {"float": 2.0**-7, "quant": 0.125}
# the int8 KV cache: entries at most one apart (a value within float noise
# of a half step), scales within 2^-10 relative (measured up to 5.5e-4:
# the scale is a row's amax / 127, and the row's inputs differ by JAX's
# float16 p after the first layer)
KV8_SCALE_RTOL = 2.0**-10
IDS = np.array([[1, 5, 9]])


@pytest.fixture
def interp(monkeypatch):
    """The JAX package's decode kernels in interpret mode."""
    for name in ("fused_decode_token", "fused_decode_token_batched"):
        monkeypatch.setattr(jdsk, name, functools.partial(
            getattr(jdsk, name), interpret=True))


def models(seed, cfg=TINY):
    """A seeded float32 JAX model and its port, with the same weights."""
    np.random.seed(seed)
    jm = JLlama(dtype=np.float32, **cfg)
    jm.eval()
    tm = Llama(**cfg, device="cpu")
    tm.load_state_dict(params_from_tpu(
        {n: p.numpy() for n, p in jm._parameters.items()}), strict=True)
    return jm, tm.eval()


def stream(gen):
    return [int(t.numpy()[0, 0]) for t in gen]


def _pad(c):
    d = c.shape[-1]
    return np.pad(c, ((0, 0),) * (c.ndim - 1)
                  + ((0, jdsk.lane_pad_dim(d) - d),))


def _f16_ulp_close(got, want):
    """Each row (last axis) within one float16 ulp of its largest |entry|:
    the row's float32 sums differ by summation order, and a normed input
    within that noise of a float16 rounding boundary may round to the
    neighbouring value in one of the two, which moves an entry by |w| times
    that input's ulp, a fraction of the row's ulp."""
    got, want = got.astype(np.float32), want.astype(np.float32)
    big = np.maximum(np.abs(got), np.abs(want)).max(-1, keepdims=True)
    ulp = np.spacing(big.astype(np.float16)).astype(np.float32)
    assert (np.abs(got - want) <= ulp).all(), \
        float((np.abs(got - want) / ulp).max())


# (quant, rows: None for K1, the int8 KV cache, the narrow model)
MODES = {"k1": (None, None, False, False),
         "k1-int8head": ("int8-head", None, False, False),
         "k1-int8": ("int8", None, False, False),
         "k1-int4": ("int4", None, False, False),
         "k1-narrow": (None, None, False, True),
         "k2-starts": (None, 3, False, False),
         "k2-kv8": (None, 3, True, False),
         "k2-int8": ("int8", 3, False, False),
         "k2-int4": ("int4", 3, False, False),
         "k2-narrow": (None, 3, False, True),
         "k2-narrow-kv8": (None, 3, True, True)}


@pytest.mark.parametrize("mode", list(MODES))
def test_plain_steps_match_jax_kernels_in_float16(interp, mode):
    """Two steps (pos 5 and 6) of K1 or K2 (B = 3, per-row starts, row 2
    starting at the first step) with float16 weights and caches: JAX's
    kernel (the JAX model's own fused_step(_batched), interpret mode,
    emit_logits) against the port's plain step in emit and argmax modes.
    The first layer's new rows within one float16 ulp, the later layers'
    within DEEP_ATOL, the logits within LOGITS_RTOL of their scale, the
    argmax mode's token equal to the emitted logits' argmax and to JAX's
    wherever JAX's top-2 margin clears twice the logits' tolerance; the
    int8 KV cache's entries at most one apart and its scales within
    KV8_SCALE_RTOL."""
    quant, B, kv8, narrow = MODES[mode]
    cfg = GQA if narrow else TINY
    jm, tm = models(1, cfg)
    jm._fused_chunk_fn = None
    fused_step, fused_step_batched = jm._make_fused_decode_fns()[5:7]
    jw = jm._fused_weights(jnp.float16, quant)
    tw = tm._fused_weights(torch.float16, quant)
    N, S, D, H = (cfg[k] for k in ("n_layers", "max_seq_len", "embed_dim",
                                   "n_heads"))
    W = decode_quant_kwargs(tw).get("n_kv_heads") or H
    W = W * D // H
    shape = (N, S, W) if B is None else (N, B, S, W)
    rng = np.random.default_rng(2)
    ck, cv = [(rng.standard_normal(shape) * 0.5).astype(np.float16)
              for _ in range(2)]
    kv = {}
    if kv8:
        (tck, tsk), (tcv, tsv) = (tdsk.quantize_kv(torch.from_numpy(c))
                                  for c in (ck, cv))
        jck = (jnp.asarray(_pad(tck.numpy())), jnp.asarray(tsk.numpy()))
        jcv = (jnp.asarray(_pad(tcv.numpy())), jnp.asarray(tsv.numpy()))
        kv = dict(sk=tsk, sv=tsv)
    else:
        tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
        jck, jcv = jnp.asarray(_pad(ck)), jnp.asarray(_pad(cv))
    kind = "float" if quant in (None,) else "quant"
    toks = np.array([17] if B is None else [17, 200, 3], np.int32)
    for pos in (5, 6):
        tpos = torch.tensor([pos], dtype=torch.int32)
        args = (tpos, torch.from_numpy(toks), *decode_weight_args(tw))
        kw = dict(n_heads=H, **decode_quant_kwargs(tw), **kv)
        if B is None:
            want, jck, jcv = fused_step(jw, jck, jcv, jnp.asarray(toks), pos,
                                        emit_logits=True)
            step = tdsk.fused_decode_token
        else:
            want, jck, jcv = fused_step_batched(
                jw, jck, jcv, jnp.asarray(toks), pos, emit_logits=True,
                starts=jnp.asarray(STARTS))
            step = tdsk.fused_decode_token_batched
            kw["starts"] = torch.from_numpy(STARTS)
        want = np.asarray(want).reshape(-1, cfg["vocab_size"])
        before = [(c[0] if kv8 else c).clone() for c in (tck, tcv)]
        got = step(*args, tck, tcv, emit_logits=True, **kw).numpy()
        greedy = step(*args, *(c.clone() for c in (tck, tcv)), **kw) \
            if not kv8 else step(*args, tck.clone(), tcv.clone(), **dict(
                kw, sk=tsk.clone(), sv=tsv.clone()))
        scale = np.abs(want).max()
        tol = LOGITS_RTOL[kind] * scale
        np.testing.assert_allclose(got, want, atol=tol)
        np.testing.assert_array_equal(greedy.numpy(), got.argmax(-1))
        top2 = np.sort(want, -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * tol
        np.testing.assert_array_equal(got.argmax(-1)[clear],
                                      want.argmax(-1)[clear])
        for mine, theirs, old in ((tck, jck, before[0]),
                                  (tcv, jcv, before[1])):
            if kv8:
                a = mine.numpy().astype(np.int32)
                b = np.asarray(theirs[0])[..., :W].astype(np.int32)
                assert np.abs(a - b).max() <= 1
            else:
                a = mine.numpy()
                b = np.asarray(theirs)[..., :W]
                assert not np.asarray(theirs)[..., W:].any()
                _f16_ulp_close(a[0], b[0])
                np.testing.assert_allclose(a[1:].astype(np.float32),
                                           b[1:].astype(np.float32),
                                           atol=DEEP_ATOL[kind])
                assert not torch.equal(mine, old)
        if kv8:
            for mine, theirs in ((tsk, jck[1]), (tsv, jcv[1])):
                np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                           rtol=KV8_SCALE_RTOL)
        toks = want.argmax(-1).astype(np.int32)


def _gate_streams(tm, got, want, prompt):
    """``got`` equal to ``want`` up to their first parting, which must fall
    on a step whose float32 top-2 margin is not confident
    (``utils/fidelity._confident``). Returns the confident steps checked."""
    n = len(want)
    _, margins, tops = tfid.greedy_truth(tm, np.asarray(prompt), n)
    conf = tfid._confident(margins[:, 0], tops[:, 0], tfid.MARGIN,
                           tfid.REL_MARGIN)
    assert len(got) == n
    checked = 0
    for i in range(n):
        if got[i] != want[i]:
            assert not conf[i], (i, got, want)
            break
        checked += int(conf[i])
    return checked


@pytest.mark.parametrize("lane", [
    dict(fused=True), dict(fused=True, quant="int8"),
    dict(fused=True, kv_quant="int8"), dict(fused=False, quant="int4"),
    dict(fused=False, flash_prefill=True)],
    ids=["fused", "fused-int8", "fused-kv8", "scan-int4", "scan-flash"])
def test_generate_float16_matches_jax(interp, lane):
    """``generate(dtype=float16)`` against the JAX package's float16
    stream of the same call (its kernels in interpret mode; its flash
    prefill ``"interpret"``): equal up to a parting at a step that is not
    confident in the float32 stream, with at least 6 confident steps
    checked. The fused lane runs K1's float16 instances (int8 layers, and
    the int8 KV cache through K2 at B = 1), the scan lane K5-K7's float16
    rows and K3's."""
    jm, tm = models(4)
    jkw = dict(lane)
    if jkw.pop("flash_prefill", None):
        jkw["flash_prefill"] = "interpret"
    with pdn.no_grad():
        want = stream(jm.generate(IDS, 20, dtype=jnp.float16, **jkw))
    got = stream(tm.generate(IDS, 20, dtype=torch.float16, **lane))
    assert _gate_streams(tm, got, want, IDS) >= 6


def test_fused_server_float16_matches_jax(interp):
    """``LlamaServer(dtype=float16)`` on the fused lane (K2's float16
    instances) against the JAX package's float16 server over three
    requests with slot recycling: each stream equal up to a parting at a
    step that is not confident in the float32 stream."""
    jm, tm = models(20)
    requests = [([1, 5, 9], 10), ([2, 7, 3, 11], 12), ([30, 20], 8)]
    kw = dict(batch_size=2, chunk=4, eos_id=-1, lane="fused")
    with pdn.no_grad():
        js = JServer(jm, dtype=jnp.float16, **kw)
        jr = [js.submit(p, max_new_tokens=n) for p, n in requests]
        jd = js.run()
    ts = LlamaServer(tm, dtype=torch.float16, **kw)
    assert ts._lane == "fused"
    tr = [ts.submit(p, max_new_tokens=n) for p, n in requests]
    td = ts.run()
    checked = sum(_gate_streams(tm, td[t].tokens, jd[j].tokens, [p])
                  for (p, _), j, t in zip(requests, jr, tr))
    assert checked >= 10


def test_finetune_step_float16_matches_jax():
    """One SGD ``finetune_step`` of a float16 model over every parameter
    (L = 12: the JAX package's dense composite, the port's plain K3/K4):
    the loss equal within float16 rounding (rtol 2^-10), every parameter
    within two float16 ulps of its largest |value| (each gradient a float16
    sum in another order), and the next step's loss as close; then greedy
    float16 streams of the stepped models by the confident-step gate.
    (Adam's eps of 1e-8 is 0 in float16: both packages' float16 Adam step
    divides 0 by 0 where a gradient is 0.)"""
    np.random.seed(1)
    jm = JLlama(dtype=np.float16, **dict(TINY, max_batch_size=1))
    tm = Llama(**dict(TINY, max_batch_size=1), device="cpu",
               dtype=torch.float16)
    tm.load_state_dict(params_from_tpu(
        {n: p.numpy() for n, p in jm._parameters.items()}), strict=True)
    everything = ("tok_embedding", "layers", "norm", "lm_head")
    jm.set_trainable_parameters(everything)
    tm.set_trainable_parameters(everything)
    jopt = joptim.SGD(jm.parameters(), lr=5e-2)
    topt = toptim.SGD([p for p in tm.parameters() if p.requires_grad],
                      lr=5e-2)
    ids = np.random.default_rng(2).integers(0, 256, size=(1, 13))
    inp, tgt = ids[:, :-1], ids[:, 1:]
    for _ in range(2):
        np.testing.assert_allclose(tm.finetune_step(inp, tgt, topt),
                                   jm.finetune_step(inp, tgt, jopt),
                                   rtol=2.0**-10)
    want = params_from_tpu({n: p.numpy() for n, p in jm._parameters.items()})
    for name, p in tm.named_parameters():
        w = want[name].float()
        ulp = float(np.spacing(np.float16(w.abs().max())))
        assert float((p.detach().float() - w).abs().max()) <= 2 * ulp, name
    jm.eval()
    tm.eval()
    with pdn.no_grad():
        want16 = stream(jm.generate(IDS, 20, dtype=jnp.float16, fused=False))
    got16 = stream(tm.generate(IDS, 20, dtype=torch.float16, fused=False))
    assert _gate_streams(tm, got16, want16, IDS) >= 6
