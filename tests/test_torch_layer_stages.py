"""K1's and K2's layer stages, as far as the CPU can hold them.

Both steps run the same stage kernels on the card
(``pydynet_tpu_torch/csrc/decode_token_batched.cuh``; their checks against
the plain step are in ``tests/test_torch_gpu.py``). Here: the lane each
repo model takes, the shared-memory formula the routing rule mirrors, and
the plain steps the kernels are held to, K2's at B = 1 against K1's and
against the JAX package's kernel in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from pydynet_tpu.ops import decode_step as jds
from pydynet_tpu_torch.models.llama import Llama
from pydynet_tpu_torch.ops import decode_step as tds
from tests.test_torch_ops import H, SB, VT, _batched_inputs, _i32

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

STORIES15M = dict(vocab_size=32000, embed_dim=288, n_heads=6, ffn_dim=768,
                  max_seq_len=1024, n_layers=6)
MODELS = {"stories15M": STORIES15M,
          "GQA_15M": dict(STORIES15M, n_kv_heads=2),  # bench.py's
          "7B": dict(vocab_size=32000, embed_dim=4096, n_heads=32,
                     ffn_dim=11008, max_seq_len=1024, n_layers=32)}
OPTIN = 232448  # bytes of shared memory a block may opt in to on sm_90


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
@pytest.mark.parametrize("batch", [1, 8, 32, 64])
@pytest.mark.parametrize("name", list(MODELS))
def test_routing_is_unchanged(name, batch, quant):
    """``fused=None`` sends stories15M and GQA_15M to the fused lane (K1 at
    B = 1, K2 above and in a server) in every format, and the 7B geometry
    to it only at B = 1 with float layers; everywhere else the 7B model
    takes the scan lane. These are the lanes the chain had before its
    layer stages moved to the tensor cores."""
    m = _dims(MODELS[name])
    fused = name != "7B" or (batch == 1 and quant in (None, "int8-head"))
    assert m.use_fused(quant, batch) == fused
    assert m.use_fused(quant, batch, batched=True) == fused


def _act_stride(k, fmt):
    """``act_rows(K).stride`` of ``csrc/mma_rows.cuh``, written out for
    each weight format: the bytes of the 64-byte weight stages that cover a
    row, then padded so that ldmatrix (or float32 fragment) reads hit 32
    banks."""
    wbytes = {"f32": 4 * k, "bf16": 2 * k, "int8": k, "int4": k // 2}[fmt]
    span = (wbytes + 63) // 64 * 64
    if fmt == "f32":
        return ((span // 4 + 31) // 32 * 32 + 4) * 4
    if fmt == "int4":
        return (2 * span + 127) // 128 * 128 + 16
    return (span + 127) // 128 * 128 + 16


FMT_ARGS = {"f32": dict(itemsize=4), "bf16": dict(itemsize=2),
            "int8": dict(itemsize=1), "int4": dict(itemsize=1, q4=True)}


@pytest.mark.parametrize("k", [2, 16, 24, 36, 48, 60, 96, 128, 288, 768,
                               4096, 11008, 12224])
def test_layer_smem_mirrors_the_kernel(k):
    """``layer_smem_bytes`` is ``layer_smem`` of the kernel: each warp's
    4-stage ring of 1 KB a 16-row tile, then the rows, and for a stage that
    normalises (``norm_smem``) the raw float32 rows and the norm weights,
    16-byte aligned; the float32 rows and weights are the widest of every
    format, so the routing rule's float32 bound covers bfloat16, int8 and
    int4 weights too."""
    for fmt, kw in FMT_ARGS.items():
        assert tds.act_row_bytes(k, **kw) == _act_stride(k, fmt), fmt
        assert _act_stride(k, fmt) <= _act_stride(k, "f32"), fmt
        for rows in (1, 8, 32):
            for tiles in (1, 2):
                ring = 8 * 4 * tiles * 16 * 64
                assert tds.layer_smem_bytes(k, rows, tiles, **kw) == \
                    ring + rows * _act_stride(k, fmt)
                for t in (2, 4):  # bfloat16 or float32 norm weights
                    assert tds.layer_smem_bytes(
                        k, rows, tiles, norm_itemsize=t, **kw) == \
                        ring + rows * _act_stride(k, fmt) + rows * k * 4 \
                        + (k * t + 15) // 16 * 16


@pytest.mark.parametrize("batch", [1, 4, 5, 8, 31, 32, 33, 64])
@pytest.mark.parametrize("dims", [(288, 6, 768), (4096, 32, 11008),
                                  (16, 2, 24), (36, 6, 60), (1024, 8, 4096),
                                  (2048, 16, 5632)],
                         ids=lambda d: "x".join(map(str, d)))
def test_batched_kernel_takes_what_fits(dims, batch):
    """``batched_kernel_takes`` is true exactly where every layer stage's
    block (q/k/v and wo with one weight tile, gate/up with two, D-wide rows,
    q/k/v and gate/up with their raw rows and norm weights; down, F-wide)
    fits the opt-in in every weight format, and the head block's ring and
    rows fit too."""
    D, Hh, F = dims
    rows = min(batch, 32)
    fits = all(tds.layer_smem_bytes(D, rows, 2, norm_itemsize=t, **kw)
               <= OPTIN and tds.layer_smem_bytes(F, rows, 1, **kw) <= OPTIN
               for kw in FMT_ARGS.values() for t in (2, 4))
    head = 4 * 128 * 64 + 4 * rows * (D + 36) <= OPTIN
    assert tds.batched_kernel_takes(D, Hh, F, batch) == (fits and head)


@pytest.mark.parametrize("qhead", [False, True], ids=["f32", "int8-head"])
def test_plain_k2_at_b1_is_plain_k1_and_jax(qhead):
    """The plain versions the kernels are held to: K2's at B = 1 gives K1's
    token, caches and logits, the same bits (its row is K1's step), and
    both follow the JAX package's ``fused_decode_token`` in interpret mode
    over five steps: equal tokens, caches within 1e-5 (float32, only the
    summation order differs)."""
    ja, ta = _batched_inputs(21, 1, qhead)
    c = ta["consts"]
    jck, jcv = ja["ck"][:, 0], ja["cv"][:, 0]
    bck, bcv = ta["ck"].clone(), ta["cv"].clone()
    ck, cv = ta["ck"][:, 0].clone(), ta["cv"][:, 0].clone()
    tok = 5
    for pos in range(3, 8):
        jn, jck, jcv = jds.fused_decode_token(
            pos, jnp.asarray([tok], jnp.int32), *ja["consts"], jck, jcv,
            vt=VT, sb=SB, interpret=True, head_s=ja["head_s"])
        kw = dict(n_heads=H, head_s=ta["head_s"])
        lg2 = tds.decode_token_batched_logits_ref(
            _i32(pos), torch.tensor([tok], dtype=torch.int32), *c,
            bck.clone(), bcv.clone(), **kw)
        lg1 = tds.decode_token_logits_ref(_i32(pos), _i32(tok), *c,
                                          ck.clone(), cv.clone(), **kw)
        assert torch.equal(lg2[0], lg1)
        t2 = tds.fused_decode_token_batched(
            _i32(pos), torch.tensor([tok], dtype=torch.int32), *c, bck, bcv,
            **kw)
        t1 = tds.fused_decode_token(_i32(pos), _i32(tok), *c, ck, cv, **kw)
        assert int(t2[0]) == int(t1[0]) == int(jn[0]), pos
        assert torch.equal(bck[:, 0], ck) and torch.equal(bcv[:, 0], cv)
        D = ck.shape[-1]
        np.testing.assert_allclose(ck.numpy(), np.asarray(jck)[..., :D],
                                   atol=1e-5)
        np.testing.assert_allclose(cv.numpy(), np.asarray(jcv)[..., :D],
                                   atol=1e-5)
        tok = int(t1[0])
