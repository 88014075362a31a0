"""The port's CUDA decode kernels against their plain PyTorch versions, on a
GPU.

    python -m pytest -m gpu tests/test_torch_gpu.py -q

Needs a CUDA GPU and nvcc; without a GPU every test here skips. The kernels
have no interpret mode, so they run only on the card.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the decode kernel runs only on the "
                    "card")
    from pydynet_tpu_torch.models.llama import Llama
    from chip_smoke import CFG

    torch.backends.cuda.matmul.allow_tf32 = False
    return Llama(**CFG, device="cuda",
                 generator=torch.Generator().manual_seed(0)).eval()


# positions around the 64-row attention blocks: one row, a full block, one
# row more, and the same at 512 and at the cache's end (1030 acts as 1023)
STAGE_POSITIONS = [0, 63, 64, 511, 512, 1023]


@pytest.mark.parametrize("pos", [1, 17, 255, 1030] + STAGE_POSITIONS)
@pytest.mark.parametrize("fmt", ["f32", "bf16", "bf16-int8head", "f32-int8",
                                 "bf16-int8", "bf16-int4"])
def test_kernel_matches_plain(model, fmt, pos):
    """Tokens equal (bf16: where the plain top-2 margin is confident) and
    caches within chip_smoke's stated tolerance, with float, int8 and int4
    layers."""
    from chip_smoke import FORMATS, cache_atol, kernel_vs_plain

    with torch.no_grad():
        got, want, confident, err = kernel_vs_plain(model, fmt, pos)
    assert err <= cache_atol(fmt)
    if FORMATS[fmt][0] == torch.float32 or confident:
        assert got == want


@pytest.mark.parametrize("qhead", [False, True], ids=["bf16", "int8-head"])
def test_kernel_cross_tile_tie_goes_low(model, qhead):
    """Rows 10 and 20000 (different vocab tiles) tie for the maximum."""
    from chip_smoke import random_caches, step_args
    from pydynet_tpu_torch.ops import decode_step as dsk

    w = dict(model._fused_weights(torch.bfloat16,
                                  "int8-head" if qhead else None))
    key = "head_wq" if qhead else "head_w"
    head = torch.zeros_like(w[key])
    head[10] = head[20000] = w[key][5]
    bias = torch.zeros_like(w["head_b"])
    bias[10] = bias[20000] = 100.0
    w[key], w["head_b"] = head, bias
    ck, cv = random_caches(model, torch.bfloat16, 2)
    args, kw = step_args(model, w, ck, cv, 40, 321)
    assert int(dsk.fused_decode_token(*args, **kw)[0]) == 10
    assert int(dsk.fused_decode_token_ref(*args, **kw)[0]) == 10


def test_launch_counter_counts_kernel_launches_only(model):
    from chip_smoke import random_caches, step_args
    from pydynet_tpu_torch.ops import decode_step as dsk

    w = model._fused_weights(torch.bfloat16, None)
    ck, cv = random_caches(model, torch.bfloat16, 3)
    args, kw = step_args(model, w, ck, cv, 7, 11)
    before = dsk.fused_decode_token.launches
    for _ in range(3):
        dsk.fused_decode_token(*args, **kw)
    dsk.fused_decode_token_ref(*args, **kw)
    assert dsk.fused_decode_token.launches - before == 3
    before = dsk.fused_decode_token.launches
    toks = list(model.generate(np.array([[1, 243, 532, 991]]), 20,
                               dtype=torch.bfloat16))
    assert len(toks) == 16
    assert dsk.fused_decode_token.launches - before == 15


def test_cpu_inputs_never_launch(model):
    from pydynet_tpu_torch.models.llama import Llama
    from pydynet_tpu_torch.ops import decode_step as dsk

    cpu = Llama(vocab_size=256, embed_dim=32, n_heads=2, ffn_dim=64,
                max_seq_len=32, n_layers=2, device="cpu").eval()
    before = dsk.fused_decode_token.launches
    assert len(list(cpu.generate(np.array([[1, 5, 9]]), 12))) == 9
    assert dsk.fused_decode_token.launches == before


@pytest.mark.parametrize("batch", [4, 32, 1, 3, 8, 33, 64, 31])
@pytest.mark.parametrize("pos", [17, 1030] + STAGE_POSITIONS)
@pytest.mark.parametrize("fmt", ["f32", "bf16", "bf16-int8head", "bf16-int8",
                                 "bf16-int4", "f32-kv8", "bf16-kv8"])
def test_batched_kernel_matches_plain(model, fmt, pos, batch):
    """K2 with per-row starts (row 0 starting at pos, so all its 64-row
    blocks but the last are empty), with float, int8 and int4 layers and the
    int8 KV cache, at n8 tiles of 1, 4 and 4 rows and one and two row
    groups: tokens equal (float32 weights: every row; bf16: at confident
    rows) and caches within chip_smoke's stated tolerance."""
    from chip_smoke import batched_vs_plain, cache_ok, fmt_of

    with torch.no_grad():
        got, want, conf, err = batched_vs_plain(model, fmt, batch, pos)
    assert cache_ok(fmt, err), err
    must = torch.ones_like(conf) if fmt_of(fmt)[0] == torch.float32 else conf
    assert torch.equal(got[must], want[must])


@pytest.mark.parametrize("fmt", ["f32", "bf16", "bf16-int8head", "bf16-int8",
                                 "bf16-int4", "f32-kv8", "bf16-kv8"])
def test_batched_rows_match_k1(model, fmt):
    """Each K2 row starting at 0 gives K1's token and cache row on that row
    alone (the int8 KV cache, which K1 lacks: K2's at B=1)."""
    from chip_smoke import batched_rows_vs_one, cache_ok

    with torch.no_grad():
        equal, err = batched_rows_vs_one(model, fmt)
    assert equal and cache_ok(fmt, err), err


@pytest.mark.parametrize("qhead", [False, True], ids=["bf16", "int8-head"])
def test_batched_cross_tile_tie_goes_low(model, qhead):
    """Rows 10 and 20000 (different vocab tiles) tie in every row; two rows
    with different inputs both pick 10."""
    from chip_smoke import batched_args, random_caches
    from pydynet_tpu_torch.ops import decode_step as dsk

    w = dict(model._fused_weights(torch.bfloat16,
                                  "int8-head" if qhead else None))
    key = "head_wq" if qhead else "head_w"
    head = torch.zeros_like(w[key])
    head[10] = head[20000] = w[key][5]
    bias = torch.zeros_like(w["head_b"])
    bias[10] = bias[20000] = 100.0
    w[key], w["head_b"] = head, bias
    ck, cv = random_caches(model, torch.bfloat16, 2, 2)
    args, kw = batched_args(model, w, ck, cv, 40, [321, 7], [0, 30])
    assert dsk.fused_decode_token_batched(*args, **kw).tolist() == [10, 10]
    assert dsk.fused_decode_token_batched_ref(*args, **kw).tolist() == \
        [10, 10]


def test_batched_starts_hide_stale_rows(model):
    """Rows below a row's start hold a recycled slot's old request: large
    values there change neither the tokens nor the rows from the start."""
    from chip_smoke import batched_args, random_caches
    from pydynet_tpu_torch.ops import decode_step as dsk

    w = model._fused_weights(torch.float32, None)
    ck, cv = random_caches(model, torch.float32, 4, 4)
    starts = [0, 100, 500, 700]
    dirty_k, dirty_v = ck.clone(), cv.clone()
    for b, lo in enumerate(starts):
        dirty_k[:, b, :lo] = 1e4
        dirty_v[:, b, :lo] = -1e4
    args, kw = batched_args(model, w, ck, cv, 700, [1, 2, 3, 4], starts)
    clean = dsk.fused_decode_token_batched(*args, **kw)
    args, kw = batched_args(model, w, dirty_k, dirty_v, 700, [1, 2, 3, 4],
                            starts)
    assert torch.equal(dsk.fused_decode_token_batched(*args, **kw), clean)
    for b, lo in enumerate(starts):
        assert torch.equal(dirty_k[:, b, lo:], ck[:, b, lo:])
        assert torch.equal(dirty_v[:, b, lo:], cv[:, b, lo:])


def test_batched_launch_counter_counts_kernel_launches_only(model):
    from chip_smoke import batched_args, random_caches
    from pydynet_tpu_torch.models.llama.serve import LlamaServer
    from pydynet_tpu_torch.ops import decode_step as dsk

    k2 = dsk.fused_decode_token_batched
    w = model._fused_weights(torch.bfloat16, None)
    ck, cv = random_caches(model, torch.bfloat16, 3, 4)
    args, kw = batched_args(model, w, ck, cv, 7, [11, 12, 13, 14])
    before = k2.launches
    for _ in range(3):
        k2(*args, **kw)
    dsk.fused_decode_token_batched_ref(*args, **kw)
    assert k2.launches - before == 3
    before = k2.launches
    rows = list(model.generate(np.array([[1, 243, 532, 991]] * 3), 20,
                               dtype=torch.bfloat16))
    assert len(rows) == 16 and k2.launches - before == 15
    for kw in ({}, dict(quant="int8"), dict(quant="int4"),
               dict(kv_quant="int8")):
        before = k2.launches
        srv = LlamaServer(model, batch_size=2, dtype=torch.bfloat16, chunk=8,
                          eos_id=-1, **kw)
        for prompt in ([1, 5, 9], [2, 7, 3, 11], [30, 20]):
            srv.submit(prompt, max_new_tokens=12)
        assert all(r.done for r in srv.run().values())
        assert k2.launches - before == srv.dispatched_steps > 0
    before = k2.launches
    rows = list(model.generate(np.array([[1, 243, 532, 991]]), 20,
                               dtype=torch.bfloat16, kv_quant="int8"))
    assert len(rows) == 16 and k2.launches - before == 15


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the flash-attention kernels run only "
                    "on the card")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("L", [1, 7, 64, 1000, 1024])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_kernels_match_plain(gpu, dtype, B, L):
    """K3 and both K4 kernels within chip_smoke's stated tolerances of their
    plain versions at the training path's shapes (B, L, 6, 48)."""
    from chip_smoke import FLASH_DTYPES, flash_vs_plain

    errs = flash_vs_plain(B, L, FLASH_DTYPES[dtype])
    assert set(errs) == {"o", "lse", "dq", "dk", "dv"}


@pytest.mark.parametrize("d", [16, 64, 100, 128, 256])
def test_flash_kernels_take_every_head_dim(gpu, d):
    """Each register-tile width (d <= 64, 128, 256), odd L, and gradients
    through the autograd op against the plain composite's."""
    from pydynet_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(d)
    q, k, v, do = (torch.randn((2, 77, 3, d), generator=g, device="cuda")
                   .requires_grad_() for _ in range(4))
    out = fa.flash_attention_causal(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), do)
    ref = fa.mha_reference(q, k, v, fa.causal_mask(77, device="cuda"))
    want = torch.autograd.grad(ref, (q, k, v), do)
    assert float((out - ref).abs().max()) < 2e-5
    for a, b in zip(grads, want):
        assert float((a - b).abs().max()) < 5e-4


# K4's tilings: each head-dim chunking (d <= 64, 128, 256), head dims that
# are no multiple of 8 or 16 (the narrow copies), L around the 16-row
# fragments and the 64-row tiles
FLASH_DIMS = [16, 32, 48, 64, 80, 100, 128, 256]
FLASH_LENS = [1, 15, 16, 17, 63, 65, 1000, 1024]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("L", FLASH_LENS)
@pytest.mark.parametrize("d", FLASH_DIMS)
def test_flash_backward_tiles_match_plain(gpu, d, L, dtype):
    """K3 and both K4 kernels within ``FLASH_ATOL`` of their plain versions
    at (1, L, 3, d)."""
    from chip_smoke import FLASH_DTYPES, flash_vs_plain

    errs = flash_vs_plain(1, L, FLASH_DTYPES[dtype], seed=d + L, d=d,
                          heads=3)
    assert set(errs) == {"o", "lse", "dq", "dk", "dv"}


@pytest.mark.parametrize("d", [48, 100, 256])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_backward_is_deterministic(gpu, dtype, d):
    """Two calls of each K4 kernel on the same inputs give the same bits:
    no float is summed across blocks or with atomics."""
    from chip_smoke import FLASH_DTYPES, flash_inputs
    from pydynet_tpu_torch.ops import flash_attention as fa

    q, k, v, do = flash_inputs(8, 1024, FLASH_DTYPES[dtype], 3, d=d)
    o, lse = fa.flash_attention_fwd(q, k, v)
    dd = fa.attention_dd(o, do)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, dd)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, dd)
    assert torch.equal(dq, fa.flash_attention_bwd_dq(q, k, v, do, lse, dd))
    for a, b in zip((dk, dv), fa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                          dd)):
        assert torch.equal(a, b)


def test_flash_cuda_inputs_never_fall_back(gpu):
    from pydynet_tpu_torch.ops import flash_attention as fa

    q = torch.zeros((1, 8, 2, 264), device="cuda")
    with pytest.raises(ValueError, match="limits"):
        fa.flash_attention_fwd(q, q, q)
    h = torch.zeros((1, 8, 2, 16), device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="limits"):
        fa.flash_attention_fwd(h, h, h)


def test_full_parameter_step_matches_cpu(gpu):
    """One Adam step of the stories15M model at B=1, L=1024, every parameter
    trainable, on the card (through the kernels: 6 launches each) against
    the same step on the CPU, within chip_smoke's stated tolerances."""
    from chip_smoke import (FLASH_KERNELS, TRAIN_LOSS_RTOL, check_step_vs_cpu,
                            flash_counters, train_model, train_pair)

    inp, tgt = train_pair()
    gpu_model, opt = train_model("cuda")
    cpu_model, cpu_opt = train_model("cpu")
    before = [c.launches for c in flash_counters()]
    loss = gpu_model.finetune_step(inp, tgt, opt)
    assert [c.launches - b for c, b in zip(flash_counters(), before)] == \
        [6] * len(FLASH_KERNELS)
    cpu_loss = cpu_model.finetune_step(inp, tgt, cpu_opt)
    assert abs(loss - cpu_loss) <= TRAIN_LOSS_RTOL * abs(cpu_loss)
    check_step_vs_cpu(gpu_model, cpu_model)


# chip_smoke.QMM_SHAPES: stories15M's and Llama-2-7B's (K, N)
QMM_CASES = [(288, 864), (288, 288), (288, 1536), (768, 288), (288, 32000),
             (4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096),
             (4096, 32000)]


@pytest.mark.parametrize("q4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 12, 16, 32, 33, 256])
@pytest.mark.parametrize("shape", QMM_CASES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_qmatmul_matches_plain(gpu, shape, M, q4):
    """K5 (M <= 32) and K6 (M > 32) bit for bit against the plain version,
    float32 and bfloat16 rows, at stories15M's and Llama-2-7B's shapes: every
    decode row tile (1, 2, 4, 8 rows), full and partial (M = 3, 5, 12)."""
    from chip_smoke import random_qweights, random_rows
    from pydynet_tpu_torch.ops import gemv_quant as gq

    K, N = shape
    w, ws = random_qweights(K, N, q4, K + N)
    for dtype in (torch.float32, torch.bfloat16):
        x = random_rows(M, K, dtype, M)
        assert torch.equal(gq.qmatmul(x, w, ws, q4=q4),
                           gq.qmatmul_ref(x, w, ws, q4=q4))
        for got, want in zip(gq.quantize_rows(x), gq.quantize_rows_ref(x)):
            assert torch.equal(got, want)


@pytest.mark.parametrize("q4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 12, 33])
def test_qmatmul_stacked_device_index(gpu, M, q4):
    """K7 reads its layer from a device tensor (first, middle, last of 32)
    or a Python int; an index past the stack is clamped, as
    ``jax.lax.dynamic_index_in_dim`` clamps it."""
    from chip_smoke import random_qweights, random_rows
    from pydynet_tpu_torch.ops import gemv_quant as gq

    w, ws = random_qweights(512, 1024, q4, 3, layers=32)
    x = random_rows(M, 512, torch.bfloat16, M)
    for layer in (0, 16, 31):
        want = gq.qmatmul_ref(x, w[layer], ws[layer], q4=q4)
        idx = torch.tensor(layer, dtype=torch.int32, device="cuda")
        assert torch.equal(gq.qmatmul_stacked(x, w, ws, idx, q4=q4), want)
        assert torch.equal(gq.qmatmul_stacked(x, w, ws, layer, q4=q4), want)
    big = torch.tensor(40, dtype=torch.int32, device="cuda")
    assert torch.equal(gq.qmatmul_stacked(x, w, ws, big, q4=q4),
                       gq.qmatmul_ref(x, w[31], ws[31], q4=q4))


# K6's tile edges: M around the 64-row tile and the 16-row fragments, K
# whose rows are no multiple of 16 or 4 bytes (the narrow copies; int4's
# K / 2 = 145 odd), N = 4 and 292 (no multiple of the 256-column tile)
K6_ROWS = [33, 64, 65, 127, 128, 129, 255, 257, 1000]
K6_SHAPES = [(100, 4), (100, 292), (104, 292), (290, 4), (290, 292),
             (288, 292)]


@pytest.mark.parametrize("q4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("M", K6_ROWS)
@pytest.mark.parametrize("shape", K6_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_prefill_kernel_tile_edges(gpu, shape, M, q4):
    """K6 bit for bit against the plain version, float32 and bfloat16
    rows."""
    from chip_smoke import random_qweights, random_rows
    from pydynet_tpu_torch.ops import gemv_quant as gq

    K, N = shape
    w, ws = random_qweights(K, N, q4, K + N + M)
    for dtype in (torch.float32, torch.bfloat16):
        x = random_rows(M, K, dtype, M + K)
        assert torch.equal(gq.qmatmul(x, w, ws, q4=q4),
                           gq.qmatmul_ref(x, w, ws, q4=q4))


@pytest.mark.parametrize("q4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("M", [65, 257, 1000])
def test_prefill_stacked_device_index(gpu, M, q4):
    """K7 above 32 rows (the prefill kernel) reads its layer from a device
    tensor, ragged K and N included."""
    from chip_smoke import random_qweights, random_rows
    from pydynet_tpu_torch.ops import gemv_quant as gq

    for K, N in ((512, 1024), (290, 292)):
        w, ws = random_qweights(K, N, q4, M, layers=8)
        x = random_rows(M, K, torch.bfloat16, M)
        for layer in (0, 5, 7):
            idx = torch.tensor(layer, dtype=torch.int32, device="cuda")
            assert torch.equal(gq.qmatmul_stacked(x, w, ws, idx, q4=q4),
                               gq.qmatmul_ref(x, w[layer], ws[layer], q4=q4))


def test_qmatmul_launch_counters_count_kernel_launches_only(gpu):
    from chip_smoke import random_qweights, random_rows
    from pydynet_tpu_torch.ops import gemv_quant as gq

    w, ws = random_qweights(288, 864, False, 1)
    counters = (lambda: (gq.quantize_rows.launches, gq.qmatmul.launches,
                         gq.qmatmul.prefill_launches,
                         gq.qmatmul_stacked.launches))
    before = counters()
    gq.qmatmul(random_rows(4, 288, torch.float32, 0), w, ws)
    gq.qmatmul(random_rows(40, 288, torch.float32, 0), w, ws)
    gq.qmatmul_stacked(random_rows(2, 288, torch.float32, 0), w[None],
                       ws[None], 0)
    gq.qmatmul_ref(random_rows(4, 288, torch.float32, 0), w, ws)
    gq.qmatmul(random_rows(4, 288, torch.float32, 0).cpu(), w.cpu(),
               ws.cpu())
    # quantize_rows counts only the prefill call's: the decode kernel
    # quantizes its rows itself, in its one launch
    assert [a - b for a, b in zip(counters(), before)] == [1, 1, 1, 1]


# Llama-2-7B's five decode products (fused qkv, wo, fused gate/up, down,
# head) and a K long enough that the decode kernel stages its int8 rows in
# chunks at M = 32
DECODE_7B = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096),
             (4096, 32000)]


@pytest.mark.parametrize("q4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("shape", DECODE_7B + [(32768, 256)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_kernel_every_row_count(gpu, shape, q4):
    """The one-launch decode kernel bit for bit against the plain version at
    every M in 1..32, float32 and bfloat16 rows, with a host and a device
    (clamped) layer index, through the wrappers and on both of its routes:
    its own row quantization (which the wrappers take up to
    FUSED_QUANT_MAX_ROWS rows) and rows quantized beforehand."""
    from chip_smoke import random_qweights, random_rows
    from pydynet_tpu_torch.ops import gemv_quant as gq

    K, N = shape
    w, ws = random_qweights(K, N, q4, K + N, layers=2)
    last = torch.tensor(1, dtype=torch.int32, device="cuda")
    past = torch.tensor(5, dtype=torch.int32, device="cuda")
    for M in range(1, gq.MAX_DECODE_ROWS + 1):
        for dtype in (torch.float32, torch.bfloat16):
            x = random_rows(M, K, dtype, M)
            want0 = gq.qmatmul_ref(x, w[0], ws[0], q4=q4)
            want1 = gq.qmatmul_ref(x, w[1], ws[1], q4=q4)
            assert torch.equal(gq.qmatmul(x, w[0], ws[0], q4=q4), want0)
            assert torch.equal(gq.qmatmul_stacked(x, w, ws, past, q4=q4),
                               want1)
            for route in (gq._FUSED, gq._INT8_ROWS):
                assert torch.equal(
                    gq._product(x, w[0], ws[0], q4, 0, 1, route), want0)
                assert torch.equal(gq._product(x, w, ws, q4, 0, 2, route),
                                   want0)
                assert torch.equal(
                    gq._product(x, w, ws, q4, last, 2, route), want1)
                assert torch.equal(
                    gq._product(x, w, ws, q4, past, 2, route), want1)


def test_decode_kernel_calls_back_to_back(gpu):
    """Calls of different shapes, formats and row counts, one after the
    other on one stream with nothing in between, each equal to the plain
    version: a call depends on no state that another leaves."""
    from chip_smoke import random_qweights, random_rows
    from pydynet_tpu_torch.ops import gemv_quant as gq

    cases = [(4096, 4096, False, 1), (11008, 4096, True, 4),
             (4096, 22016, False, 32), (288, 864, True, 3),
             (4096, 4096, True, 12), (4096, 12288, False, 1)]
    args = []
    for K, N, q4, M in cases:
        w, ws = random_qweights(K, N, q4, K + M)
        args.append((random_rows(M, K, torch.bfloat16, N), w, ws, q4))
    for _ in range(2):
        got = [gq.qmatmul(x, w, ws, q4=q4) for x, w, ws, q4 in args]
        for out, (x, w, ws, q4) in zip(got, args):
            assert torch.equal(out, gq.qmatmul_ref(x, w, ws, q4=q4))


@pytest.mark.parametrize("q4", [False, True], ids=["int8", "int4"])
def test_decode_kernel_graph_replay(gpu, q4):
    """The decode calls of a 7B layer, captured in a CUDA graph with a
    device layer index and replayed for several layers and new rows, equal
    the eager calls."""
    from chip_smoke import random_qweights, random_rows
    from pydynet_tpu_torch.ops import gemv_quant as gq

    mats = [random_qweights(K, N, q4, K + N, layers=3)
            for K, N in DECODE_7B[:4]]
    x = random_rows(4, 4096, torch.bfloat16, 0)
    xd = random_rows(4, 11008, torch.bfloat16, 1)
    idx = torch.zeros((), dtype=torch.int32, device="cuda")

    def calls():
        return [gq.qmatmul_stacked(xd if w.shape[1] * (2 if q4 else 1)
                                   == 11008 else x, w, ws, idx, q4=q4)
                for w, ws in mats]

    calls()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = calls()
    for layer in (2, 0, 1):
        idx.fill_(layer)
        x.copy_(random_rows(4, 4096, torch.bfloat16, 10 + layer))
        xd.copy_(random_rows(4, 11008, torch.bfloat16, 20 + layer))
        graph.replay()
        torch.cuda.synchronize()
        for out, want in zip(outs, calls()):
            assert torch.equal(out, want)


def test_qmatmul_cuda_inputs_never_fall_back(gpu):
    from chip_smoke import random_qweights, random_rows
    from pydynet_tpu_torch.ops import gemv_quant as gq

    w, ws = random_qweights(64, 8, False, 2)
    x = random_rows(2, 64, torch.float32, 0)
    with pytest.raises(ValueError, match="multiple of 4"):
        gq.qmatmul(x, w[:, :6].contiguous(), ws[:, :6].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        gq.qmatmul(random_rows(64, 2, torch.float32, 0).t(), w, ws)
    with pytest.raises(ValueError, match="x:"):
        gq.qmatmul(x.half(), w, ws)
    with pytest.raises(ValueError, match="is on cpu"):
        gq.qmatmul(x, w.cpu(), ws)


def test_scan_lane_quant_generate_on_the_card(gpu):
    """A tiny model deeper than UNROLL_MAX_LAYERS (the stacked kernel) and
    a shallow one (the per-layer kernels) decode on the scan lane with
    int8 and int4 weights through the kernels, and, teacher-forced along
    the CPU's stream, give its tokens at every confident step (float noise
    between the devices can move an activation across an int8 rounding
    boundary, so free-running streams may part at a near-tie)."""
    from pydynet_tpu_torch.models.llama import Llama
    from pydynet_tpu_torch.ops import gemv_quant as gq
    from pydynet_tpu_torch.utils import fidelity

    for n_layers in (2, 17):
        cfg = dict(vocab_size=256, embed_dim=64, n_heads=4, ffn_dim=128,
                   max_seq_len=64, n_layers=n_layers)
        gpu_m = Llama(**cfg, device="cuda").eval()
        cpu_m = Llama(**cfg, device="cpu").eval()
        ids = np.array([[1, 5, 9]])
        for quant in ("int8", "int4"):
            before = gq.qmatmul_stacked.launches + gq.qmatmul.launches
            got = [int(t[0, 0]) for t in gpu_m.generate(
                ids, 24, fused=False, quant=quant)]
            assert gq.qmatmul_stacked.launches + gq.qmatmul.launches \
                - before == 21 * (4 * n_layers + 1)
            tr, mg, tp = fidelity.scan_truth(cpu_m, ids, 21, quant=quant)
            checked, ok, _ = fidelity.gate_scan_argmax(gpu_m, ids, tr, mg, tp,
                                                       quant=quant)
            assert len(got) == 21 and checked > 0 and ok


# chip_smoke.BN_SHAPES: from one row to a wide batch, the trainer's among
BN_CASES = [(1, 7), (8, 128), (40, 512), (40, 128), (1000, 300),
            (1024, 1024), (8192, 1024)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", BN_CASES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_batchnorm_kernel_matches_plain(gpu, shape, dtype):
    """K8 and its gradients within chip_smoke's stated tolerances of the
    plain version."""
    from chip_smoke import FLASH_DTYPES, bn_vs_plain

    errs = bn_vs_plain(*shape, FLASH_DTYPES[dtype])
    assert set(errs) == {"out", "mean", "var", "dx", "dgamma", "dbeta"}


def test_batchnorm_modules_route_to_k8(gpu):
    """A 2-D BatchNorm1d input in train mode launches K8 once a forward, in
    float32 and bfloat16, and moves the running statistics; BatchNorm2d,
    eval mode and CPU inputs launch nothing."""
    from pydynet_tpu_torch import nn
    from pydynet_tpu_torch.ops import batchnorm as bn

    k8 = bn.batch_norm_train
    bn1 = nn.BatchNorm1d(64).cuda()
    x = torch.randn(16, 64, device="cuda") * 2 + 3
    before = k8.launches
    bn1(x)
    bn1.to(torch.bfloat16)(x.to(torch.bfloat16))
    assert k8.launches - before == 2
    assert float(bn1.running_mean.float().mean()) > 0.3
    before = k8.launches
    bn1.float().eval()(x)
    nn.BatchNorm2d(3).cuda()(torch.randn(4, 3, 5, 5, device="cuda"))
    nn.BatchNorm1d(64)(x.cpu())
    assert k8.launches == before


def test_dropout_bn_step_matches_cpu(gpu):
    """DNN_BN's first Adam step on the card (two K8 launches) against the
    CPU, within chip_smoke's stated tolerances."""
    from chip_smoke import check_dbn_step_vs_cpu

    check_dbn_step_vs_cpu()


def test_batchnorm_cuda_inputs_never_fall_back(gpu):
    from pydynet_tpu_torch.ops import batchnorm as bn

    g = torch.ones(1, 8, device="cuda")
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(ValueError, match="types"):
            bn.batch_norm_train(torch.zeros(4, 8, device="cuda",
                                            dtype=dtype), g, g)
    with pytest.raises(ValueError, match="contiguous"):
        bn.batch_norm_train(torch.zeros(8, 4, device="cuda").t(), g, g)
    with pytest.raises(ValueError, match="is on cpu"):
        bn.batch_norm_train(torch.zeros(4, 8, device="cuda"), g.cpu(), g)


# ------------- K9, K10 and K1's int8/int4 layers (the last slice) -------------
TINY = dict(vocab_size=256, embed_dim=32, n_heads=2, ffn_dim=64,
            max_seq_len=32, max_batch_size=1, n_layers=2)


@pytest.fixture(scope="module")
def tiny():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the decode kernels run only on the "
                    "card")
    from pydynet_tpu_torch.models.llama import Llama

    return Llama(**TINY, device="cuda",
                 generator=torch.Generator().manual_seed(4)).eval()


@pytest.mark.parametrize("pos", [0, 5, 31, 40])
@pytest.mark.parametrize("fmt", ["f32", "f32-int8", "bf16-int8", "bf16-int4"])
def test_tiny_kernel_matches_plain(tiny, fmt, pos):
    """K1 with float, int8 and int4 layers at the tiny size."""
    from chip_smoke import FORMATS, cache_atol, kernel_vs_plain

    with torch.no_grad():
        got, want, confident, err = kernel_vs_plain(tiny, fmt, pos, tok=77)
    assert err <= cache_atol(fmt)
    if FORMATS[fmt][0] == torch.float32 or confident:
        assert got == want


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_tiny_quant_generate_runs_k1(tiny, quant):
    """generate(quant=int8|int4) at B=1 takes K1 once a decode step; at
    B>1 K2 once a decode step."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    before = dsk.fused_decode_token.launches
    toks = list(tiny.generate(np.array([[1, 5, 9]]), 20, quant=quant))
    assert len(toks) == 17
    assert dsk.fused_decode_token.launches - before == 16
    before = dsk.fused_decode_token_batched.launches
    rows = list(tiny.generate(np.array([[1, 5], [2, 3]]), 8, quant=quant))
    assert len(rows) == 6 and all(r.shape == (2, 1) for r in rows)
    assert dsk.fused_decode_token_batched.launches - before == 5


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_head_kernel_matches_plain(model, tiny, dtype, seed):
    """K9 at stories15M's head and the tiny one: the plain version's
    token."""
    from chip_smoke import FLASH_DTYPES, head_vs_plain

    for m in (model, tiny):
        got, want, short = head_vs_plain(m, FLASH_DTYPES[dtype], seed)
        assert got == want and short == 0.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_head_kernel_cross_tile_tie_goes_low(model, dtype):
    from chip_smoke import FLASH_DTYPES, HEAD_TIE, head_vs_plain

    got, want, _ = head_vs_plain(model, FLASH_DTYPES[dtype], 7, tie=True)
    assert got == want == HEAD_TIE[0]


@pytest.mark.parametrize("pos", [0, 511, 1023, 1030])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_step_kernel_matches_plain(model, dtype, pos):
    """K10 at stories15M width: h_out and the caches within chip_smoke's
    tolerances, the other cache rows untouched."""
    from chip_smoke import CACHE_ATOL, FLASH_DTYPES, STEP_ATOL, step_vs_plain

    dt = FLASH_DTYPES[dtype]
    with torch.no_grad():
        h_err, c_err, kept, _ = step_vs_plain(model, dt, pos)
    assert h_err <= STEP_ATOL[dt] and c_err <= CACHE_ATOL[dt] and kept


@pytest.mark.parametrize("pos", [0, 5, 31, 40])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tiny_step_kernel_matches_plain(tiny, dtype, pos):
    from chip_smoke import CACHE_ATOL, FLASH_DTYPES, STEP_ATOL, step_vs_plain

    dt = FLASH_DTYPES[dtype]
    with torch.no_grad():
        h_err, c_err, kept, _ = step_vs_plain(tiny, dt, pos)
    assert h_err <= STEP_ATOL[dt] and c_err <= CACHE_ATOL[dt] and kept


def test_step_kernel_takes_any_rot_and_hmask(tiny):
    """K10 applies rot and hmask as given, not as the pair swap and the
    head mask: random ones against the plain version."""
    from chip_smoke import step_inputs
    from pydynet_tpu_torch.ops import decode_step as dsk

    g = torch.Generator(device="cuda").manual_seed(3)
    args = list(step_inputs(tiny, torch.float32, 9))
    args[4] = torch.randn(32, 32, generator=g, device="cuda") * 0.3
    args[5] = torch.rand(32, 2, generator=g, device="cuda")
    h, ck, cv = dsk.fused_decode_step(*args, alias=False)
    rh, rck, rcv = dsk.fused_decode_step_ref(*args, alias=False)
    assert float((h - rh).abs().max()) <= 1e-4
    assert float((ck - rck).abs().max()) <= 1e-4
    assert float((cv - rcv).abs().max()) <= 1e-4


def test_head_and_step_launch_counters_count_kernel_launches_only(tiny):
    from chip_smoke import head_inputs, step_inputs
    from pydynet_tpu_torch.ops import decode_step as dsk

    h, w, b = head_inputs(tiny, torch.float32)
    args = step_inputs(tiny, torch.float32, 3)
    k9, k10 = dsk.lm_head_argmax.launches, dsk.fused_decode_step.launches
    for _ in range(2):
        dsk.lm_head_argmax(h, w, b)
        dsk.fused_decode_step(*args)
    dsk.lm_head_argmax_ref(h, w, b)
    dsk.fused_decode_step_ref(*args)
    assert dsk.lm_head_argmax.launches - k9 == 2
    assert dsk.fused_decode_step.launches - k10 == 2


def test_head_and_step_cuda_inputs_never_fall_back(tiny):
    from chip_smoke import head_inputs, step_inputs
    from pydynet_tpu_torch.ops import decode_step as dsk

    h, w, b = head_inputs(tiny, torch.float32)
    with pytest.raises(ValueError, match="limits"):
        dsk.lm_head_argmax(torch.zeros(1, 20000, device="cuda"),
                           torch.zeros(4, 20000, device="cuda"),
                           torch.zeros(4, device="cuda"))
    with pytest.raises(ValueError, match="b"):
        dsk.lm_head_argmax(h, w, b.to(torch.bfloat16))
    args = list(step_inputs(tiny, torch.float32, 3))
    args[5] = torch.ones(32, 32, device="cuda")  # 32 heads of 1 feature
    dsk.fused_decode_step(*args)  # H = D is taken
    args[5] = torch.ones(32, 33, device="cuda")
    with pytest.raises(ValueError, match="H <= D"):
        dsk.fused_decode_step(*args)


@pytest.mark.parametrize("pos", [17, 1030] + STAGE_POSITIONS)
@pytest.mark.parametrize("fmt", ["f32", "bf16", "bf16-int8head", "f32-int8",
                                 "bf16-int8", "bf16-int4"])
def test_emit_logits_matches_plain_and_argmax_mode(model, fmt, pos):
    """K1's emit_logits mode: the (1, V) logits within chip_smoke's stated
    tolerance of the plain version's, their argmax the argmax mode's token,
    and the caches as the plain step leaves them."""
    from chip_smoke import cache_atol, emit_ok, emit_vs_plain

    with torch.no_grad():
        err, scale, same, cerr = emit_vs_plain(model, fmt, pos)
    assert emit_ok(fmt, err, scale), (err, scale)
    assert same and cerr <= cache_atol(fmt)


@pytest.mark.parametrize("batch", [4, 32, 1, 3, 8, 33, 64, 31])
@pytest.mark.parametrize("pos", [1030, 0, 64, 512])
@pytest.mark.parametrize("fmt", ["f32", "bf16", "bf16-int8head", "bf16-int8",
                                 "bf16-int4", "f32-kv8", "bf16-kv8"])
def test_batched_emit_logits_matches_plain_and_argmax_mode(model, fmt, pos,
                                                           batch):
    """K2's emit_logits mode with per-row starts, in every K2 format."""
    from chip_smoke import batched_emit_vs_plain, cache_ok, emit_ok

    with torch.no_grad():
        err, scale, same, cerr = batched_emit_vs_plain(model, fmt, batch,
                                                       pos)
    assert emit_ok(fmt, err, scale), (err, scale)
    assert same and cache_ok(fmt, cerr), cerr


def test_emit_launch_counters_count_emit_launches_only(model):
    """The emit mode counts in emit_launches, the argmax mode in launches;
    a sampled request runs the emit mode once a decode step and never the
    argmax mode."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    ids = np.array([[1, 243, 532, 991]])
    for k, B in ((dsk.fused_decode_token, 1),
                 (dsk.fused_decode_token_batched, 3)):
        greedy, emit = k.launches, k.emit_launches
        toks = list(model.generate(np.repeat(ids, B, 0), 20,
                                   dtype=torch.bfloat16, temperature=0.8,
                                   top_k=50, top_p=0.9, seed=1))
        assert len(toks) == 16 and all(t.shape == (B, 1) for t in toks)
        assert k.emit_launches - emit == 15 and k.launches == greedy



@pytest.fixture(scope="module")
def gqa():
    """bench.py's GQA_15M on the card: stories15M with 2 KV heads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the decode kernels run only on the "
                    "card")
    from pydynet_tpu_torch.models.llama import Llama
    from chip_smoke import GQA_CFG

    torch.backends.cuda.matmul.allow_tf32 = False
    return Llama(**GQA_CFG, device="cuda",
                 generator=torch.Generator().manual_seed(0)).eval()


@pytest.mark.parametrize("pos", [17, 1030] + STAGE_POSITIONS)
@pytest.mark.parametrize("fmt", ["f32", "bf16", "bf16-int8head", "f32-int8",
                                 "bf16-int8", "bf16-int4"])
def test_narrow_kernel_matches_plain(gqa, fmt, pos):
    """K1 on a grouped-query model: the narrow mode (96-wide caches) with
    float weights and the int8 head, the expanded layout with int8/int4
    layers; tokens, emitted logits and caches as chip_smoke holds them."""
    from chip_smoke import (FORMATS, cache_atol, emit_ok, emit_vs_plain,
                            kernel_vs_plain)

    with torch.no_grad():
        got, want, confident, err = kernel_vs_plain(gqa, fmt, pos)
        eerr, scale, same, cerr = emit_vs_plain(gqa, fmt, pos)
    assert err <= cache_atol(fmt) and cerr <= cache_atol(fmt)
    if FORMATS[fmt][0] == torch.float32 or confident:
        assert got == want
    assert emit_ok(fmt, eerr, scale) and same, (eerr, scale)


@pytest.mark.parametrize("batch", [4, 32, 1, 3, 8, 33, 64, 31])
@pytest.mark.parametrize("fmt", ["f32", "bf16", "bf16-int8head", "bf16-int8",
                                 "bf16-int4", "f32-kv8", "bf16-kv8"])
def test_narrow_batched_kernel_matches_plain(gqa, fmt, batch):
    """K2 on a grouped-query model with per-row starts, every mode (the
    int8 KV cache on the narrow rows), argmax and emit_logits."""
    from chip_smoke import (batched_emit_vs_plain, batched_vs_plain,
                            cache_ok, emit_ok, fmt_of)

    with torch.no_grad():
        got, want, conf, err = batched_vs_plain(gqa, fmt, batch, 255)
        eerr, scale, same, cerr = batched_emit_vs_plain(gqa, fmt, batch,
                                                        1030)
    assert cache_ok(fmt, err) and cache_ok(fmt, cerr), (err, cerr)
    must = torch.ones_like(conf) if fmt_of(fmt)[0] == torch.float32 else conf
    assert torch.equal(got[must], want[must])
    assert emit_ok(fmt, eerr, scale) and same, (eerr, scale)


@pytest.mark.parametrize("batch", [33, 48, 64])
@pytest.mark.parametrize("fmt", ["f32", "bf16", "bf16-int8head", "bf16-int8",
                                 "bf16-int4", "f32-kv8", "bf16-kv8"])
def test_batched_kernel_above_32_rows_matches_plain(model, fmt, batch):
    """K2's row groups in every mode with per-row starts, argmax and
    emit_logits."""
    from chip_smoke import (batched_emit_vs_plain, batched_vs_plain,
                            cache_ok, emit_ok, fmt_of)

    with torch.no_grad():
        got, want, conf, err = batched_vs_plain(model, fmt, batch, 17)
        eerr, scale, same, cerr = batched_emit_vs_plain(model, fmt, batch,
                                                        1030)
    assert cache_ok(fmt, err) and cache_ok(fmt, cerr), (err, cerr)
    must = torch.ones_like(conf) if fmt_of(fmt)[0] == torch.float32 else conf
    assert torch.equal(got[must], want[must])
    assert emit_ok(fmt, eerr, scale) and same, (eerr, scale)


@pytest.mark.parametrize("fmt", ["bf16", "bf16-int8", "bf16-kv8"])
def test_batched_rows_above_32_match_k1(model, gqa, fmt):
    """Each row of a B=64 step (row groups) gives K1's token and cache row
    on that row alone (the int8 KV cache: K2's at B=1), on stories15M and
    on the grouped-query model."""
    from chip_smoke import batched_rows_vs_one, cache_ok

    with torch.no_grad():
        for m in (model, gqa):
            equal, err = batched_rows_vs_one(m, fmt, 64)
            assert equal and cache_ok(fmt, err), err


def test_narrow_launch_counters(gqa):
    """A grouped-query request counts one narrow launch a decode step in
    K1's argmax or emit mode; int8 layers (the expanded layout) none."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    ids = np.array([[1, 243, 532, 991]])
    k1 = dsk.fused_decode_token
    for kw, narrow in (({}, 15), (dict(temperature=0.8, seed=1), 15),
                       (dict(quant="int8"), 0)):
        before = k1.narrow_launches
        assert len(list(gqa.generate(ids, 20, dtype=torch.bfloat16,
                                     **kw))) == 16
        assert k1.narrow_launches - before == narrow


# ------------- the head stage on the tensor cores, and K3 ---------------------
HEAD_TIES = [(10, 20000), (130, 200), (127, 128)]  # across blocks, inside
                                                   # one, across its edge


@pytest.mark.parametrize("batch", [1, 8, 33])
@pytest.mark.parametrize("tie", HEAD_TIES, ids=["blocks", "inside", "edge"])
@pytest.mark.parametrize("qhead", [False, True], ids=["bf16", "int8-head"])
def test_head_ties_go_low(model, qhead, tie, batch):
    """Two vocab rows with the same head row, scale and bias tie for the
    maximum in every row: K2 (any B, every row) and K1 (B=1) pick the lower
    one, in different 128-row head blocks, inside one and across its
    edge."""
    from chip_smoke import batched_args, random_caches, step_args
    from pydynet_tpu_torch.ops import decode_step as dsk

    w = dict(model._fused_weights(torch.bfloat16,
                                  "int8-head" if qhead else None))
    key = "head_wq" if qhead else "head_w"
    head = torch.zeros_like(w[key])
    head[tie[0]] = head[tie[1]] = w[key][5]
    bias = torch.zeros_like(w["head_b"])
    bias[tie[0]] = bias[tie[1]] = 100.0
    w[key], w["head_b"] = head, bias
    if qhead:  # the int8 rows' scales too
        w["head_s"] = w["head_s"].clone()
        w["head_s"][tie[1]] = w["head_s"][tie[0]]
    ck, cv = random_caches(model, torch.bfloat16, 2, batch)
    toks = [(7 + 31 * b) % model.vocab_size for b in range(batch)]
    args, kw = batched_args(model, w, ck, cv, 40, toks)
    assert dsk.fused_decode_token_batched(*args, **kw).tolist() == \
        [tie[0]] * batch
    if batch == 1:
        args, kw = step_args(model, w, ck[:, 0].contiguous(),
                             cv[:, 0].contiguous(), 40, toks[0])
        assert int(dsk.fused_decode_token(*args, **kw)[0]) == tie[0]


def exact_head_weights(model, fmt):
    """``fmt``'s snapshot with every layer matrix zero and the embedding
    rows +-1/4 (seeded signs): the residual reaches the head as the token's
    embedding row, whose RMSNorm is exact in any summation order (every
    square 1/16), so the head's activations are the same bits in the
    kernel and in the plain version."""
    from chip_smoke import fmt_of
    from pydynet_tpu_torch.models.llama.model import FUSED_MATS

    w = dict(model._fused_weights(*fmt_of(fmt)))
    for name in FUSED_MATS:
        for key in (name, name + "_q", name + "_n"):
            if key in w:
                w[key] = torch.zeros_like(w[key])
    g = torch.Generator(device="cuda").manual_seed(9)
    signs = torch.randint(0, 2, w["tok"].shape, generator=g, device="cuda")
    w["tok"] = ((signs * 2 - 1) * 0.25).to(w["tok"].dtype)
    return w


@pytest.mark.parametrize("fmt", ["bf16-int8head", "bf16-int8", "bf16-int4"])
def test_quantized_head_logits_are_the_plain_bits(model, fmt):
    """The int8 and int4 heads on the tensor cores sum exactly in int32 and
    rescale as the plain version does, so on activations that are the same
    bits (exact_head_weights) K2's emitted logits at B = 1, 3, 8, 33 and
    K1's are the plain version's bit for bit."""
    from chip_smoke import batched_args, batched_caches, step_args
    from pydynet_tpu_torch.ops import decode_step as dsk

    w = exact_head_weights(model, fmt)
    with torch.no_grad():
        for batch in (1, 3, 8, 33):
            ck, cv = batched_caches(model, fmt, 3, batch)
            toks = [(11 + 97 * b) % model.vocab_size for b in range(batch)]
            args, kw = batched_args(model, w, ck, cv, 300, toks)
            got = dsk.fused_decode_token_batched(*args, emit_logits=True,
                                                 **kw)
            want = dsk.decode_token_batched_logits_ref(*args, **kw)
            assert torch.equal(got, want), (batch, float(
                (got - want).abs().max()))
        args, kw = step_args(model, w, ck[:, 0].contiguous(),
                             cv[:, 0].contiguous(), 300, toks[0])
        got = dsk.fused_decode_token(*args, emit_logits=True, **kw)
        assert torch.equal(got[0], dsk.decode_token_logits_ref(*args, **kw))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_head_stage_and_flash_forward_are_deterministic(model, gpu, dtype):
    """Two K2 emit calls on the same inputs (B = 40, two row groups) give
    the same logits, and two K3 calls the same o and lse."""
    from chip_smoke import FLASH_DTYPES, batched_args, flash_inputs, \
        random_caches
    from pydynet_tpu_torch.ops import decode_step as dsk
    from pydynet_tpu_torch.ops import flash_attention as fa

    dt = FLASH_DTYPES[dtype]
    w = model._fused_weights(dt, None)
    logits = []
    for _ in range(2):
        ck, cv = random_caches(model, dt, 6, 40)
        args, kw = batched_args(model, w, ck, cv, 700, range(300, 340))
        logits.append(dsk.fused_decode_token_batched(*args, emit_logits=True,
                                                     **kw))
    assert torch.equal(*logits)
    q, k, v, _ = flash_inputs(1, 1000, dt, 5)
    (o1, l1), (o2, l2) = fa.flash_attention_fwd(q, k, v), \
        fa.flash_attention_fwd(q, k, v)
    assert torch.equal(o1, o2) and torch.equal(l1, l2)


# ------------- the layer stages on the tensor cores (K1 and K2) --------------
@pytest.mark.parametrize("fmt", ["f32", "bf16", "bf16-int8", "bf16-int4",
                                 "bf16-kv8"])
def test_layer_stages_are_deterministic(model, fmt):
    """One step twice on the same inputs gives the same bits: K2 at B = 40
    (two row groups, per-row starts) its logits and caches, K1 its logits
    and caches. The warps' sums and the attention merges run in an order
    the code fixes, and the merge counters start at zero every layer."""
    from chip_smoke import (KV8_FORMATS, batched_args, batched_caches,
                            fmt_of, step_args)
    from pydynet_tpu_torch.ops import decode_step as dsk

    w = model._fused_weights(*fmt_of(fmt))
    starts = [(37 * b) % 700 for b in range(40)]
    runs = []
    with torch.no_grad():
        for _ in range(2):
            ck, cv = batched_caches(model, fmt, 6, 40)
            args, kw = batched_args(model, w, ck, cv, 700, range(300, 340),
                                    starts)
            lg = dsk.fused_decode_token_batched(*args, emit_logits=True, **kw)
            runs.append((lg, ck, cv))
        (l1, k1, v1), (l2, k2, v2) = runs
        assert torch.equal(l1, l2)
        for a, b in ((k1, k2), (v1, v2)):
            for x, y in zip(*(t if fmt in KV8_FORMATS else (t,)
                              for t in (a, b))):
                assert torch.equal(x, y)
        if fmt in KV8_FORMATS:
            return
        runs = []
        for _ in range(2):
            ck, cv = batched_caches(model, fmt, 7, 1)
            ck, cv = ck[:, 0].contiguous(), cv[:, 0].contiguous()
            args, kw = step_args(model, w, ck, cv, 700, 321)
            runs.append((dsk.fused_decode_token(*args, emit_logits=True,
                                                **kw), ck, cv))
        (l1, k1, v1), (l2, k2, v2) = runs
        assert torch.equal(l1, l2) and torch.equal(k1, k2) and \
            torch.equal(v1, v2)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_layer_products_are_the_plain_bits(model, quant):
    """The int8 and int4 layer products on the tensor cores sum exactly in
    int32 and rescale as the plain version does, so on the same prepared
    rows they are its bits. Observed where the rows are the same bits in
    both: layer 0's k and v products, which the step writes to the caches
    (float32 weights and caches; embedding rows of +-1/4, whose RMSNorm is
    exact in any summation order; at position 0, whose rotation is the
    identity), at B = 1, 3, 8 and 33 (K2) and through K1."""
    from chip_smoke import batched_args, random_caches, step_args
    from pydynet_tpu_torch.ops import decode_step as dsk

    w = dict(model._fused_weights(torch.float32, quant))
    g = torch.Generator(device="cuda").manual_seed(9)
    signs = torch.randint(0, 2, w["tok"].shape, generator=g, device="cuda")
    w["tok"] = ((signs * 2 - 1) * 0.25).to(w["tok"].dtype)
    with torch.no_grad():
        for batch in (1, 3, 8, 33):
            ck, cv = random_caches(model, torch.float32, 3, batch)
            rck, rcv = ck.clone(), cv.clone()
            toks = [(11 + 97 * b) % model.vocab_size for b in range(batch)]
            args, kw = batched_args(model, w, ck, cv, 0, toks)
            dsk.fused_decode_token_batched(*args, **kw)
            rargs, rkw = batched_args(model, w, rck, rcv, 0, toks)
            dsk.decode_token_batched_logits_ref(*rargs, **rkw)
            assert torch.equal(ck[0, :, 0], rck[0, :, 0]), batch
            assert torch.equal(cv[0, :, 0], rcv[0, :, 0]), batch
        ck, cv = random_caches(model, torch.float32, 4)
        rck, rcv = ck.clone(), cv.clone()
        args, kw = step_args(model, w, ck, cv, 0, toks[0])
        dsk.fused_decode_token(*args, **kw)
        dsk.decode_token_logits_ref(*args[:-2], rck, rcv, **kw)
        assert torch.equal(ck[0, 0], rck[0, 0])
        assert torch.equal(cv[0, 0], rcv[0, 0])
