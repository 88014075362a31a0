"""The port's CUDA decode kernel against its plain PyTorch version, on a GPU.

    python -m pytest -m gpu tests/test_torch_gpu.py -q

Needs a CUDA GPU and nvcc; without a GPU every test here skips. The kernel
has no interpret mode, so it runs only on the card.
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


@pytest.mark.parametrize("pos", [0, 1, 17, 255, 1023, 1030])
@pytest.mark.parametrize("fmt", ["f32", "bf16", "bf16-int8head"])
def test_kernel_matches_plain(model, fmt, pos):
    """Tokens equal (bf16: where the plain top-2 margin is confident) and
    caches within chip_smoke's stated tolerance."""
    from chip_smoke import CACHE_ATOL, FORMATS, kernel_vs_plain

    with torch.no_grad():
        got, want, confident, err = kernel_vs_plain(model, fmt, pos)
    assert err <= CACHE_ATOL[FORMATS[fmt][0]]
    if fmt == "f32" or confident:
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
                max_seq_len=32, n_layers=2).eval()
    before = dsk.fused_decode_token.launches
    assert len(list(cpu.generate(np.array([[1, 5, 9]]), 12))) == 9
    assert dsk.fused_decode_token.launches == before
