"""The PyTorch port's ops against the JAX package's, on the CPU.

Inputs are made with NumPy from a seed and handed to both packages as
float32 (``pydynet_tpu`` enables x64). The JAX fused decode step runs its
Pallas kernel in interpret mode, as the JAX package's own tests do; the
port's wrapper runs its plain version because the tensors are on the CPU.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydynet_tpu as pdn
from pydynet_tpu.models.llama import model as jmodel
from pydynet_tpu.ops import decode_step as jds
from pydynet_tpu.ops import quant as jquant

from pydynet_tpu_torch import device as tdevice
from pydynet_tpu_torch.models.llama import model as tmodel
from pydynet_tpu_torch.nn import RMSNorm, rms_norm
from pydynet_tpu_torch.ops import decode_step as tds
from pydynet_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

REPO = Path(__file__).resolve().parents[1]
N, D, H, S, V, F = 2, 16, 2, 32, 256, 24  # test_ops_kernels.py's tiny size
HD = D // H
VT, SB = 128, 16


def f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_quantize_int8_matches_jax_exactly():
    rng = np.random.default_rng(0)
    w = f32(rng, 40, 24, scale=0.3)
    w[:, 3] = 0.0  # an all-zero channel exercises the 1e-30 floor
    w[5, 7] = 127.5 * np.abs(w[:, 7]).max() / 127.0  # near a half step
    for axis in (0, 1):
        jq, js = jquant.quantize_int8(jnp.asarray(w), axis=axis)
        tq, ts = tquant.quantize_int8(t(w), axis=axis)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            tquant.dequantize_int8(tq, ts).numpy(),
            np.asarray(jquant.dequantize_int8(jq, js)))


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(1)
    x = f32(rng, 3, 5, D)
    w = np.abs(f32(rng, D)) + 0.5
    jnorm = pdn.nn.RMSNorm(D, dtype=np.float32)
    jnorm.weight.data = w
    want = jnorm(pdn.Tensor(x)).numpy()
    mod = RMSNorm(D)
    with torch.no_grad():
        mod.weight.copy_(t(w))
        got = mod(t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(rms_norm(t(x), t(w)).numpy(),
                               np.asarray(jds._rms(jnp.asarray(x),
                                                   jnp.asarray(w))),
                               atol=1e-6)


def test_rope_matches_jax():
    rng = np.random.default_rng(2)
    x = f32(rng, 2, 7, H, HD)
    jcos, jsin = jmodel.compute_cos_sin_cache(HD, S, dtype=np.float32)
    tcos, tsin = tmodel.compute_cos_sin_cache(HD, S)
    np.testing.assert_array_equal(tcos.numpy(), jcos.numpy())
    np.testing.assert_array_equal(tsin.numpy(), jsin.numpy())
    c, s = tcos[3:10], tsin[3:10]
    want = np.asarray(jmodel._rope_pure(jnp.asarray(x), jnp.asarray(c),
                                        jnp.asarray(s)))
    np.testing.assert_allclose(tmodel._rope_pure(t(x), c, s).numpy(), want,
                               atol=1e-6)
    # the fused step's per-feature tables rotate the same pairs
    cd = c.repeat_interleave(2, -1).repeat(1, H)
    sd = s.repeat_interleave(2, -1).repeat(1, H)
    flat = torch.stack([tds._rope_pairs(t(x[0, i].reshape(D)), cd[i], sd[i])
                        for i in range(7)])
    np.testing.assert_allclose(flat.numpy(), want[0].reshape(7, D),
                               atol=1e-6)


def _tiny_step_inputs(seed, qhead=False):
    """The tiny fused-step inputs in both packages' layouts."""
    rng = np.random.default_rng(seed)
    w = {k: f32(rng, N, D, D, scale=0.2) for k in ("wq", "wk", "wv", "wo")}
    w["gate"] = f32(rng, N, D, F, scale=0.2)
    w["up"] = f32(rng, N, D, F, scale=0.2)
    w["down"] = f32(rng, N, F, D, scale=0.2)
    in_norm = np.abs(f32(rng, N, D)) + 0.5
    post_norm = np.abs(f32(rng, N, D)) + 0.5
    final_norm = np.abs(f32(rng, D)) + 0.5
    emb = f32(rng, V, D)
    head_w = f32(rng, D, V, scale=0.3)
    head_b = f32(rng, V, scale=0.1)
    inv = 1.0 / (10000 ** (np.arange(0, HD, 2) / HD))
    ang = np.arange(S)[:, None] * inv
    cosr = np.tile(np.repeat(np.cos(ang), 2, -1), (1, H)).astype(np.float32)
    sinr = np.tile(np.repeat(np.sin(ang), 2, -1), (1, H)).astype(np.float32)
    ck = f32(rng, N, S, D, scale=0.3)
    cv = f32(rng, N, S, D, scale=0.3)
    jhead, jhead_s = jnp.asarray(head_w), None
    thead, thead_s = t(head_w.T), None
    if qhead:
        jhead, jhead_s = jquant.quantize_int8(jnp.asarray(head_w), axis=0)
        thead = t(np.asarray(jhead).T)
        thead_s = t(np.asarray(jhead_s).reshape(V))
    Dp = jds.lane_pad_dim(D)
    pad = ((0, 0), (0, 0), (0, Dp - D))
    jax_args = dict(
        consts=(jnp.asarray(emb), jnp.asarray(cosr), jnp.asarray(sinr),
                jds.rope_pair_swap_matrix(D),
                jnp.pad(jds.head_mask_matrix(D, H), ((0, Dp - D), (0, 0))),
                jnp.asarray(final_norm[None]),
                *(jnp.asarray(w[k]) for k in ("wq", "wk", "wv", "wo", "gate",
                                              "up", "down")),
                jnp.asarray(in_norm[:, None]), jnp.asarray(post_norm[:, None]),
                jhead, jnp.asarray(head_b[None])),
        ck=jnp.asarray(np.pad(ck, pad)), cv=jnp.asarray(np.pad(cv, pad)),
        head_s=jhead_s)
    tw = {k: t(v.transpose(0, 2, 1)) for k, v in w.items()}
    torch_args = dict(
        consts=(t(emb), t(cosr), t(sinr), t(final_norm), tw["wq"], tw["wk"],
                tw["wv"], tw["wo"], tw["gate"], tw["up"], tw["down"],
                t(in_norm), t(post_norm), thead, t(head_b)),
        ck=t(ck), cv=t(cv), head_s=thead_s)
    return jax_args, torch_args


def _i32(x):
    return torch.tensor([x], dtype=torch.int32)


@pytest.mark.parametrize("qhead", [False, True], ids=["f32", "int8-head"])
def test_fused_decode_token_ref_matches_jax_kernel(qhead):
    """Five consecutive decode steps from pos 3 over random cache rows:
    equal tokens, and caches equal to 1e-5 (only summation order differs)."""
    ja, ta = _tiny_step_inputs(3, qhead)
    jck, jcv, tck, tcv = ja["ck"], ja["cv"], ta["ck"], ta["cv"]
    tok = 7
    for pos in range(3, 8):
        jn, jck, jcv = jds.fused_decode_token(
            pos, jnp.asarray([tok], jnp.int32), *ja["consts"], jck, jcv,
            vt=VT, sb=SB, interpret=True, head_s=ja["head_s"])
        tn = tds.fused_decode_token(_i32(pos), _i32(tok), *ta["consts"], tck,
                                    tcv, n_heads=H, head_s=ta["head_s"])
        assert tn.dtype == torch.int32 and tn.shape == (1,)
        assert int(tn[0]) == int(jn[0]), (pos, int(tn[0]), int(jn[0]))
        np.testing.assert_allclose(tck.numpy(), np.asarray(jck)[..., :D],
                                   atol=1e-5)
        np.testing.assert_allclose(tcv.numpy(), np.asarray(jcv)[..., :D],
                                   atol=1e-5)
        tok = int(tn[0])


@pytest.mark.parametrize("past", [0, 5])
def test_fused_decode_token_clamps_pos_at_cache_end(past):
    """pos S + past acts as S - 1: same token, same caches."""
    _, ta = _tiny_step_inputs(4)
    ref_ck, ref_cv = ta["ck"].clone(), ta["cv"].clone()
    n1 = tds.fused_decode_token(_i32(S - 1), _i32(9), *ta["consts"], ref_ck,
                                ref_cv, n_heads=H)
    ck, cv = ta["ck"].clone(), ta["cv"].clone()
    n2 = tds.fused_decode_token(_i32(S + past), _i32(9), *ta["consts"], ck,
                                cv, n_heads=H)
    assert int(n2[0]) == int(n1[0])
    assert torch.equal(ck, ref_ck) and torch.equal(cv, ref_cv)


@pytest.mark.parametrize("qhead", [False, True], ids=["f32", "int8-head"])
def test_fused_decode_token_cross_tile_tie_goes_low(qhead):
    """Two vocab rows in different 128-row tiles with identical weights and
    bias tie for the maximum: both packages pick the lower index."""
    ja, ta = _tiny_step_inputs(5)
    rng = np.random.default_rng(6)
    head_w = np.zeros((D, V), np.float32)
    head_w[:, 10] = head_w[:, 200] = f32(rng, D)
    head_b = np.zeros(V, np.float32)
    head_b[10] = head_b[200] = 100.0
    jhead, jhead_s = jnp.asarray(head_w), None
    thead, thead_s = t(head_w.T), None
    if qhead:
        jhead, jhead_s = jquant.quantize_int8(jhead, axis=0)
        thead = t(np.asarray(jhead).T)
        thead_s = t(np.asarray(jhead_s).reshape(V))
    jc = ja["consts"][:-2] + (jhead, jnp.asarray(head_b[None]))
    tc = ta["consts"][:-2] + (thead, t(head_b))
    jn, _, _ = jds.fused_decode_token(
        4, jnp.asarray([3], jnp.int32), *jc, ja["ck"], ja["cv"], vt=VT,
        sb=SB, interpret=True, head_s=jhead_s)
    tn = tds.fused_decode_token(_i32(4), _i32(3), *tc, ta["ck"], ta["cv"],
                                n_heads=H, head_s=thead_s)
    assert int(jn[0]) == 10
    assert int(tn[0]) == 10


def test_fused_decode_token_rejects_bad_arguments():
    _, ta = _tiny_step_inputs(7)
    c = ta["consts"]
    with pytest.raises(ValueError, match="wq"):
        tds.fused_decode_token(_i32(0), _i32(1), *c[:4], c[4][:, :, :-1],
                               *c[5:], ta["ck"], ta["cv"], n_heads=H)
    with pytest.raises(ValueError, match="head_w"):  # int8 head needs scales
        tds.fused_decode_token(_i32(0), _i32(1), *c[:-2],
                               c[-2].to(torch.int8), c[-1], ta["ck"],
                               ta["cv"], n_heads=H)
    with pytest.raises(ValueError, match="pos"):
        tds.fused_decode_token(torch.tensor([0]), _i32(1), *c, ta["ck"],
                               ta["cv"], n_heads=H)
    with pytest.raises(ValueError, match="contiguous"):
        tds.fused_decode_token(_i32(0), _i32(1), *c,
                               ta["ck"].transpose(1, 2).contiguous()
                               .transpose(1, 2), ta["cv"], n_heads=H)


def _batched_inputs(seed, B, qhead=False):
    """The tiny step inputs with (N, B, S, D) caches: JAX's lane-padded,
    the port's plain."""
    ja, ta = _tiny_step_inputs(seed, qhead)
    rng = np.random.default_rng(seed + 100)
    ck, cv = f32(rng, N, B, S, D, scale=0.3), f32(rng, N, B, S, D, scale=0.3)
    pad = ((0, 0),) * 3 + ((0, jds.lane_pad_dim(D) - D),)
    ja = dict(ja, ck=jnp.asarray(np.pad(ck, pad)),
              cv=jnp.asarray(np.pad(cv, pad)))
    return ja, dict(ta, ck=t(ck), cv=t(cv))


def _jax_batched(ja, pos, toks, starts=None, consts=None, head_s="same"):
    """JAX's batched kernel in interpret mode on the tiny inputs; the
    embedding gather happens outside it, as in the JAX package."""
    consts = ja["consts"] if consts is None else consts
    h0 = jnp.asarray(np.asarray(consts[0])[np.asarray(toks)])
    return jds.fused_decode_token_batched(
        pos, h0, *consts[1:], ja["ck"], ja["cv"], vt=VT, sb=SB,
        interpret=True, head_s=ja["head_s"] if head_s == "same" else head_s,
        starts=None if starts is None else jnp.asarray(starts, jnp.int32))


def _batched(ta, pos, toks, starts=None, consts=None, head_s="same",
             ck=None, cv=None):
    return tds.fused_decode_token_batched(
        _i32(pos), torch.tensor(toks, dtype=torch.int32),
        *(ta["consts"] if consts is None else consts),
        ta["ck"] if ck is None else ck, ta["cv"] if cv is None else cv,
        n_heads=H, head_s=ta["head_s"] if head_s == "same" else head_s,
        starts=None if starts is None else torch.tensor(starts,
                                                        dtype=torch.int32))


@pytest.mark.parametrize("past", [0, 5])
def test_fused_decode_token_batched_clamps_pos_at_cache_end(past):
    """pos S + past acts as S - 1 in both packages: same tokens, same
    caches."""
    ja, ta = _batched_inputs(8, 3)
    toks, starts = [9, 40, 77], [0, 20, S - 1]
    ref_ck, ref_cv = ta["ck"].clone(), ta["cv"].clone()
    n1 = _batched(ta, S - 1, toks, starts, ck=ref_ck, cv=ref_cv)
    ck, cv = ta["ck"].clone(), ta["cv"].clone()
    n2 = _batched(ta, S + past, toks, starts, ck=ck, cv=cv)
    assert torch.equal(n2, n1)
    assert torch.equal(ck, ref_ck) and torch.equal(cv, ref_cv)
    jn, jck, _ = _jax_batched(ja, S + past, toks, starts)
    np.testing.assert_array_equal(n2.numpy(), np.asarray(jn))
    np.testing.assert_allclose(ck.numpy(), np.asarray(jck)[..., :D],
                               atol=1e-5)


@pytest.mark.parametrize("qhead", [False, True], ids=["f32", "int8-head"])
def test_fused_decode_token_batched_cross_tile_tie_goes_low(qhead):
    """Vocab rows 10 and 200 (different 128-row tiles) tie for every row's
    maximum: both packages pick 10 in every row."""
    ja, ta = _batched_inputs(5, 3)
    rng = np.random.default_rng(6)
    head_w = np.zeros((D, V), np.float32)
    head_w[:, 10] = head_w[:, 200] = f32(rng, D)
    head_b = np.zeros(V, np.float32)
    head_b[10] = head_b[200] = 100.0
    jhead, jhead_s = jnp.asarray(head_w), None
    thead, thead_s = t(head_w.T), None
    if qhead:
        jhead, jhead_s = jquant.quantize_int8(jhead, axis=0)
        thead = t(np.asarray(jhead).T)
        thead_s = t(np.asarray(jhead_s).reshape(V))
    jc = ja["consts"][:-2] + (jhead, jnp.asarray(head_b[None]))
    tc = ta["consts"][:-2] + (thead, t(head_b))
    jn, _, _ = _jax_batched(ja, 4, [3, 50, 7], [0, 2, 4], jc, jhead_s)
    tn = _batched(ta, 4, [3, 50, 7], [0, 2, 4], tc, thead_s)
    assert np.asarray(jn).tolist() == [10, 10, 10]
    assert tn.tolist() == [10, 10, 10]


def test_fused_decode_token_batched_starts_hide_stale_rows():
    """Rows below a row's start may hold anything (a recycled slot's old
    request): huge values there change nothing, in either package."""
    ja, ta = _batched_inputs(9, 3, qhead=True)
    toks, starts = [5, 6, 7], [0, 6, 11]
    clean = _batched(ta, 12, toks, starts, ck=ta["ck"].clone(),
                     cv=ta["cv"].clone())
    ck, cv = ta["ck"].clone(), ta["cv"].clone()
    for b, lo in enumerate(starts):
        ck[:, b, :lo] = 1e4
        cv[:, b, :lo] = -1e4
    assert torch.equal(_batched(ta, 12, toks, starts, ck=ck, cv=cv), clean)
    jck, jcv = np.asarray(ja["ck"]).copy(), np.asarray(ja["cv"]).copy()
    for b, lo in enumerate(starts):
        jck[:, b, :lo] = 1e4
        jcv[:, b, :lo] = -1e4
    jn, _, _ = _jax_batched(dict(ja, ck=jnp.asarray(jck),
                                 cv=jnp.asarray(jcv)), 12, toks, starts)
    np.testing.assert_array_equal(np.asarray(jn), clean.numpy())


def test_fused_decode_token_batched_rows_match_b1_step():
    """Row b of the batched step, starting at 0, gives the token and cache
    row the B=1 step gives on that row alone."""
    _, ta = _batched_inputs(10, 4)
    toks = [3, 99, 180, 255]
    ck, cv = ta["ck"].clone(), ta["cv"].clone()
    got = _batched(ta, 9, toks, ck=ck, cv=cv)
    for b in range(4):
        rck, rcv = ta["ck"][:, b].clone(), ta["cv"][:, b].clone()
        one = tds.fused_decode_token(_i32(9), _i32(toks[b]), *ta["consts"],
                                     rck, rcv, n_heads=H)
        assert int(one[0]) == int(got[b])
        assert torch.equal(rck, ck[:, b]) and torch.equal(rcv, cv[:, b])


def test_fused_decode_token_batched_rejects_bad_arguments():
    _, ta = _batched_inputs(11, 2)
    c = ta["consts"]
    with pytest.raises(ValueError, match="tok"):
        _batched(ta, 0, [1, 2, 3])
    with pytest.raises(ValueError, match="starts"):
        tds.fused_decode_token_batched(
            _i32(0), torch.tensor([1, 2], dtype=torch.int32), *c, ta["ck"],
            ta["cv"], n_heads=H, starts=torch.tensor([0, 1]))
    with pytest.raises(ValueError, match="ck"):
        tds.fused_decode_token_batched(
            _i32(0), torch.tensor([1, 2], dtype=torch.int32), *c,
            ta["ck"][:, 0], ta["cv"][:, 0], n_heads=H)
    with pytest.raises(ValueError, match="out"):
        tds.fused_decode_token_batched(
            _i32(0), torch.tensor([1, 2], dtype=torch.int32), *c, ta["ck"],
            ta["cv"], n_heads=H, out=torch.empty(1, dtype=torch.int32))
    # the batched kernel's limits: a group of 32 rows' activations in
    # shared memory, any number of groups up to the attention grid's z
    assert tds.batched_kernel_takes(288, 6, 768, 32)
    assert tds.batched_kernel_takes(288, 6, 768, 33)
    assert not tds.batched_kernel_takes(288, 6, 768, 65536)
    assert not tds.batched_kernel_takes(288, 6, 768, 0)
    assert not tds.batched_kernel_takes(4096, 32, 11008, 8)


def test_cuda_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the CPU-only case")
    assert not tdevice.is_available()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tdevice.resolve("cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tmodel.Llama(V, D, H, F, S, n_layers=1, device="cuda")
    assert tdevice.resolve("cpu") == torch.device("cpu")
    assert tmodel.Llama(V, D, H, F, S, n_layers=1,
                        device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError):
        tdevice.resolve("tpu")


def test_no_device_means_the_card():
    """``Llama(...)`` and ``resolve()`` without a device mean the GPU: on a
    machine without one they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tdevice.resolve()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tmodel.Llama(V, D, H, F, S, n_layers=1)


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import pydynet_tpu_torch\n"
            "import pydynet_tpu_torch.models.llama.infer\n"
            "import pydynet_tpu_torch.models.llama.serve_cli\n"
            "import pydynet_tpu_torch.models.llama.finetune\n"
            "import pydynet_tpu_torch.nn.functional\n"
            "import pydynet_tpu_torch.nn.utils\n"
            "import pydynet_tpu_torch.optim\n"
            "import pydynet_tpu_torch.ops.flash_attention\n"
            "import pydynet_tpu_torch.ops.gemv_quant\n"
            "import pydynet_tpu_torch.utils.fidelity\n"
            "import pydynet_tpu_torch.ops._build\n"
            "import pydynet_tpu_torch.core\n"
            "import pydynet_tpu_torch.autograd\n"
            "import pydynet_tpu_torch.special\n"
            "import pydynet_tpu_torch.cuda\n"
            "import pydynet_tpu_torch.nn.parameter\n"
            "import pydynet_tpu_torch.nn.modules.module\n"
            "import pydynet_tpu_torch.native\n"
            "import pydynet_tpu_torch.models.llama.cpu_decode\n"
            "import pydynet_tpu_torch.examples.autograd1d\n"
            "import pydynet_tpu_torch.examples.autograd2d\n"
            "import pydynet_tpu_torch.parallel\n"
            "import pydynet_tpu_torch.parallel._cases\n"
            "import pydynet_tpu_torch.parallel._dryrun\n"
            "import pydynet_tpu_torch.utils.debug\n"
            "import pydynet_tpu_torch.utils.profiler\n"
            "import pydynet_tpu_torch.utils.sharded_checkpoint\n"
            "from pydynet_tpu_torch.models.llama.tokenizer import "
            "Tokenizer\n"
            "Tokenizer(None).encode('abc')\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'pydynet_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120, env=dict(os.environ, OMP_NUM_THREADS="1"))


def test_build_paths_are_keyed_by_sources(monkeypatch, tmp_path):
    """The library name follows the sources and flags; without nvcc the
    build raises instead of falling back."""
    from pydynet_tpu_torch.ops import _build

    srcs = _build.sources()
    assert [p.name for p in srcs] == ["batchnorm.cu", "decode_step.cu",
                                      "decode_step_f16.cu",
                                      "decode_token.cu",
                                      "decode_token_batched.cu",
                                      "decode_token_batched_bf16.cu",
                                      "decode_token_batched_f16.cu",
                                      "flash_attention.cu",
                                      "flash_attention_f16.cu",
                                      "gemv_quant.cu", "gemv_quant_f16.cu"]
    path = _build.library_path()
    assert path == _build.library_path()
    assert path.parent == REPO / "build" / "pydynet_tpu_torch"
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-g"])
    assert _build.library_path() != path
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if not Path("/usr/local/cuda/bin/nvcc").is_file():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.nvcc_path()
