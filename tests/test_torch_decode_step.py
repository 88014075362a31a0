"""The port's greedy head (K9, ``lm_head_argmax``) and layers-only decode
step (K10, ``fused_decode_step``) against the JAX package's Pallas kernels
in interpret mode, on the CPU.

Inputs are made with NumPy from a seed and handed to both packages; the
port's wrappers run their plain versions because the tensors are on the
CPU. The port keeps torch's (out, in) weight layout and (N, D) norms, so
its matrices are the JAX ones transposed.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from pydynet_tpu.ops import decode_step as jds

from pydynet_tpu_torch.ops import decode_step as tds

# test_ops_kernels.py's tiny decode-step size
N, H, D, S, F = 2, 2, 16, 32, 24
HD = D // H


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _head_case(seed=0, D=32, V=256):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((1, D)).astype(np.float32)
    w = rng.standard_normal((D, V)).astype(np.float32)   # JAX's (D, V)
    b = rng.standard_normal((1, V)).astype(np.float32)
    return h, w, b


def _jax_head(h, w, b, vt=128):
    return int(jds.lm_head_argmax(jnp.asarray(h), jnp.asarray(w),
                                  jnp.asarray(b), vt=vt,
                                  interpret=True)[0, 0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lm_head_argmax_matches_jax(seed):
    """test_ops_kernels.py:269's case (D 32, V 256, two 128-wide tiles):
    the same index, int32 (1, 1)."""
    h, w, b = _head_case(seed)
    got = tds.lm_head_argmax(t(h), t(w.T), t(b[0]))
    assert got.dtype == torch.int32 and got.shape == (1, 1)
    assert int(got[0, 0]) == _jax_head(h, w, b)
    assert int(got[0, 0]) == int(np.argmax(h @ w + b))


def test_lm_head_argmax_tie_across_tiles_goes_low():
    """Rows 10 and 200 (different 128-row tiles), and rows 127 and 128 (the
    last of one 128-row block of the CUDA head stage and the first of the
    next), tie for the maximum: both packages return the lower, exactly."""
    for lo, hi in ((10, 200), (127, 128)):
        h, w, b = _head_case(3)
        w[:, lo] = w[:, hi] = np.sign(h[0]) * 2.0
        b[0, lo] = b[0, hi] = 1.0
        assert _jax_head(h, w, b) == lo
        assert int(tds.lm_head_argmax(t(h), t(w.T), t(b[0]))[0, 0]) == lo


def test_lm_head_argmax_f32_h_is_not_rounded_to_bf16_weights():
    """jnp.dot promotes an f32 h against bf16 weights to f32: rounding h to
    bf16 would tie rows 0 and 1 (both 1.0) and pick 0; unrounded, row 1's
    1 + 2**-8 beats row 0's 1 + 2**-9."""
    D, V = 2, 128
    h = np.array([[1 + 2**-9, 1 + 2**-8]], np.float32)
    w = np.zeros((D, V), np.float32)
    w[0, 0] = w[1, 1] = 1.0
    b = np.zeros((1, V), np.float32)
    wb = w.astype(ml_dtypes.bfloat16)
    want = int(jds.lm_head_argmax(jnp.asarray(h), jnp.asarray(wb),
                                  jnp.asarray(b.astype(ml_dtypes.bfloat16)),
                                  vt=128, interpret=True)[0, 0])
    tw = t(w.T).to(torch.bfloat16)
    tb = t(b[0]).to(torch.bfloat16)
    assert want == 1
    assert int(tds.lm_head_argmax(t(h), tw, tb)[0, 0]) == 1
    rounded = t(h).to(torch.bfloat16)
    assert int(tds.lm_head_argmax(rounded, tw, tb)[0, 0]) == 0


def _split3(x):
    """K9's float32 h as three bfloat16 pieces (``load_split_rows`` in
    ``csrc/head.cuh``): hi = bf16(x), mid = bf16(x - hi),
    lo = bf16(x - hi - mid), each rounded to nearest even."""
    hi = x.to(torch.bfloat16)
    rest = x - hi.float()
    mid = rest.to(torch.bfloat16)
    return hi, mid, (rest - mid.float()).to(torch.bfloat16)


def _split3_head(h, w, b):
    """K9's logits for a float32 h against bfloat16 weights, emulated: each
    piece's products with the weights exact in float32 and summed in
    float32, the three sums added as (lo + mid) + hi, then the bias."""
    hi, mid, lo = (torch.mv(w.float(), p.reshape(-1).float())
                   for p in _split3(h))
    return ((lo + mid) + hi) + b.float()


# half a step of bfloat16's subnormals: what the smallest piece may lose
BF16_SUBNORMAL_HALF_STEP = 2.0**-134


@pytest.mark.parametrize("scale", [1.0, 1e30, 1e-30])
def test_three_piece_split_carries_every_bit(scale):
    """hi + mid + lo == h exactly for seeded floats at scales 1 and 1e30. At
    1e-30 the smallest piece of some values falls among bfloat16's
    subnormals and is rounded there: each sum stays within half a subnormal
    step (2**-134) of h, which is within 1e-5 of h wherever |h| is at least
    1e5 such steps (all but the values nearest 0)."""
    rng = np.random.default_rng(16)
    x = t((rng.standard_normal(100_000) * scale).astype(np.float32))
    hi, mid, lo = _split3(x)
    back = (lo.float() + mid.float()) + hi.float()
    if scale >= 1.0:
        assert torch.equal(back, x)
        return
    err = (back.double() - x.double()).abs()
    assert not torch.equal(back, x)
    assert float(err.max()) <= BF16_SUBNORMAL_HALF_STEP
    away = x.abs() >= 1e5 * BF16_SUBNORMAL_HALF_STEP
    assert int(away.sum()) >= 99_990
    assert float((err / x.abs().double())[away].max()) <= 1e-5


def test_three_piece_head_keeps_h_unrounded():
    """The split's three column sums in the kernel's order give the JAX
    package's argmax on the not-rounded case's inputs, and the float32
    argmax on a seeded stories15M-width head."""
    D, V = 2, 128
    h = np.array([[1 + 2**-9, 1 + 2**-8]], np.float32)
    w = np.zeros((D, V), np.float32)
    w[0, 0] = w[1, 1] = 1.0
    b = np.zeros((1, V), np.float32)
    wb = w.astype(ml_dtypes.bfloat16)
    want = int(jds.lm_head_argmax(jnp.asarray(h), jnp.asarray(wb),
                                  jnp.asarray(b.astype(ml_dtypes.bfloat16)),
                                  vt=128, interpret=True)[0, 0])
    tw, tb = t(w.T).to(torch.bfloat16), t(b[0]).to(torch.bfloat16)
    got = _split3_head(t(h), tw, tb)
    assert want == 1 and int(torch.argmax(got)) == want
    assert int(torch.argmax(torch.mv(tw.float(),
                                      t(h)[0].to(torch.bfloat16).float())
                            + tb.float())) == 0
    rng = np.random.default_rng(17)
    h = t(rng.standard_normal((1, 288)).astype(np.float32))
    wb = t(rng.standard_normal((32000, 288)).astype(np.float32)
           * 0.06).to(torch.bfloat16)
    bb = t(rng.standard_normal(32000).astype(np.float32)
           * 0.1).to(torch.bfloat16)
    exact = torch.mv(wb.double(), h[0].double()) + bb.double()
    got = _split3_head(h, wb, bb)
    assert float((got.double() - exact).abs().max()) <= \
        1e-5 * float(exact.abs().max())
    assert int(torch.argmax(got)) == int(torch.argmax(exact)) == \
        int(tds.lm_head_argmax(h, wb, bb)[0, 0])


def test_lm_head_argmax_takes_any_vocab_and_rejects_bad_arguments():
    """The TPU kernel's vt tiling is its own: V = 7 works; mismatched
    shapes and types raise."""
    h, w, b = _head_case(4, D=8, V=7)
    assert int(tds.lm_head_argmax(t(h), t(w.T), t(b[0]))[0, 0]) == \
        int(np.argmax(h @ w + b))
    with pytest.raises(ValueError, match="h"):
        tds.lm_head_argmax(t(h[:, :7]), t(w.T), t(b[0]))
    with pytest.raises(ValueError, match="b"):
        tds.lm_head_argmax(t(h), t(w.T), t(b[0, :6]))
    with pytest.raises(ValueError, match="b"):
        tds.lm_head_argmax(t(h), t(w.T), t(b[0]).double())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tds.lm_head_argmax(t(h), t(w.T).half(), t(b[0]).half())


def test_rope_and_head_mask_matrices_equal_jax():
    for dim, heads in ((16, 2), (288, 6), (10, 5)):
        np.testing.assert_array_equal(tds.rope_pair_swap_matrix(dim).numpy(),
                                      np.asarray(jds.rope_pair_swap_matrix(
                                          dim)))
        np.testing.assert_array_equal(
            tds.head_mask_matrix(dim, heads).numpy(),
            np.asarray(jds.head_mask_matrix(dim, heads)))


def _step_case(seed=0, structured=True, seq=S):
    """test_ops_kernels.py:75's inputs at pos 5 (its tiny fixture's
    weights, seed 0, its h0 and caches, seed 1, ``seq`` cache rows), and
    optionally a random rot and hmask in place of the pair swap and the
    head mask."""
    rng = np.random.default_rng(seed)
    p = {
        "wq": rng.standard_normal((N, D, D)) * 0.2,
        "wk": rng.standard_normal((N, D, D)) * 0.2,
        "wv": rng.standard_normal((N, D, D)) * 0.2,
        "wo": rng.standard_normal((N, D, D)) * 0.2,
        "gate": rng.standard_normal((N, D, F)) * 0.2,
        "up": rng.standard_normal((N, D, F)) * 0.2,
        "down": rng.standard_normal((N, F, D)) * 0.2,
        "in_norm": np.abs(rng.standard_normal((N, 1, D))) + 0.5,
        "post_norm": np.abs(rng.standard_normal((N, 1, D))) + 0.5,
        "final_norm": np.abs(rng.standard_normal((1, D))) + 0.5,
    }
    p = {k: v.astype(np.float32) for k, v in p.items()}
    rng = np.random.default_rng(seed + 1)
    pos = 5
    h0 = (rng.standard_normal((1, D)) * 0.5).astype(np.float32)
    ck = (rng.standard_normal((N, seq, D)) * 0.3).astype(np.float32)
    cv = (rng.standard_normal((N, seq, D)) * 0.3).astype(np.float32)
    inv = 1.0 / (10000 ** (np.arange(0, HD, 2) / HD))
    cosd = np.tile(np.repeat(np.cos(pos * inv), 2), H)[None].astype(
        np.float32)
    sind = np.tile(np.repeat(np.sin(pos * inv), 2), H)[None].astype(
        np.float32)
    if structured:
        rot = np.asarray(jds.rope_pair_swap_matrix(D))
        hmask = np.asarray(jds.head_mask_matrix(D, H))
    else:
        rot = (rng.standard_normal((D, D)) * 0.3).astype(np.float32)
        hmask = rng.uniform(0, 1, (D, H)).astype(np.float32)
    return pos, h0, cosd, sind, rot, hmask, p, ck, cv


def _run_both(case, dtype=np.float32, pos=None):
    """Both packages' step on ``case`` with weights, norms and caches in
    ``dtype`` (h0, cos, sin, rot and hmask float32), caches not aliased.
    Returns ((h, ck, cv) of JAX, of the port) as float32 numpy arrays."""
    p0, h0, cosd, sind, rot, hmask, p, ck, cv = case
    pos = p0 if pos is None else pos
    names = ("wq", "wk", "wv", "wo", "gate", "up", "down")

    def cast(a):
        return a.astype(dtype)

    jw = [jnp.asarray(cast(p[k])) for k in names]
    jout = jds.fused_decode_step(
        pos, jnp.asarray(h0), jnp.asarray(cosd), jnp.asarray(sind),
        jnp.asarray(rot), jnp.asarray(hmask), jnp.asarray(cast(p["final_norm"])),
        *jw, jnp.asarray(cast(p["in_norm"])), jnp.asarray(cast(p["post_norm"])),
        jnp.asarray(cast(ck)), jnp.asarray(cast(cv)), interpret=True,
        alias=False)
    tdt = torch.bfloat16 if dtype != np.float32 else torch.float32

    def tt(a):
        return t(a.astype(np.float32)).to(tdt)

    tw = [tt(p[k].transpose(0, 2, 1)) for k in names]
    tck, tcv = tt(ck), tt(cv)
    tout = tds.fused_decode_step(
        torch.tensor([pos], dtype=torch.int32), t(h0), t(cosd), t(sind),
        t(rot), t(hmask), tt(p["final_norm"][0]), *tw, tt(p["in_norm"][:, 0]),
        tt(p["post_norm"][:, 0]), tck, tcv, alias=False)
    # alias=False leaves the inputs as they were
    assert torch.equal(tck, tt(ck)) and torch.equal(tcv, tt(cv))
    return ([np.asarray(a, np.float32) for a in jout],
            [a.float().numpy() for a in tout])


def _untouched(new, old, pos):
    keep = np.ones(new.shape[1], bool)
    keep[pos] = False
    np.testing.assert_array_equal(new[:, keep], old[:, keep])


def test_fused_decode_step_matches_jax_f32():
    """h_out to 1e-4 (test_ops_kernels.py:107's tolerance against its
    reference; both are float32 and differ in summation order only), the
    new cache row to 1e-5, every other row bit-equal."""
    case = _step_case()
    (jh, jck, jcv), (th, tck, tcv) = _run_both(case)
    assert th.shape == (1, D)
    np.testing.assert_allclose(th, jh, atol=1e-4)
    np.testing.assert_allclose(tck, jck, atol=1e-5)
    np.testing.assert_allclose(tcv, jcv, atol=1e-5)
    _untouched(tck, case[7], 5)
    _untouched(tcv, case[8], 5)
    assert not np.allclose(tck[:, 5], case[7][:, 5])


def test_fused_decode_step_matches_jax_bf16():
    """bf16 weights and caches: both round hn, zn, ff, att, qM and the
    probabilities to bf16 at the same points, so they differ only where a
    float32 summation-order difference moves a rounded value to the
    neighbouring bf16 value (2**-8 relative): h_out within 2**-5, the new
    cache row within one bf16 ulp at |x| < 4 (2**-6), the rest bit-equal."""
    case = _step_case()
    (jh, jck, jcv), (th, tck, tcv) = _run_both(case, ml_dtypes.bfloat16)
    np.testing.assert_allclose(th, jh, atol=2.0**-5)
    np.testing.assert_allclose(tck, jck, atol=2.0**-6)
    np.testing.assert_allclose(tcv, jcv, atol=2.0**-6)
    bf = case[7].astype(ml_dtypes.bfloat16).astype(np.float32)
    _untouched(tck, bf, 5)


def test_fused_decode_step_takes_any_rot_and_hmask():
    """A random rot and a random non-binary hmask, applied as given by both
    packages: float32, the same tolerances as the structured case."""
    case = _step_case(structured=False)
    (jh, jck, jcv), (th, tck, tcv) = _run_both(case)
    np.testing.assert_allclose(th, jh, atol=1e-4)
    np.testing.assert_allclose(tck, jck, atol=1e-5)
    np.testing.assert_allclose(tcv, jcv, atol=1e-5)
    _untouched(tcv, case[8], 5)


@pytest.mark.parametrize("pos", [0, S - 1, S + 3])
def test_fused_decode_step_positions_and_clamp_match_jax(pos):
    """pos 0 (one row), the last row, and pos >= S acting as S - 1."""
    case = _step_case(2)
    (jh, jck, _), (th, tck, _) = _run_both(case, pos=pos)
    np.testing.assert_allclose(th, jh, atol=1e-4)
    np.testing.assert_allclose(tck, jck, atol=1e-5)
    _untouched(tck, case[7], min(pos, S - 1))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pos", [63, 64, 65])
def test_fused_decode_step_across_row_tiles_matches_jax(pos, dtype):
    """A 128-row cache at positions either side of the kernel's row tiles
    (16 rows; 64 a block at stories15M's 1024 rows): float32 and bf16 at
    the tolerances of the tests above, the other rows untouched."""
    case = _step_case(5, seq=128)
    jdt = np.float32 if dtype == "f32" else ml_dtypes.bfloat16
    (jh, jck, jcv), (th, tck, tcv) = _run_both(case, jdt, pos=pos)
    h_tol, c_tol = (1e-4, 1e-5) if dtype == "f32" else (2.0**-5, 2.0**-6)
    np.testing.assert_allclose(th, jh, atol=h_tol)
    np.testing.assert_allclose(tck, jck, atol=c_tol)
    np.testing.assert_allclose(tcv, jcv, atol=c_tol)
    _untouched(tck, case[7].astype(jdt).astype(np.float32), pos)


@pytest.mark.parametrize("args,want", [
    # stories15M: h, q and k, att (4 x 288), ff 768, 1024 rows x 8 heads
    ((288, 6, 768, 1024), 4 * 288 + 768 + 1024 * 8),
    # H = D = 32: 32 heads already a multiple of 8
    ((32, 32, 64, 32), 128 + 64 + 32 * 32),
    ((16, 9, 24, 100), 64 + 24 + 100 * 16)])
def test_step_scratch_floats_hand_worked(args, want):
    assert tds.step_scratch_floats(*args) == want


def test_fused_decode_step_aliases_caches_by_default():
    pos, h0, cosd, sind, rot, hmask, p, ck, cv = _step_case(3)
    names = ("wq", "wk", "wv", "wo", "gate", "up", "down")
    tw = [t(p[k].transpose(0, 2, 1)) for k in names]
    tck, tcv = t(ck.copy()), t(cv.copy())
    h, ock, ocv = tds.fused_decode_step(
        torch.tensor([pos], dtype=torch.int32), t(h0), t(cosd), t(sind),
        t(rot), t(hmask), t(p["final_norm"][0]), *tw, t(p["in_norm"][:, 0]),
        t(p["post_norm"][:, 0]), tck, tcv)
    assert ock is tck and ocv is tcv
    assert not np.array_equal(tck.numpy(), ck)


def test_fused_decode_step_rejects_bad_arguments():
    pos, h0, cosd, sind, rot, hmask, p, ck, cv = _step_case(4)
    names = ("wq", "wk", "wv", "wo", "gate", "up", "down")
    args = [torch.tensor([pos], dtype=torch.int32), t(h0), t(cosd), t(sind),
            t(rot), t(hmask), t(p["final_norm"][0]),
            *(t(p[k].transpose(0, 2, 1)) for k in names),
            t(p["in_norm"][:, 0]), t(p["post_norm"][:, 0]), t(ck), t(cv)]
    for i, name, bad in ((1, "h0", t(h0).double()), (4, "rot", t(rot[:4])),
                         (7, "wq", args[7][:, :, :3].contiguous()),
                         (17, "cv", args[17].to(torch.bfloat16))):
        with pytest.raises(ValueError, match=name):
            tds.fused_decode_step(*args[:i], bad, *args[i + 1:])
    with pytest.raises(ValueError, match="pos"):
        tds.fused_decode_step(torch.tensor([pos]), *args[1:])


def _tf32(x):
    """x rounded to TF32 to nearest, ties away from zero (``tf32_rna`` in
    ``csrc/common.cuh``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_f32_head_3xtf32_meets_the_emit_tolerance():
    """The float32 head of K1/K2's head stage (``csrc/head.cuh``) on the
    tensor cores, emulated on the CPU at stories15M's head (B=8 rows, D 288,
    V 32000): the normed rows and the head split into TF32 hi and lo parts
    and summed as x_lo w_hi + x_hi w_lo + x_hi w_hi, plus the bias, within
    chip_smoke's ``EMIT_RTOL["f32"]`` of the logit scale of the plain head
    (``decode_token_logits_ref``'s float32 product)."""
    from chip_smoke import EMIT_RTOL
    from pydynet_tpu_torch.nn.modules.norm import rms_norm

    rng = np.random.default_rng(21)
    h = t(rng.standard_normal((8, 288)).astype(np.float32) * 3)
    norm = t(rng.uniform(0.5, 1.5, 288).astype(np.float32))
    w = t(rng.standard_normal((32000, 288)).astype(np.float32) * 0.06)
    b = t(rng.standard_normal(32000).astype(np.float32) * 0.1)
    x = rms_norm(h, norm)
    want = torch.stack([torch.mv(w, row) for row in x]) + b
    xh, wh = _tf32(x), _tf32(w)
    xl, wl = _tf32(x - xh), _tf32(w - wh)
    got = (xl @ wh.T + xh @ wl.T + xh @ wh.T) + b
    err = float((got - want).abs().max())
    assert err <= EMIT_RTOL["f32"] * float(want.abs().max()), err
    one = (_tf32(x) @ _tf32(w).T) + b  # one TF32 product would miss it
    assert float((one - want).abs().max()) > \
        EMIT_RTOL["f32"] * float(want.abs().max())
