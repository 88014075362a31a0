"""The port's flash attention (plain K3/K4 and the autograd op), attention
routing, cross-entropy, Adam/AdamW and gradient clipping against the JAX
package, on the CPU.

Inputs are made with NumPy from a seed and given to both packages as
float32. The JAX flash kernels run in interpret mode, as
``tests/test_ops_kernels.py`` runs them; the port's wrappers run their plain
versions on CPU tensors. Tolerances are the JAX package's own for its
kernels (``test_ops_kernels.py``): 2e-5 for the forward, 5e-4 for the
gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydynet_tpu as pdn
from pydynet_tpu import optim as joptim
from pydynet_tpu.nn import functional as JF
from pydynet_tpu.nn import utils as jutils
from pydynet_tpu.ops import flash_attention as jfa

from pydynet_tpu_torch import optim as toptim
from pydynet_tpu_torch.nn import functional as TF
from pydynet_tpu_torch.nn import utils as tutils
from pydynet_tpu_torch.nn.modules.loss import CrossEntropyLoss
from pydynet_tpu_torch.ops import flash_attention as tfa

FWD_ATOL, GRAD_ATOL = 2e-5, 5e-4


def qkv(shape, seed, n=4):
    """``n`` float32 arrays of ``shape``: q, k, v and the cotangent."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def jax_grads(fn, q, k, v, g):
    """(out, dq, dk, dv) of ``fn`` under cotangent ``g``."""
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return (np.asarray(out),) + tuple(np.asarray(x)
                                      for x in vjp(jnp.asarray(g)))


def port_grads(q, k, v, g):
    tq, tk, tv = t(q, True), t(k, True), t(v, True)
    out = tfa.flash_attention_causal(tq, tk, tv)
    out.backward(t(g))
    return out.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(), \
        tv.grad.numpy()


def assert_grads_close(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=FWD_ATOL)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL)


def test_plain_kernels_match_jax_pallas_interpret():
    """At (1, 256, 2, 48) the JAX op runs its Pallas forward and backward
    kernels (blocks of 128, interpret mode); the port's plain K3/K4 give the
    same o, lse and gradients."""
    q, k, v, g = qkv((1, 256, 2, 48), 0)
    fn = lambda a, b, c: jfa.flash_attention_causal(a, b, c, None, 128, 128,
                                                    True)
    assert_grads_close(port_grads(q, k, v, g), jax_grads(fn, q, k, v, g))
    scale = 1.0 / np.sqrt(48)
    _, lse = jfa._fa_forward(*(jfa._to_heads(jnp.asarray(x))
                               for x in (q, k, v)), scale, True, 128, 128,
                             True)
    _, tlse = tfa.flash_attention_fwd(t(q), t(k), t(v))
    assert tlse.shape == (1, 2, 256) and tlse.dtype == torch.float32
    np.testing.assert_allclose(tlse.numpy().reshape(2, 256),
                               np.asarray(lse)[..., 0], atol=FWD_ATOL)


@pytest.mark.parametrize("L", [7, 100])
def test_ragged_lengths_match_jax_composite(L):
    """L that no block tiles: the JAX op takes its composite fallback with
    the analytic softmax gradient; the port's kernels (and so their plain
    versions) take any L."""
    q, k, v, g = qkv((2, L, 3, 48), L)
    assert_grads_close(port_grads(q, k, v, g),
                       jax_grads(jfa.flash_attention_causal, q, k, v, g))


def test_wrappers_compose_to_the_autograd_op():
    """fwd, then dd and the dq and dk/dv halves, give the op's forward and
    gradients; the plain K4 equals its two halves."""
    q, k, v, g = (t(a) for a in qkv((2, 33, 2, 16), 3))
    o, lse = tfa.flash_attention_fwd(q, k, v)
    dd = tfa.attention_dd(o, g)
    dq = tfa.flash_attention_bwd_dq(q, k, v, g, lse, dd)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, g, lse, dd)
    got = port_grads(*(x.numpy() for x in (q, k, v, g)))
    for a, b in zip((o, dq, dk, dv), got):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(tfa.flash_attention_bwd_ref(q, k, v, o, lse, g, 0.25),
                    tfa.flash_attention_bwd(q, k, v, o, lse, g)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_autograd_op_gradcheck_float64():
    rng = np.random.default_rng(4)
    args = [torch.from_numpy(rng.standard_normal((2, 5, 2, 4)))
            .requires_grad_() for _ in range(3)]
    assert torch.autograd.gradcheck(tfa.flash_attention_causal, args)


def test_bf16_saves_o_and_lse_in_their_types():
    q, k, v, g = (t(a).to(torch.bfloat16) for a in qkv((1, 9, 2, 8), 5))
    for x in (q, k, v):
        x.requires_grad_()
    o = tfa.flash_attention_causal(q, k, v)
    saved = o.grad_fn.saved_tensors
    assert o.dtype == torch.bfloat16
    assert [s.dtype for s in saved[3:]] == [torch.bfloat16, torch.float32]
    o.backward(g)
    assert all(x.grad.dtype == torch.bfloat16 for x in (q, k, v))


def test_wrappers_check_arguments_and_never_count_cpu_calls():
    q, k, v, g = (t(a) for a in qkv((1, 6, 2, 8), 6))
    counts = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches)
    o, lse = tfa.flash_attention_fwd(q, k, v)
    tfa.flash_attention_bwd(q, k, v, o, lse, g)
    assert counts == (tfa.flash_attention_fwd.launches,
                      tfa.flash_attention_bwd_dq.launches,
                      tfa.flash_attention_bwd_dkv.launches)
    dd = tfa.attention_dd(o, g)
    with pytest.raises(ValueError, match="k: expected"):
        tfa.flash_attention_fwd(q, k[:, :5], v)
    with pytest.raises(ValueError, match="v: expected"):
        tfa.flash_attention_fwd(q, k, v.double())
    with pytest.raises(ValueError, match="lse: expected"):
        tfa.flash_attention_bwd_dq(q, k, v, g, lse.double(), dd)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_bwd_dkv(q, k, v, g.transpose(1, 2)
                                    .contiguous().transpose(1, 2), lse, dd)
    with pytest.raises(ValueError, match=r"\(B, L, H, d\)"):
        tfa.flash_attention_fwd(q[0], k[0], v[0])


@pytest.mark.parametrize("route", ["causal", "mask+causal", "mask", "none"])
def test_sdpa_routing_matches_jax(route, monkeypatch):
    q, k, v, _ = qkv((1, 10, 2, 8), 7)
    rng = np.random.default_rng(8)
    mask = np.where(rng.random((10, 10)) < 0.2, -np.inf,
                    rng.standard_normal((10, 10))).astype(np.float32)
    np.fill_diagonal(mask, 0.0)
    kw = {"causal": route in ("causal", "mask+causal"),
          "mask": mask if "mask" in route else None}
    flash = []
    real = tfa.flash_attention_causal
    monkeypatch.setattr(tfa, "flash_attention_causal",
                        lambda *a: flash.append(1) or real(*a))
    got = TF.scaled_dot_product_attention(
        t(q), t(k), t(v), None if kw["mask"] is None else t(mask),
        causal=kw["causal"])
    want = JF.scaled_dot_product_attention(
        pdn.Tensor(q), pdn.Tensor(k), pdn.Tensor(v),
        None if kw["mask"] is None else pdn.Tensor(mask),
        causal=kw["causal"]).numpy()
    assert bool(flash) == (route == "causal")
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL)


@pytest.mark.parametrize("labels", ["indices", "one-hot"])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_cross_entropy_global_max_shift_matches_jax(reduction, labels):
    """Logits spread over 100: rows far below the global maximum, where a
    per-row shift would give another value, match the JAX package; so does
    the gradient."""
    rng = np.random.default_rng(9)
    logits = (rng.random((6, 11)) * 100.0 - 50.0).astype(np.float32)
    y = rng.integers(0, 11, size=6)
    target = y if labels == "indices" else np.eye(11, dtype=np.float32)[y]
    jl = pdn.Tensor(logits, requires_grad=True)
    jloss = JF.cross_entropy_loss(jl, pdn.Tensor(target), reduction)
    jloss.backward()
    tl = t(logits, True)
    tloss = CrossEntropyLoss(reduction)(tl, torch.from_numpy(target))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss.numpy()),
                               rtol=1e-6)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jl.grad),
                               atol=1e-6)
    with pytest.raises(ValueError):
        CrossEntropyLoss("none")


def _grad_sequence(seed, shapes, steps):
    rng = np.random.default_rng(seed)
    return [[(rng.standard_normal(s) * 10.0 ** rng.integers(-9, 1))
             .astype(np.float32) for s in shapes] for _ in range(steps)]


@pytest.mark.parametrize("opt", ["Adam", "Adam-wd", "AdamW"])
@pytest.mark.parametrize("clip", [None, 2.0, float("inf")])
def test_optimizers_and_clipping_match_jax(opt, clip):
    """Six steps on a fixed gradient sequence spanning magnitudes from 1e-9
    (where eps dominates, and torch.optim.Adam would differ) to 1, with
    clip_grad_norm_ (2-norm and inf-norm) before each step; one parameter
    never gets a gradient in the first steps."""
    shapes = [(3, 4), (5,), (2, 2)]
    rng = np.random.default_rng(10)
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = _grad_sequence(11, shapes, 6)
    jp = [pdn.Tensor(a.copy(), requires_grad=True) for a in init]
    tp = [t(a.copy(), True) for a in init]
    name, wd = opt.split("-")[0], 0.1 if opt != "Adam" else 0.0
    jo = getattr(joptim, name)(jp, lr=1e-2, weight_decay=wd)
    to = getattr(toptim, name)(tp, lr=1e-2, weight_decay=wd)
    for i, gs in enumerate(grads):
        jo.zero_grad()
        to.zero_grad()
        for j, (a, b, g) in enumerate(zip(jp, tp, gs)):
            if j == 2 and i < 3:
                continue  # no gradient: Adam steps on zeros, AdamW no decay
            a.grad = jnp.asarray(g)
            b.grad = t(g)
        if clip is not None:
            jn = jutils.clip_grad_norm_(jp, clip, norm_type=clip)
            tn = tutils.clip_grad_norm_(tp, clip, norm_type=clip)
            np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
        jo.step()
        to.step()
    assert to.t == jo.t == 7.0 and to.lr == pytest.approx(jo.lr)
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.detach().numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_clip_grad_value_and_empty_norm_match_jax():
    g = np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4)
    jp, tp = pdn.Tensor(g.copy(), requires_grad=True), t(g.copy(), True)
    jp.grad, tp.grad = jnp.asarray(g), t(g)
    jutils.clip_grad_value_(jp, 1.5)
    tutils.clip_grad_value_(tp, 1.5)
    np.testing.assert_array_equal(tp.grad.numpy(), np.asarray(jp.grad))
    assert float(tutils.clip_grad_norm_([t(g, True)], 1.0)) == 0.0


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: the magnitude's bits plus half a
    unit of the last kept bit, truncated."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the flash backward kernels multiply float32 on the tensor
    cores: a = hi + lo with hi = tf32(a), lo = tf32(a - hi) (b alike), and
    a_lo b_hi + a_hi b_lo + a_hi b_hi summed in float32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def test_k4_3xtf32_products_meet_the_card_tolerances():
    """K4's numerical design, emulated on the CPU at the training shape
    (1, 1024, 6, 48) in float32: every product of dq and dk/dv (q k^T,
    dO v^T, ds k, ds^T q, p^T dO) split into TF32 parts as the kernels split
    them. dq, dk and dv stay within chip_smoke's ``FLASH_ATOL`` of the plain
    K4 and within ``TRAIN_GRAD_RTOL`` of each tensor's largest value, the
    two gates the card is held to."""
    from chip_smoke import FLASH_ATOL, TRAIN_GRAD_RTOL

    q, k, v, do = (t(a) for a in qkv((1, 1024, 6, 48), 11))
    scale = 48 ** -0.5
    _, lse = tfa.flash_attention_fwd_ref(q, k, v, scale)
    o = tfa.flash_attention_fwd_ref(q, k, v, scale)[0]
    dd = tfa.attention_dd(o, do)
    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
    L = q.shape[1]
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    s = _mm_3xtf32(qh, kh.transpose(-1, -2))
    p = torch.where(causal, torch.exp(s * scale - lse[..., None]), 0.0)
    ds = p * (_mm_3xtf32(doh, vh.transpose(-1, -2)) - dd[..., None])
    got = {"dq": _mm_3xtf32(ds, kh) * scale,
           "dk": _mm_3xtf32(ds.transpose(-1, -2), qh) * scale,
           "dv": _mm_3xtf32(p.transpose(-1, -2), doh)}
    want = dict(zip(("dk", "dv"), tfa.flash_attention_bwd_dkv_ref(
        q, k, v, do, lse, dd, scale)))
    want["dq"] = tfa.flash_attention_bwd_dq_ref(q, k, v, do, lse, dd, scale)
    for name, g in got.items():
        w = want[name]
        err = float((g.transpose(1, 2) - w).abs().max())
        assert err <= FLASH_ATOL[name], (name, err)
        assert err <= TRAIN_GRAD_RTOL * float(w.abs().max()), (name, err)


def _k3_emulated(q, k, v, scale, kb=64, shares=4):
    """K3's arithmetic (``fa_fwd_kernel``), emulated on the CPU in float32:
    q k^T by 3xTF32 (q unscaled), the scores scaled into the log2 domain,
    each of ``shares`` warps running its own online softmax over its
    kb / shares keys of every kb-key stage with p = 2^(s - m) and p V by
    3xTF32, then the shares' (m, l, acc) states merged into share 0's in
    the order 1, 2, ...; returns (o in q's type, lse)."""
    qh, kh, vh = (x.transpose(1, 2).float() for x in (q, k, v))
    L = q.shape[1]
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    scale2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        1.4426950408889634, dtype=torch.float32)
    s = torch.where(causal, _mm_3xtf32(qh, kh.transpose(-1, -2)) * scale2,
                    float("-inf"))

    def rescale(m, mn):
        return torch.exp2(m - torch.where(mn == float("-inf"), 0.0, mn))

    kw, states = kb // shares, []
    for sp in range(shares):
        m = torch.full(s.shape[:-1], float("-inf"))
        l = torch.zeros(s.shape[:-1])
        acc = torch.zeros(qh.shape)
        for k0 in range(sp * kw, L, kb):
            x = s[..., k0:k0 + kw]
            mn = torch.maximum(m, x.amax(-1))
            a = rescale(m, mn)
            p = rescale(x, mn[..., None])
            l = l * a + p.sum(-1)
            acc = acc * a[..., None] + _mm_3xtf32(p, vh[..., k0:k0 + kw, :])
            m = mn
        states.append((m, l, acc))
    m, l, acc = states[0]
    for mo, lo, acco in states[1:]:
        mn = torch.maximum(m, mo)
        a, b = rescale(m, mn), rescale(mo, mn)
        l, acc, m = l * a + lo * b, acc * a[..., None] + acco * b[..., None], mn
    o = (acc / l[..., None]).transpose(1, 2).to(q.dtype)
    return o, m * 0.6931471805599453 + torch.log(l)


@pytest.mark.parametrize("L", [77, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k3_3xtf32_shares_meet_the_card_tolerances(dtype, L):
    """K3's numerical design, emulated on the CPU at stories15M's heads (6
    of 48 features) and a ragged L: 3xTF32 products, 64-key stages split
    over 4 shares, each an online softmax in the log2 domain, merged in a
    fixed order. o and lse stay within chip_smoke's ``FLASH_ATOL`` of the
    plain K3 (a bfloat16 o within one of its units more, as on the card)."""
    from chip_smoke import BF16_ULP, FLASH_ATOL

    q, k, v = (t(a).to(dtype) for a in qkv((1, L, 6, 48), 12, 3))
    scale = 48 ** -0.5
    got = dict(zip(("o", "lse"), _k3_emulated(q, k, v, scale)))
    want = dict(zip(("o", "lse"), tfa.flash_attention_fwd_ref(q, k, v,
                                                              scale)))
    for name in ("o", "lse"):
        w = want[name].float()
        err = (got[name].float() - w).abs()
        tol = FLASH_ATOL[name] + (BF16_ULP * w.abs()
                                  if got[name].dtype == torch.bfloat16
                                  else 0.0)
        assert bool((err <= tol).all()), (name, float(err.max()))
