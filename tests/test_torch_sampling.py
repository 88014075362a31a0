"""The port's sampling stage against the JAX package's, on the CPU: the
threefry key stream of ``pydynet_tpu_torch/random.py`` against
``jax.random`` (importing ``pydynet_tpu`` turns x64 on, as the JAX package
runs), and the radix cutoff, the filters and the draws of
``pydynet_tpu_torch/models/llama/model.py`` against
``pydynet_tpu/models/llama/model.py``'s.

Tolerances: keys, bits and uniforms are integer or exactly representable
and must be equal. The Gumbel transform ``-log(-log(u))`` goes through the
two frameworks' float32 ``log``, which differ by ulps, so it is held within
2e-6; a categorical draw is then equal wherever the top two perturbed
scores are at least 1e-5 apart. The nucleus mass is a float32 sum taken in
another order, so the mass-mode cutoff is exact on rows where no prefix
mass lies within 1e-6 of ``top_p``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydynet_tpu  # noqa: F401  (x64 on, as the JAX package runs)
from pydynet_tpu.models.llama import model as jmodel

from pydynet_tpu_torch import random as prandom
from pydynet_tpu_torch.models.llama import model as tmodel

NEAR_TIE = 1e-5     # perturbed top-2 gap below which two draws may differ
MASS_GAP = 1e-6     # prefix mass this close to top_p: a float32 sum's noise


def words(jkey):
    """A JAX key array's uint32 words as int64."""
    return np.asarray(jkey).astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("seed", [0, 7, -3, 2**33 + 5])
def test_prng_key_matches_jax(seed):
    assert np.array_equal(prandom.PRNGKey(seed).numpy(),
                          words(jax.random.PRNGKey(seed)))
    if seed == -3:  # the x64 widening: the high word is all ones
        assert prandom.PRNGKey(seed).tolist() == [0xFFFFFFFF, 0xFFFFFFFD]


@pytest.mark.parametrize("n", [2, 5])
def test_split_matches_jax(n):
    for seed in (0, 7, -3):
        want = words(jax.random.split(jax.random.PRNGKey(seed), n))
        assert np.array_equal(prandom.split(prandom.PRNGKey(seed), n).numpy(),
                              want)
    # per-row keys split each row, as vmap(split) does
    jk = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.PRNGKey(1),
                                                 jnp.arange(3))
    tk = prandom.fold_in(prandom.PRNGKey(1), torch.arange(3))
    want = words(jax.vmap(lambda k: jax.random.split(k, n))(jk))
    assert np.array_equal(prandom.split(tk, n).numpy(), want)


def test_fold_in_matches_jax_for_int32_data():
    data = np.array([0, 1, 5, -1, -7, 2**31 - 1, -2**31], np.int32)
    for seed in (0, 0x5EED, -3):
        jk, tk = jax.random.PRNGKey(seed), prandom.PRNGKey(seed)
        want = words(jax.vmap(jax.random.fold_in, (None, 0))(
            jk, jnp.asarray(data)))
        assert np.array_equal(prandom.fold_in(tk, torch.from_numpy(data))
                              .numpy(), want)
        for d in data:  # one int at a time
            assert np.array_equal(prandom.fold_in(tk, int(d)).numpy(),
                                  words(jax.random.fold_in(jk, d)))


@pytest.mark.parametrize("shape", [(3, 5), (4, 32000)])
def test_bits_and_uniform_match_jax(shape):
    for seed in (0, 11):
        jk, tk = jax.random.PRNGKey(seed), prandom.PRNGKey(seed)
        want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
        assert np.array_equal(prandom.bits(tk, shape).numpy(),
                              want.astype(np.int64))
        want = np.asarray(jax.random.uniform(jk, shape, jnp.float32))
        assert np.array_equal(prandom.uniform(tk, shape).numpy(), want)
        lo = float(np.finfo(np.float32).tiny)
        want = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, 1.0))
        assert np.array_equal(prandom.uniform(tk, shape, lo, 1.0).numpy(),
                              want)


@pytest.mark.parametrize("shape", [(3, 5), (4, 32000)])
def test_gumbel_within_2e6_of_jax(shape):
    got = prandom.gumbel(prandom.PRNGKey(3), shape).numpy()
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(3), shape,
                                        jnp.float32))
    assert np.abs(got - want).max() <= 2e-6


def perturbed_gaps(key, logits):
    """Each row's gap between its two largest ``gumbel + logits`` scores,
    as the port's categorical draws them."""
    shape = (tuple(logits.shape) if key.dim() == 1
             else tuple(logits.shape[1:]))
    top2 = (prandom.gumbel(key, shape) + logits).topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).numpy()


@pytest.mark.parametrize("per_row", [False, True], ids=["one_key",
                                                         "per_row_keys"])
def test_categorical_matches_jax_away_from_near_ties(per_row):
    """One key over (B, V) (generate at B > 1) or a key per row
    (vmap(categorical), the server)."""
    rng = np.random.default_rng(0)
    B, V = 512, 1000
    logits = (rng.standard_normal((B, V)) * 2).astype(np.float32)
    logits[rng.random((B, V)) < 0.3] = -np.inf  # filtered-out tokens
    if per_row:
        jk = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.PRNGKey(5),
                                                     jnp.arange(B))
        tk = prandom.fold_in(prandom.PRNGKey(5), torch.arange(B))
        want = np.asarray(jax.vmap(jax.random.categorical)(
            jk, jnp.asarray(logits)))
    else:
        tk = prandom.PRNGKey(5)
        want = np.asarray(jax.random.categorical(jax.random.PRNGKey(5),
                                                 jnp.asarray(logits)))
    t = torch.from_numpy(logits)
    got = prandom.categorical(tk, t).numpy()
    ok = perturbed_gaps(tk, t) >= NEAR_TIE
    assert ok.mean() >= 0.99, ok.mean()
    assert np.array_equal(got[ok], want[ok])


def adversarial_rows():
    """tests/test_llama.py's test_radix_cutoff_exact rows: engineered ties,
    all equal, all negative, mixed sign and large, two rows each."""
    rng = np.random.RandomState(7)
    V = 4096
    ties = rng.randn(2, V).astype(np.float32) * 3
    ties[:, :64] = np.round(ties[:, :64])
    return {
        "normal": rng.randn(2, V).astype(np.float32) * 3,
        "ties": ties,
        "flat": np.full((2, V), 0.5, np.float32),
        "negative": rng.randn(2, V).astype(np.float32) * 0.01 - 50,
        "mixed": rng.randn(2, V).astype(np.float32) * 30,
    }


@pytest.mark.parametrize("name", ["normal", "ties", "flat", "negative",
                                  "mixed"])
def test_radix_cutoff_count_mode_exact(name):
    """The k-th largest value, duplicates counted, for k from 1 to V, and
    the keep-all -inf past V."""
    rows = adversarial_rows()[name]
    V = rows.shape[1]
    lj, lt = jnp.asarray(rows), torch.from_numpy(rows)
    for k in (1, 2, 50, 255, V - 1, V, V + 1):
        want = np.asarray(jmodel._radix_cutoff(lj, jnp.ones_like(lj),
                                               float(k), strict=False))
        got = tmodel._radix_cutoff(lt, torch.ones_like(lt), float(k),
                                   strict=False).numpy()
        assert np.array_equal(got, want), (k, got, want)
    assert np.all(got == -np.inf)  # k = V + 1: nothing qualifies
    # per-row (B, 1) thresholds
    ks = np.array([[3.0], [V]], np.float32)
    want = np.asarray(jmodel._radix_cutoff(lj, jnp.ones_like(lj),
                                           jnp.asarray(ks), strict=False))
    got = tmodel._radix_cutoff(lt, torch.ones_like(lt), torch.from_numpy(ks),
                               strict=False).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["normal", "ties", "flat", "negative",
                                  "mixed"])
def test_radix_cutoff_mass_mode_exact_away_from_the_boundary(name):
    """The nucleus cutoff on every row whose sorted prefix masses all lie
    at least 1e-6 from p; the rows left out are reported and must be
    few."""
    rows = adversarial_rows()[name]
    lj, lt = jnp.asarray(rows), torch.from_numpy(rows)
    pj = jnp.exp(lj - jax.scipy.special.logsumexp(lj, -1, keepdims=True))
    pt = torch.exp(lt - torch.logsumexp(lt, -1, keepdim=True))
    srt = np.sort(pt.numpy().astype(np.float64), -1)[:, ::-1].cumsum(-1)
    checked = left_out = 0
    for p in (0.0, 0.5, 0.9, 0.999):
        want = np.asarray(jmodel._radix_cutoff(lj, pj, p, strict=True))
        got = tmodel._radix_cutoff(lt, pt, p, strict=True).numpy()
        clear = np.abs(srt - p).min(-1) >= MASS_GAP
        checked += int(clear.sum())
        left_out += int((~clear).sum())
        assert np.array_equal(got[clear], want[clear]), (p, got, want)
    print(f"{name}: {checked} rows checked, {left_out} left out")
    assert checked >= 6, (checked, left_out)


def filter_inputs(seed=0, B=3, V=1000):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 2).astype(np.float32)
    logits[:, 5] = logits[:, 6]  # a tie
    seen = rng.random((B, V)) < 0.1
    return logits, seen


def assert_same_filter(got, want):
    """The same -inf set, and the finite entries equal."""
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert np.array_equal(got[fin], want[fin])


@pytest.mark.parametrize("kw", [
    dict(), dict(top_k=17), dict(top_k=1), dict(top_p=0.9), dict(top_p=0.0),
    dict(top_k=50, top_p=0.9),
    dict(top_k=50, top_p=0.9, repetition_penalty=1.3)],
    ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()) or "plain")
def test_filter_logits_matches_jax(kw):
    logits, seen = filter_inputs()
    want = np.asarray(jmodel.filter_logits(
        jnp.asarray(logits), jnp.float32(0.8), seen=jnp.asarray(seen), **kw))
    got = tmodel.filter_logits(torch.from_numpy(logits), 0.8,
                               seen=torch.from_numpy(seen), **kw).numpy()
    assert_same_filter(got, want)


def test_filter_logits_per_row_matches_jax():
    """Per-row temperature (a greedy row at 0), top-k (V keeps all) and
    top-p (1.0 keeps all), with the repetition penalty."""
    logits, seen = filter_inputs(1, B=4)
    temp = np.array([0.8, 0.0, 1.3, 2.0], np.float32)
    topk = np.array([50, 1000, 7, 1], np.int32)
    topp = np.array([0.9, 1.0, 0.5, 0.0001], np.float32)
    rep = np.array([1.2, 1.0, 1.5, 1.1], np.float32)
    want = np.asarray(jmodel.filter_logits_per_row(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(topk),
        jnp.asarray(topp), jnp.asarray(seen), jnp.asarray(rep)))
    got = tmodel.filter_logits_per_row(
        torch.from_numpy(logits), torch.from_numpy(temp),
        torch.from_numpy(topk), torch.from_numpy(topp),
        torch.from_numpy(seen), torch.from_numpy(rep)).numpy()
    assert_same_filter(got, want)
    assert np.isfinite(got[1]).all()  # top_k = V and top_p = 1: keep all


def test_sample_logits_per_row_matches_jax_and_greedy_rows_take_argmax():
    logits, _ = filter_inputs(2, B=4)
    temp = np.array([0.8, 0.0, 1.3, 0.0], np.float32)
    topk = np.array([50, 1000, 7, 3], np.int32)
    topp = np.array([0.9, 1.0, 0.5, 0.7], np.float32)
    jk = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.PRNGKey(9),
                                                 jnp.arange(4))
    tk = prandom.fold_in(prandom.PRNGKey(9), torch.arange(4))
    want = np.asarray(jmodel.sample_logits_per_row(
        jnp.asarray(logits), jk, jnp.asarray(temp), jnp.asarray(topk),
        jnp.asarray(topp)))
    t = torch.from_numpy(logits)
    got = tmodel.sample_logits_per_row(
        t, tk, torch.from_numpy(temp), torch.from_numpy(topk),
        torch.from_numpy(topp)).numpy()
    assert np.array_equal(got[[1, 3]], logits[[1, 3]].argmax(-1))
    f = tmodel.filter_logits_per_row(t, torch.from_numpy(temp),
                                     torch.from_numpy(topk),
                                     torch.from_numpy(topp))
    ok = (perturbed_gaps(tk, f) >= NEAR_TIE) | (temp <= 0)
    assert np.array_equal(got[ok], want[ok])


def test_sample_logits_support_sets():
    """tests/test_llama.py's test_sample_logits_distribution: top-k and
    top-p keep their support sets, and the nucleus keeps both tokens whose
    prefix mass is below p."""
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]]))
    draws = [int(tmodel.sample_logits(logits, prandom.PRNGKey(i), 1.0,
                                      top_k=2)[0]) for i in range(64)]
    assert set(draws) <= {0, 1}
    draws = [int(tmodel.sample_logits(logits, prandom.PRNGKey(i), 1.0,
                                      top_p=0.75)[0]) for i in range(64)]
    assert set(draws) == {0, 1}


def test_sample_logits_wide_nucleus_keeps_the_tail():
    """tests/test_llama.py's test_sample_logits_wide_nucleus_fallback: a
    flat row ties at the cutoff, so every token stays reachable."""
    logits = torch.zeros(1, 4096)
    draws = [int(tmodel.sample_logits(logits, prandom.PRNGKey(i), 1.0,
                                      top_p=0.9)[0]) for i in range(64)]
    assert any(d >= 2048 for d in draws), sorted(set(draws))[:8]


def test_sample_logits_matches_jax_draws():
    """One key over (B, V), every filter at once, against
    ``sample_logits``; top_k = 1 and top_p = 0 are greedy at any
    temperature."""
    logits, seen = filter_inputs(3, B=64)
    kw = dict(top_k=40, top_p=0.9, repetition_penalty=1.2)
    want = np.asarray(jmodel.sample_logits(
        jnp.asarray(logits), jax.random.PRNGKey(4), jnp.float32(0.7),
        seen=jnp.asarray(seen), **kw))
    t, s = torch.from_numpy(logits), torch.from_numpy(seen)
    key = prandom.PRNGKey(4)
    got = tmodel.sample_logits(t, key, 0.7, seen=s, **kw).numpy()
    f = tmodel.filter_logits(t, 0.7, seen=s, **kw)
    ok = perturbed_gaps(key, f) >= NEAR_TIE
    assert ok.mean() >= 0.9 and np.array_equal(got[ok], want[ok])
    for kw in (dict(top_k=1), dict(top_p=0.0)):
        got = tmodel.sample_logits(t, key, 5.0, **kw).numpy()
        assert np.array_equal(got, logits.argmax(-1))


def test_mark_seen_and_sampler_split_like_jax():
    """``_mark_seen`` sets one entry a row; ``Sampler.draw`` carries
    ``split(key)[0]`` on and draws with ``split(key)[1]``."""
    seen = torch.zeros(2, 5, dtype=torch.bool)
    tmodel._mark_seen(seen, torch.tensor([3, 0]))
    assert seen.nonzero().tolist() == [[0, 3], [1, 0]]
    s = tmodel.Sampler(1, 8, "cpu", 1.0, seed=3)
    s.draw(torch.zeros(1, 8))
    key, _ = jax.random.split(jax.random.PRNGKey(3))
    assert np.array_equal(s.key.numpy(), words(key))
