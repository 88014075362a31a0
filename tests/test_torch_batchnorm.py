"""The port's train-mode BatchNorm op (K8, ``pydynet_tpu_torch/ops/
batchnorm.py``) against the JAX package's, on the CPU.

On the CPU the port's op runs its plain version; the JAX package's Pallas
kernel runs in interpret mode. Inputs are numpy draws handed to both.
Tolerances: float32 outputs are held to the JAX package's own tolerances for
its kernel against its composite (out 1e-5, mean 1e-6, var 1e-5 at O(1)
values; the sums are taken in another order); a bfloat16 ``out`` may round
to the neighbouring bfloat16 value, one ulp, at most 2**-7 of its
magnitude; gradients 1e-4, as the JAX package holds its custom VJP.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydynet_tpu.ops import batchnorm as jbn

from pydynet_tpu_torch.ops import batchnorm as tbn

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

SHAPES = [(8, 7), (16, 128), (32, 128), (40, 512)]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
BF16_ULP = 2.0**-7


def inputs(N, C, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((N, C)) * 3 + 1).astype(np.float32)
    g = rng.standard_normal((1, C)).astype(np.float32)
    b = rng.standard_normal((1, C)).astype(np.float32)
    return x, g, b


def as_f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_matches_jax_kernel_and_composite(shape, dtype):
    tdt, jdt = DTYPES[dtype]
    x, g, b = inputs(*shape)
    xt = torch.from_numpy(x).to(tdt)
    xj = jnp.asarray(x).astype(jdt)
    got = tbn.batch_norm_train(xt, torch.from_numpy(g), torch.from_numpy(b))
    assert got[0].dtype == tdt and got[0].shape == shape
    assert all(t.dtype == torch.float32 and t.shape == (1, shape[1])
               for t in got[1:])
    kernel = jbn.batch_norm_train(xj, jnp.asarray(g), jnp.asarray(b), 1e-6,
                                  True)
    composite = jbn._bn_composite(xj, jnp.asarray(g), jnp.asarray(b), 1e-6)
    for want in (kernel, composite):
        out, mean, var = (as_f32(a) for a in want)
        o = got[0].float().numpy()
        tol = 1e-5 + (BF16_ULP * np.abs(out) if dtype == "bf16" else 0.0)
        assert np.all(np.abs(o - out) <= tol), np.abs(o - out).max()
        np.testing.assert_allclose(got[1].numpy(), mean, atol=1e-6, rtol=0)
        np.testing.assert_allclose(got[2].numpy(), var, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(16, 128), (40, 512)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_grads_match_jax_custom_vjp(shape):
    """d/dx, d/dgamma, d/dbeta of sum(out * w) through the port's autograd
    op against ``jax.grad`` of the JAX custom VJP (its kernel in interpret
    mode)."""
    x, g, b = inputs(*shape, seed=1)
    g = g + 1
    w = np.random.default_rng(2).standard_normal(shape).astype(np.float32)

    def f(x, g, b):
        return jnp.sum(jbn.batch_norm_train(x, g, b, 1e-6, True)[0] * w)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(g),
                                          jnp.asarray(b))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, g, b)]
    (tbn.batch_norm_train(*ts)[0] * torch.from_numpy(w)).sum().backward()
    for t, j in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=1e-4,
                                   rtol=0)


def test_backward_formula_equals_autograd_of_plain():
    """The op's backward (``_bn_bwd``'s formula) against autograd through
    the plain composite, in float64."""
    x, g, b = (torch.from_numpy(a).double().requires_grad_()
               for a in inputs(12, 9, seed=3))
    dout = torch.randn(12, 9, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(tbn.batch_norm_train(x, g, b)[0], (x, g, b),
                              dout)
    want = torch.autograd.grad(tbn.batch_norm_train_ref(x, g, b)[0],
                               (x, g, b), dout)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-12, rtol=1e-10)


def test_gradcheck_float64():
    x, g, b = (torch.from_numpy(a).double().requires_grad_()
               for a in inputs(6, 5, seed=4))
    assert torch.autograd.gradcheck(
        lambda x, g, b: tbn.batch_norm_train(x, g, b, 1e-3)[0], (x, g, b))


def test_stats_are_not_differentiable():
    x, g, b = (torch.from_numpy(a).requires_grad_()
               for a in inputs(8, 4, seed=5))
    out, mean, var = tbn.batch_norm_train(x, g, b)
    assert out.requires_grad
    assert not mean.requires_grad and not var.requires_grad


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_single_row_gives_beta(dtype):
    """N = 1: the variance is 0, the centred row 0, so out is beta; the JAX
    composite (its kernel needs N >= 8) agrees."""
    tdt, jdt = DTYPES[dtype]
    x, g, b = inputs(1, 7, seed=6)
    out, mean, var = tbn.batch_norm_train(torch.from_numpy(x).to(tdt),
                                          torch.from_numpy(g),
                                          torch.from_numpy(b))
    assert torch.equal(var, torch.zeros(1, 7))
    torch.testing.assert_close(mean, torch.from_numpy(x).to(tdt).float())
    assert torch.equal(out, torch.from_numpy(b).to(tdt))
    # the composite's out has the promoted type of x and gamma (float32)
    jout = jbn._bn_composite(jnp.asarray(x).astype(jdt), jnp.asarray(g),
                             jnp.asarray(b), 1e-6)[0]
    np.testing.assert_array_equal(out.float().numpy(),
                                  as_f32(jout.astype(jdt)))


def test_cpu_inputs_count_no_launch():
    x, g, b = (torch.from_numpy(a) for a in inputs(16, 32, seed=7))
    before = tbn.batch_norm_train.launches
    tbn.batch_norm_train(x, g, b)
    tbn.batch_norm_train_ref(x, g, b)
    assert tbn.batch_norm_train.launches == before


def test_wrapper_checks_shapes():
    x, g, b = (torch.from_numpy(a) for a in inputs(4, 6, seed=8))
    with pytest.raises(ValueError, match=r"gamma: expected \(1, 6\)"):
        tbn.batch_norm_train(x, g[0], b)
    with pytest.raises(ValueError, match="x: expected"):
        tbn.batch_norm_train(x[None], g, b)
    with pytest.raises(ValueError, match="contiguous"):
        tbn.batch_norm_train(torch.from_numpy(inputs(6, 4)[0]).t(), g, b)
    with pytest.raises(ValueError, match="floating"):
        tbn.batch_norm_train(x.int(), g, b)


# bn_plan (csrc/batchnorm.cu's cut of a batch) worked by hand: strips of 128
# bytes a row; the cluster doubles from 1 while half a slab keeps 64 rows
# and the blocks do not fill 132 SMs, or a slab passes 1,408 rows (176 KB),
# or the blocks cannot all be resident (228 KB an SM, 1 KB reserved a block,
# at most 8 blocks).
PLAN_CASES = [
    # the trainer's batch: half a slab would be 20 rows, one block a strip
    ((40, 512, 4), dict(width=32, strips=16, cluster=1, rows=40, cached=40,
                        held_all=True)),
    # 63 rows a half slab at 126, 64 at 127
    ((126, 1024, 4), dict(width=32, strips=32, cluster=1, rows=126,
                          cached=126, held_all=True)),
    ((127, 1024, 4), dict(width=32, strips=32, cluster=2, rows=64, cached=64,
                          held_all=True)),
    # 32 x 8 = 256 blocks of 19.7 KB fill the SMs, 8 resident on each
    ((1024, 1024, 4), dict(width=32, strips=32, cluster=8, rows=128,
                           cached=128, held_all=True)),
    # at a cluster of 8 one 132 KB block an SM: 132 < 256, so 16 (69 KB)
    ((8192, 1024, 4), dict(width=32, strips=32, cluster=16, rows=512,
                           cached=512, held_all=True)),
    ((8192, 1024, 2), dict(width=64, strips=16, cluster=16, rows=512,
                           cached=512, held_all=True)),
    # one strip: the cluster grows to 16; 1,409 rows hold 1,408
    ((22529, 32, 4), dict(width=32, strips=1, cluster=16, rows=1409,
                          cached=1408, held_all=False)),
    ((1, 7, 2), dict(width=64, strips=1, cluster=1, rows=1, cached=1,
                     held_all=True)),
]


@pytest.mark.parametrize("args,want", PLAN_CASES,
                         ids=lambda a: "x".join(map(str, a))
                         if isinstance(a, tuple) else "")
def test_bn_plan_hand_worked(args, want):
    assert tbn.bn_plan(*args) == want


@pytest.mark.parametrize("seam", range(9))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_jax_at_the_kernel_seams(dtype, seam):
    """chip_smoke.bn_seam_shapes (the shapes that cut the kernel's plan at
    its seams) against the JAX package's op: its Pallas kernel in interpret
    mode where ``_fits_vmem`` holds, its composite beyond; the tolerances
    of the test above."""
    from chip_smoke import bn_seam_shapes

    tdt, jdt = DTYPES[dtype]
    N, C = bn_seam_shapes(torch.finfo(tdt).bits // 8)[seam]
    x, g, b = inputs(N, C, seed=seam)
    got = tbn.batch_norm_train(torch.from_numpy(x).to(tdt),
                               torch.from_numpy(g), torch.from_numpy(b))
    out, mean, var = (as_f32(a) for a in jbn.batch_norm_train(
        jnp.asarray(x).astype(jdt), jnp.asarray(g), jnp.asarray(b), 1e-6,
        True))
    tol = 1e-5 + (BF16_ULP * np.abs(out) if dtype == "bf16" else 0.0)
    assert np.all(np.abs(got[0].float().numpy() - out) <= tol)
    np.testing.assert_allclose(got[1].numpy(), mean, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[2].numpy(), var, atol=1e-5, rtol=0)
