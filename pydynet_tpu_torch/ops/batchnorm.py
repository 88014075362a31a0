"""Train-mode BatchNorm over an (N, C) batch: the port of the Pallas TPU
kernel ``_bn_kernel`` of ``pydynet_tpu/ops/batchnorm.py`` (K8, :28).

:func:`batch_norm_train` is the differentiable op, the counterpart of the
JAX package's custom-VJP ``batch_norm_train`` (:66). It returns ``(out,
mean, var)``: ``out`` in x's type, ``mean`` and ``var`` (1, C) float32, the
batch mean and the biased batch variance. For a CUDA tensor its forward
launches the hand-written Hopper kernel of ``csrc/batchnorm.cu`` and counts
the launch in ``batch_norm_train.launches``; for a CPU tensor it runs the
plain version :func:`batch_norm_train_ref`. A launch recorded into a CUDA
graph (``jit``'s capture) is counted in ``batch_norm_train.captured``
instead: it runs at each of the graph's replays, so the launches inside a
graph are its captured launches times its replays. It never falls back: a
CUDA input the kernel does not take (float64, float16, a shape other than
(N, C) with (1, C) gamma and beta) raises. Its backward is ``_bn_bwd``'s
formula (:96) in plain torch ops: the JAX package computes it with XLA, not
a Pallas kernel. The cotangents of ``mean`` and ``var`` are dropped by
design, as there (:110): they feed only the running statistics, which are
buffers.

The JAX package's ``_fits_vmem`` rule (:56) is not ported: its size cap and
its N >= 8 rule exist for VMEM and the TPU's (8, 128) tiling. The kernel
takes every N >= 1 and C >= 1 in float32 and bfloat16. Like the JAX rule
for float64, the ``BatchNorm1d`` module sends what the kernel does not take
to its composite (``nn/modules/norm.py``). How the kernel cuts a batch into
column strips and row slabs, a thread-block cluster a strip, is
:func:`bn_plan`, the mirror of ``bn_plan`` in the CUDA source.

On the CPU the plain version also takes float64 (gradient checks): there
every step, ``mean`` and ``var`` included, is in float64.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # -> the C type code

# csrc/batchnorm.cu's cut of a batch: 128 bytes of a row a strip; at least
# this many rows a slab once split; the SMs the blocks should fill, the
# shared memory of one and the blocks it holds at most; the largest
# cluster; the shared memory a slab may take; the block's threads
STRIP_BYTES, MIN_SLAB_ROWS, SMS, MAX_CLUSTER = 128, 64, 132, 16
SM_SMEM, SM_BLOCKS, THREADS = 228 * 1024, 8, 256
SLAB_BYTES = 176 * 1024


def bn_smem(held: int, cluster: int, width: int) -> int:
    """Dynamic shared memory of a K8 block (``bn_smem`` in
    ``csrc/batchnorm.cu``): ``held`` rows of 128 bytes, then the warps'
    sums, the two exchanges' ``cluster`` slots and the mean and rstd,
    ``width`` floats each."""
    return held * STRIP_BYTES + (THREADS // 32 + 2 * cluster + 2) * width * 4


def bn_plan(N: int, C: int, itemsize: int) -> dict:
    """How K8 cuts an (N, C) batch of ``itemsize``-byte elements (``bn_plan``
    in ``csrc/batchnorm.cu``): strips of ``width`` columns (128 bytes a
    row); ``cluster`` blocks a strip, one thread-block cluster, each taking
    a slab of ``rows`` rows (the last may be short), of which the first
    ``cached`` are held in shared memory (all of them when ``held_all``:
    x is then read from device memory once) and the rest read again from
    x in each pass. The cluster doubles from 1 while half a slab keeps
    MIN_SLAB_ROWS rows and the blocks do not yet fill SMS, or a slab passes
    SLAB_BYTES, or the blocks cannot all be resident at once (SM_SMEM and
    SM_BLOCKS an SM, 1 KB of it reserved a block)."""
    width = STRIP_BYTES // itemsize
    strips = -(-C // width)
    max_rows = SLAB_BYTES // STRIP_BYTES

    def slab(c):
        return -(-N // c)

    def resident(c):
        per_sm = SM_SMEM // (bn_smem(min(slab(c), max_rows), c, width)
                             + 1024)
        return SMS * min(SM_BLOCKS, per_sm)

    cs = 1
    while (cs < MAX_CLUSTER and slab(2 * cs) >= MIN_SLAB_ROWS
           and (strips * cs < SMS or slab(cs) > max_rows
                or strips * cs > resident(cs))):
        cs *= 2
    rows = slab(cs)
    return dict(width=width, strips=strips, cluster=cs, rows=rows,
                cached=min(rows, max_rows), held_all=rows <= max_rows)


def _acc(dtype):
    """Accumulation type: float32, or float64 for float64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def batch_norm_train_ref(x, gamma, beta, eps=1e-6):
    """Plain K8 with ``_bn_kernel``'s arithmetic, in the accumulation type:
    the mean, then the mean of the centred squares (two passes), then
    ``centred * rsqrt(var + eps) * gamma + beta``. Differentiable by
    autograd, as any composite."""
    acc = _acc(x.dtype)
    xa = x.to(acc)
    n = x.shape[0]
    mean = xa.sum(0, keepdim=True) / n
    centred = xa - mean
    var = (centred * centred).sum(0, keepdim=True) / n
    out = centred * torch.rsqrt(var + eps) * gamma.to(acc) + beta.to(acc)
    return out.to(x.dtype), mean, var


def batch_norm_train_bwd(dout, x, gamma, beta, mean, var, eps=1e-6):
    """``(dx, dgamma, dbeta)`` by ``_bn_bwd``'s formula, accumulated in the
    accumulation type: with xhat = (x - mean) * rstd and g = dout * gamma,
    dx = rstd * (g - mean(g) - xhat * mean(g * xhat)) over the batch."""
    acc = _acc(x.dtype)
    dout = dout.to(acc)
    rstd = torch.rsqrt(var.to(acc) + eps)
    xhat = (x.to(acc) - mean.to(acc)) * rstd
    dbeta = dout.sum(0, keepdim=True)
    dgamma = (dout * xhat).sum(0, keepdim=True)
    g = dout * gamma.to(acc)
    dx = rstd * (g - g.mean(0, keepdim=True)
                 - xhat * (g * xhat).mean(0, keepdim=True))
    return dx.to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(beta.dtype)


def _check(x, gamma, beta):
    """Raise unless x is (N, C) and gamma, beta (1, C), contiguous floating
    tensors on one device; on a CUDA device the kernel also needs float32 or
    bfloat16 for each. Returns (N, C)."""
    if x.dim() != 2 or min(x.shape) < 1:
        raise ValueError(f"x: expected (N, C) with N, C >= 1, got "
                         f"{tuple(x.shape)}")
    N, C = x.shape
    for name, t in dict(x=x, gamma=gamma, beta=beta).items():
        if name != "x" and tuple(t.shape) != (1, C):
            raise ValueError(f"{name}: expected (1, {C}), got "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if not t.dtype.is_floating_point:
            raise ValueError(f"{name}: expected a floating type, got "
                             f"{t.dtype}")
    if x.device.type == "cpu":
        return N, C
    if x.device.type != "cuda":
        raise ValueError(f"no batch_norm_train kernel for device {x.device}")
    bad = {n: t.dtype for n, t in dict(x=x, gamma=gamma, beta=beta).items()
           if t.dtype not in KERNEL_DTYPES}
    if bad or gamma.dtype != beta.dtype:
        raise ValueError(f"beyond the kernel's types: x {x.dtype}, gamma "
                         f"{gamma.dtype}, beta {beta.dtype} (float32 or "
                         f"bfloat16; gamma and beta of one type)")
    return N, C


def _forward(x, gamma, beta, eps):
    """K8's forward on x's device: the kernel on a GPU, the plain version on
    the CPU."""
    N, C = _check(x, gamma, beta)
    if x.device.type == "cpu":
        return batch_norm_train_ref(x, gamma, beta, eps)
    lib = _build.load()
    out = torch.empty_like(x)
    mean = torch.empty((1, C), dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    if torch.cuda.is_current_stream_capturing():
        batch_norm_train.captured += 1
    else:
        batch_norm_train.launches += 1
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pdt_batch_norm_train(
            KERNEL_DTYPES[x.dtype], KERNEL_DTYPES[gamma.dtype], x.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            mean.data_ptr(), var.data_ptr(), N, C, ctypes.c_float(eps),
            stream)
    if err != 0:
        raise RuntimeError(f"batch_norm_train launch failed: CUDA error "
                           f"{err}")
    return out, mean, var


class _BatchNormTrain(torch.autograd.Function):
    """Forward through K8, saving x, gamma and the batch statistics;
    backward by :func:`batch_norm_train_bwd`."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        out, mean, var = _forward(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, beta, mean, var)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        x, gamma, beta, mean, var = ctx.saved_tensors
        return (*batch_norm_train_bwd(dout, x, gamma, beta, mean, var,
                                      ctx.eps), None)


def batch_norm_train(x, gamma, beta, eps=1e-6):
    """(N, C) train-mode BatchNorm -> ``(out, batch_mean, batch_var)``,
    differentiable in x, gamma and beta (not in the statistics). gamma and
    beta are (1, C)."""
    return _BatchNormTrain.apply(x, gamma, beta, eps)


batch_norm_train.launches = 0
batch_norm_train.captured = 0
