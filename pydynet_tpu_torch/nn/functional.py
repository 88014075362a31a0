"""Functional nn ops (counterpart of ``pydynet_tpu/nn/functional.py``).

The JAX package's conventions are kept, not PyTorch's: ``linear`` takes an
(in, out) weight; convolutions take NCHW inputs and OIHW kernels with no
bias; pooling pads with zeros before the window reduction, so a padded zero
can win a max; ``softmax``, ``log_softmax`` and the losses reduce over every
axis unless told an axis; ``nll_loss`` is the mean (or sum) of
``-y_pred * y_true`` over every element; ``relu(x)`` passes the gradient at
x = 0 and ``leaky_relu`` both operands' gradients at x = 0 (the JAX
package's maximum gives the full gradient to each operand of a tie); max
pooling splits a tied window's gradient evenly, as ``jnp.max`` over the
window does. Attention routes to the flash kernels (K3/K4) as there.
Convolution and average pooling call PyTorch's operators: the JAX package
leaves them to XLA, not to Pallas.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ..ops import flash_attention as fa
from .. import random as prandom


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with an (in, out) weight."""
    affine = x @ weight
    if bias is not None:
        affine = affine + bias
    return affine


def embedding(x, weight, padding_idx: int = None):
    """Rows of ``weight`` for the indices ``x``; rows of ``padding_idx`` are
    multiplied by zero, so they get no gradient."""
    query = weight[x]
    if padding_idx is not None:
        query = query * (x != padding_idx).unsqueeze(-1).to(query.dtype)
    return query


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def relu(x):
    """max(0, x); clamp's gradient passes at x = 0, as the JAX package's
    tie rule does."""
    return x.clamp_min(0.0)


class _Maximum(torch.autograd.Function):
    """Elementwise max(a, b) of one shape whose gradient reaches every
    operand equal to the result: both of a tie get all of it
    (``pydynet_tpu/core/tensor.py:maximum``), where ``torch.maximum`` gives
    each half."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.maximum(a, b)
        ctx.save_for_backward(a == out, b == out)
        return out

    @staticmethod
    def backward(ctx, g):
        on_a, on_b = ctx.saved_tensors
        return g * on_a, g * on_b


def leaky_relu(x, alpha: float):
    """max(x, alpha * x); at x = 0 the gradient is 1 + alpha."""
    return _Maximum.apply(x, alpha * x)


def silu(x):
    return x * torch.sigmoid(x)


def gelu(x):
    """Sigmoid-approximated GELU, ``x * sigmoid(1.702 x)``."""
    return x * torch.sigmoid(1.702 * x)


def dropout(x, p: float, training: bool = True, generator=None):
    """Inverted dropout, the JAX package's rule: ``keep = uniform(x.shape,
    x.dtype) < 1 - p`` from one split of ``generator``'s key (a
    ``random.Generator``, ``random.default_generator`` when not given), the
    draw on x's device, then ``x * (keep / (1 - p))``. The mask is the JAX
    package's bit for bit when the draws come in the same order."""
    if not training or p <= 0:
        return x
    gen = generator or prandom.default_generator
    keep = gen.uniform(x.shape, dtype=x.dtype, device=x.device) < (1 - p)
    # a tensor divisor: a true division, as jnp's (a Python scalar divisor
    # is a product with its reciprocal on a GPU); filled on the device, no
    # copy from the host
    scale = torch.full((), 1 - p, dtype=x.dtype, device=x.device)
    return x * (keep.to(x.dtype) / scale)


def _dims(x, axis):
    return tuple(range(x.dim())) if axis is None else axis


def softmax(x, axis=None):
    """Softmax over ``axis`` (every axis when None), shifted by the maximum
    taken without a gradient."""
    dims = _dims(x, axis)
    with torch.no_grad():
        shift = x.amax(dim=dims, keepdim=True)
    e = torch.exp(x - shift)
    return e / e.sum(dim=dims, keepdim=True)


def log_softmax(x, axis=None, keepdims: bool = False):
    """``x - max - log(sum(exp(x - max)))`` over ``axis``; as in the JAX
    package, the sum keeps its axis only with ``keepdims``."""
    dims = _dims(x, axis)
    with torch.no_grad():
        shift = x.amax(dim=dims, keepdim=True)
    shifted = x - shift
    return shifted - torch.log(torch.exp(shifted).sum(dim=dims,
                                                      keepdim=keepdims))


def scaled_dot_product_attention(q, k, v, mask=None, causal: bool = False):
    """Attention over (B, L, H, d) operands, routed as in the JAX package:
    ``causal`` with no mask goes to :func:`ops.flash_attention.
    flash_attention_causal` (the K3/K4 kernels on a GPU); a mask with
    ``causal`` has the causal mask folded into it (the flash kernels take
    pure causal only, and dropping ``causal`` would let queries read the
    future); either way with a mask runs the plain composite."""
    if causal and mask is None:
        return fa.flash_attention_causal(q, k, v)
    if mask is not None:
        if causal:
            mask = mask + fa.causal_mask(q.shape[1], mask.dtype, mask.device)
        return fa.mha_reference(q, k, v, mask)
    return fa.mha_reference(q, k, v)


# ----------------------------- conv / pool -------------------------------
def conv1d(x, kernel, padding: int = 0, stride: int = 1):
    """1-D convolution, x (N, C, W), kernel (O, C, K) -> (N, O, W')."""
    return tF.conv1d(x, kernel, stride=stride, padding=padding)


def conv2d(x, kernel, padding: int = 0, stride: int = 1):
    """2-D convolution, x (N, C, H, W), kernel (O, C, K, K) ->
    (N, O, H', W')."""
    return tF.conv2d(x, kernel, stride=stride, padding=padding)


def _pad(x, padding, ndim_sp):
    """Zero-pad the spatial axes: a padded zero counts in an average and can
    win a max (PyTorch's own max-pool padding is -inf)."""
    return tF.pad(x, (padding, padding) * ndim_sp) if padding else x


def _max_pool(x, kernel_size, stride, padding, ndim_sp):
    """The max over each zero-padded window: ``amax`` of the unfolded
    windows, whose gradient is split evenly among a window's tied
    maxima."""
    x = _pad(x, padding, ndim_sp)
    for axis in range(2, 2 + ndim_sp):
        x = x.unfold(axis, kernel_size, stride)
    return x.amax(dim=tuple(range(-ndim_sp, 0)))


def max_pool1d(x, kernel_size: int, stride: int, padding: int = 0):
    return _max_pool(x, kernel_size, stride, padding, 1)


def avg_pool1d(x, kernel_size: int, stride: int, padding: int = 0):
    return tF.avg_pool1d(_pad(x, padding, 1), kernel_size, stride)


def max_pool2d(x, kernel_size: int, stride: int, padding: int = 0):
    return _max_pool(x, kernel_size, stride, padding, 2)


def avg_pool2d(x, kernel_size: int, stride: int, padding: int = 0):
    return tF.avg_pool2d(_pad(x, padding, 2), kernel_size, stride)


# -------------------------------- losses ---------------------------------
def _reduce(v: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    raise ValueError("reduction must be mean or sum.")


def mse_loss(y_pred, y_true, reduction: str = "mean"):
    return _reduce((y_pred - y_true) ** 2, reduction)


def nll_loss(y_pred, y_true, reduction: str = "mean"):
    """``-y_pred * y_true`` reduced over every element: y_pred holds
    log-probabilities and y_true one-hot (or soft) targets of its shape."""
    return _reduce(-y_pred * y_true, reduction)


def cross_entropy_loss(y_pred: torch.Tensor, y_true: torch.Tensor,
                       reduction: str = "mean") -> torch.Tensor:
    """Cross-entropy of (N, V) logits against class indices (N,) or
    per-class weights (N, V), with the JAX package's shift: the maximum over
    the WHOLE (N, V) array, taken without a gradient. This is not
    ``torch.nn.functional.cross_entropy``'s per-row shift: a row far below
    the global maximum can underflow here, and the port keeps that."""
    with torch.no_grad():
        shift = y_pred.max()
    shifted = y_pred - shift
    log_sum_exp = torch.log(torch.exp(shifted).sum(1, keepdim=True))
    neg_log_sm = log_sum_exp - shifted
    if y_true.dim() == 1:
        nll = neg_log_sm[torch.arange(neg_log_sm.shape[0],
                                      device=y_pred.device), y_true]
    else:
        nll = neg_log_sm * y_true
    return _reduce(nll, reduction)
