"""The parts of ``pydynet_tpu/nn/functional.py`` on the training path:
attention routing and the cross-entropy loss."""
from __future__ import annotations

import torch

from ..ops import flash_attention as fa


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


def _reduce(v: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    raise ValueError("reduction must be mean or sum.")


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
