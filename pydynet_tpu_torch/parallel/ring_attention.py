"""Ring attention: exact attention over a sequence sharded on a mesh axis
(counterpart of ``pydynet_tpu/parallel/ring_attention.py``).

Each rank keeps its block of queries and the K/V blocks rotate around the
``sp`` ring (``_comm.shift``, whose backward is the reverse shift), while a
running softmax accumulates in float32: the block maximum ``m``, the
denominator ``l`` and the weighted sum. Attention over n x L_local tokens
takes O(L_local) memory a rank.

Causality is set by block index: at ring step s rank i holds K/V block
j = (i - s) mod n, fully visible when j < i, causal within the block when
j == i, fully masked when j > i.
"""
from __future__ import annotations

import math

import torch

from . import _comm as C
from .mesh import as_mesh


def _local_ring(q, k, v, group, n, idx, causal: bool, scale: float):
    """This rank's block: q/k/v (B, Lloc, H, d) -> (B, Lloc, H, d)."""
    B, Lloc, H, d = q.shape
    qf = q.float() * scale
    m = torch.full((B, H, Lloc, 1), float("-inf"), device=q.device)
    l = torch.zeros((B, H, Lloc, 1), device=q.device)
    acc = torch.zeros((B, H, Lloc, d), device=q.device)
    r = torch.arange(Lloc, device=q.device)
    tri = r[:, None] >= r[None, :]
    kb, vb = k, v
    for s in range(n):
        j = (idx - s) % n
        sblk = torch.einsum("blhd,bmhd->bhlm", qf, kb.float())
        if causal and j >= idx:  # j < idx: fully visible
            visible = tri if j == idx else torch.zeros_like(tri)
            sblk = sblk.masked_fill(~visible, float("-inf"))
        m_new = torch.maximum(m, sblk.amax(-1, keepdim=True))
        # a fully masked row keeps m = -inf: guard the shift
        shift = torch.where(torch.isinf(m_new), torch.zeros_like(m_new),
                            m_new)
        p = torch.exp(sblk - shift)
        p = torch.where(torch.isinf(sblk), torch.zeros_like(p), p)
        alpha = torch.where(torch.isinf(m), torch.zeros_like(m),
                            torch.exp(m - shift))
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhlm,bmhd->bhld", p, vb.float())
        m = m_new
        if s < n - 1:  # no full-circle rotation whose blocks go unread
            kb, vb = C.shift(kb, group), C.shift(vb, group)
    out = acc / torch.clamp(l, min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def ring_attention(q, k, v, mesh, axis_name: str = "sp",
                   causal: bool = True, scale: float = None):
    """Exact attention over (B, L, H, d) inputs sequence-sharded on
    ``axis_name``. DTensor inputs (sharded on dim 1) give a DTensor output
    with the same sharding; plain tensors are the global arrays, the same on
    every rank, and the output is the global (B, L, H, d) on every rank,
    their gradients included."""
    from torch.distributed.tensor import DTensor

    mesh = as_mesh(mesh)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    group = mesh.group(axis_name)
    n, idx = mesh.axis_size(axis_name), mesh.axis_index(axis_name)
    if isinstance(q, DTensor):
        spec = q.placements
        out = _local_ring(q.to_local(), k.to_local(), v.to_local(), group, n,
                          idx, causal, scale)
        return DTensor.from_local(out, q.device_mesh, spec, run_check=False,
                                  shape=q.shape, stride=q.stride())
    ql, kl, vl = (C.split(x, 1, group) for x in (q, k, v))
    return C.gather(_local_ring(ql, kl, vl, group, n, idx, causal, scale), 1,
                    group)
