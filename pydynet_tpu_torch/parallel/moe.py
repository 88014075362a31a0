"""Expert parallelism (``ep``): a switch-style top-1 MoE FFN (counterpart of
``pydynet_tpu/parallel/moe.py``).

Routing is the JAX package's exactly: each token goes to its argmax expert
(ties to the lowest index), takes the exclusive-cumsum position among that
expert's tokens, is dropped past the capacity ``C``, and is scaled by its
router probability; the switch auxiliary loss balances the load. Dispatch
and combine are dense one-hot einsums over (tokens, experts, capacity).

The expert weights carry a leading expert axis sharded over ``ep``. DTensor
has no sharding rule for these einsums, so the exchange is written out: the
tokens are split over the ``ep`` ranks, each rank builds the (E, C, D)
capacity slabs of its tokens, an all-to-all (``_comm.all_to_all``, its own
transpose) sends every expert's slab to the rank that holds the expert,
which sums them (each capacity slot holds one token) and runs its experts;
a second all-to-all brings every expert's outputs back to each rank, which
combines its own tokens, and an all-gather returns the (T, D) output to
every rank.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import _comm as C
from .mesh import local, mesh_of, shard


def init_moe_params(rng: np.random.RandomState, n_experts: int, dim: int,
                    ffn_dim: int, dtype=torch.float32):
    """{"wg" router (D, E); "w1" (E, D, F); "w2" (E, F, D)}, drawn in the
    JAX package's order, as host tensors."""
    s = 0.05

    def w(*shape):
        return torch.as_tensor(rng.standard_normal(shape) * s).to(dtype)

    return {"wg": w(dim, n_experts), "w1": w(n_experts, dim, ffn_dim),
            "w2": w(n_experts, ffn_dim, dim)}


def shard_moe_params(params, mesh):
    """Experts over ``ep``; the router replicated."""
    return {"wg": shard(params["wg"], mesh),
            "w1": shard(params["w1"], mesh, "ep", None, None),
            "w2": shard(params["w2"], mesh, "ep", None, None)}


def capacity(n_tokens: int, n_experts: int,
             capacity_factor: float = 2.0) -> int:
    return max(1, int(math.ceil(n_tokens / n_experts * capacity_factor)))


def _routing(gates, C_):
    """(onehot (T, E), pos (T,), keep (T,)) from the router's (T, E)."""
    E = gates.shape[1]
    eidx = torch.argmax(gates, dim=-1)
    onehot = torch.nn.functional.one_hot(eidx, E).float()
    pos_in_e = torch.cumsum(onehot, dim=0) - onehot
    pos = (pos_in_e * onehot).sum(-1).to(torch.int64)
    return eidx, onehot, pos, (pos < C_).float()


def _decisions(params, x, capacity_factor: float = 2.0):
    """:func:`moe_ffn`'s dispatch of tokens ``x`` (T, D): ``(expert (T,),
    position (T,), kept (T,) bool)``, for the tests."""
    wg = local(params["wg"])
    x = torch.as_tensor(x, device=wg.device)
    T, E = x.shape[0], wg.shape[1]
    gates = torch.softmax((x @ wg).float(), dim=-1)
    eidx, _, pos, keep = _routing(gates, capacity(T, E, capacity_factor))
    return eidx, pos, keep.bool()


def moe_ffn(params, x, capacity_factor: float = 2.0):
    """Top-1 switch FFN over tokens ``x`` (T, D) -> ``(out (T, D), aux)``,
    the same on every rank; a dropped token's output is 0 (callers add the
    residual). ``params`` from :func:`shard_moe_params` (or plain tensors on
    one device); ``x`` the global tokens."""
    mesh = mesh_of(params)
    wg, w1, w2 = (local(params[k]) for k in ("wg", "w1", "w2"))
    x = torch.as_tensor(x, device=wg.device)
    T, D = x.shape
    E = wg.shape[1]
    C_ = capacity(T, E, capacity_factor)
    ep = None if mesh is None else mesh.group("ep")
    n = 1 if mesh is None else mesh.axis_size("ep")
    r = 0 if mesh is None else mesh.axis_index("ep")
    if E % n:
        raise ValueError(f"{E} experts do not split over ep={n}")

    gates = torch.softmax((x @ wg).float(), dim=-1)          # (T, E)
    eidx, onehot, pos, keep = _routing(gates, C_)
    gate = torch.take_along_dim(gates, eidx[:, None], 1)[:, 0]

    # this rank's tokens (their gradients gathered back whole)
    lo, hi = (T * r) // n, (T * (r + 1)) // n
    if n > 1:
        xs = _split_rows(x, lo, hi, ep)
        gs = _split_rows(gate, lo, hi, ep)
    else:
        xs, gs = x, gate
    sl = slice(lo, hi)
    dispatch = (onehot[sl] * keep[sl, None])[:, :, None] \
        * torch.nn.functional.one_hot(pos[sl].clamp(max=C_ - 1),
                                      C_).float()[:, None, :]
    slabs = torch.einsum("tec,td->ecd", dispatch, xs.float())  # (E, C, D)
    # every expert's slab to its rank, summed there over the source ranks
    mine = C.all_to_all(slabs, ep).reshape(n, E // n, C_, D).sum(0)
    h = torch.einsum("ecd,edf->ecf", mine, w1.float())
    h = h * torch.sigmoid(h)
    y = torch.einsum("ecf,efd->ecd", h, w2.float())          # (E/n, C, D)
    # every expert's outputs back to every rank
    expert_out = C.all_to_all(y.repeat(n, 1, 1), ep).reshape(E, C_, D)
    combine = dispatch * gs[:, None, None]
    out = torch.einsum("tec,ecd->td", combine, expert_out)
    if n > 1:
        out = _gather_rows(out, T, n, ep)

    frac = onehot.mean(0)
    prob = gates.mean(0)
    aux = E * (frac * prob).sum()
    return out.to(x.dtype), aux


class _SplitRows(torch.autograd.Function):
    """Rows [lo, hi) of a replicated tensor; backward: every rank's row
    gradients gathered, so the replicated input gets the whole gradient."""

    @staticmethod
    def forward(ctx, x, lo, hi, group):
        ctx.shape, ctx.lo, ctx.hi, ctx.group = x.shape, lo, hi, group
        return x[lo:hi].clone()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full[ctx.lo:ctx.hi] = g
        return C._all_reduce(full, ctx.group), None, None, None


def _split_rows(x, lo, hi, group):
    return _SplitRows.apply(x, lo, hi, group)


class _GatherRows(torch.autograd.Function):
    """Every rank's rows into the whole (T, ...) tensor; backward: this
    rank's rows (the whole tensor is read replicated)."""

    @staticmethod
    def forward(ctx, x, T, n, group):
        import torch.distributed as dist

        r = dist.get_rank(group)
        ctx.lo, ctx.hi = (T * r) // n, (T * (r + 1)) // n
        full = x.new_zeros((T,) + tuple(x.shape[1:]))
        full[ctx.lo:ctx.hi] = x
        return C._all_reduce(full, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.lo:ctx.hi], None, None, None


def _gather_rows(x, T, n, group):
    return _GatherRows.apply(x, T, n, group)


def moe_ffn_reference(params, x, capacity_factor: float = 2.0):
    """Per-token NumPy mirror of :func:`moe_ffn` (tests)."""
    x = np.asarray(x, np.float32)
    wg = np.asarray(params["wg"], np.float32)
    w1 = np.asarray(params["w1"], np.float32)
    w2 = np.asarray(params["w2"], np.float32)
    T, D = x.shape
    E = wg.shape[1]
    C_ = capacity(T, E, capacity_factor)

    logits = x @ wg
    g = np.exp(logits - logits.max(-1, keepdims=True))
    g /= g.sum(-1, keepdims=True)
    out = np.zeros_like(x)
    used = np.zeros(E, np.int64)
    for t in range(T):
        e = int(np.argmax(g[t]))
        if used[e] >= C_:
            used[e] += 1  # over capacity: dropped (residual only)
            continue
        used[e] += 1
        h = x[t] @ w1[e]
        h = h * (1.0 / (1.0 + np.exp(-h)))  # silu
        out[t] = (h @ w2[e]) * g[t, e]
    return out
