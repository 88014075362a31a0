"""Continuous-batching serving over a ``(dp, tp)`` mesh (counterpart of
``pydynet_tpu/parallel/serve_spmd.py``).

The single-device server's slot protocol (``models/llama/serve.py``, whose
``_FleetScheduler`` does the host scheduling here too): all ``B`` slots
decode in lockstep at one shared position; a finished slot is recycled by
prefilling the next prompt at position 0 and writing its rows into the
slot's past cache rows ``[pos - len, pos)``, the K rows rotated on by
angle(pos - len) (rotary angles compose additively); the slot's attention
is lower-bounded at its admission row (``starts``).

On the mesh the slots' rows ride ``dp`` and every product is tp-sharded
(``llama_spmd``'s forward): each rank decodes its rows over its heads, and
the logits are gathered whole on every rank, which then all take the same
greedy or sampled tokens. An admission wave is prefilled on every dp rank
(tp-sharded), and the rank holding a slot writes its rows; a prefix-cache
admission (``prefix_cache=True``) takes the donor's rows from the dp rank
that holds them by a broadcast. ``quant="int8"``/``"int4"`` serves the
weight-only quantized parameters (``llama_spmd.quantize_params``) and
``kv_quant="int8"`` the (int8 rows, float32 scales) caches, composed with
each other and with the prefix cache.

Sampling is the single-device server's: each slot carries a threefry key
(``fold_in(PRNGKey(seed), slot)``), an admitted request's comes from its
``seed`` (``fold_in(PRNGKey(0x5EED), seed)``) or from the server's seed and
its id, split once a step, so a seeded request's stream depends only on its
prompt, parameters and seed.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import random as prandom
from ..models.llama.model import _rope_pure as _rope
from ..models.llama.model import sample_logits_per_row
from ..models.llama.serve import SEEDED_KEY, _FleetScheduler
from ..ops.decode_step import quantize_kv
from . import _comm as C
from .llama_spmd import (_Axis, _forward_tokens_local, _local_cache,
                         empty_caches, quantize_params, shard_params)
from .mesh import as_mesh, local


def params_from_model(model, dtype=torch.float32):
    """The ``llama_spmd`` parameter dict and cfg of a ``Llama`` module
    (unmerged LoRA adapters folded in, as every decode snapshot does): the
    per-matrix (in, out) layout, so each tp block is a whole block of
    heads."""
    g = model._snapshot_reader(dtype)

    def mat(name):
        return g(name).t().contiguous()

    def stack(fmt, f):
        return torch.stack([f(fmt.format(i)) for i in range(model.n_layers)])

    params = {
        "tok": g("tok_embedding.weight"),
        "cos": g("freqs_cos"),
        "sin": g("freqs_sin"),
        "norm": g("norm.weight"),
        "head_w": mat("lm_head.weight"),
        "head_b": g("lm_head.bias"),
        "wq": stack("layers.{}.attention.Q.weight", mat),
        "wk": stack("layers.{}.attention.K.weight", mat),
        "wv": stack("layers.{}.attention.V.weight", mat),
        "wo": stack("layers.{}.attention.O.weight", mat),
        "gate": stack("layers.{}.ffn.gate.weight", mat),
        "up": stack("layers.{}.ffn.up.weight", mat),
        "down": stack("layers.{}.ffn.down.weight", mat),
        "in_norm": stack("layers.{}.input_norm.weight", g),
        "post_norm": stack("layers.{}.post_attn_norm.weight", g),
    }
    cfg = dict(vocab_size=model.vocab_size, dim=model.embed_dim,
               n_heads=model.n_heads, ffn_dim=model.ffn_dim,
               n_layers=model.n_layers, max_seq_len=model.max_seq_len,
               n_kv_heads=model.n_kv_heads)
    return params, cfg


class _ServeFns:
    """The device half of :class:`SpmdLlamaServer`: admission waves, the
    prefix-cache admission and the decode chunks on this rank's blocks."""

    def __init__(self, params, mesh, cfg, batch: int, seed: int, kv_quant):
        self.mesh, self.cfg = mesh, cfg
        self.tp, self.dp = _Axis(mesh, "tp"), _Axis(mesh, "dp")
        self.W = {k: local(v) for k, v in params.items()}
        self.dev = self.W["tok"].device
        self.cdt = self.W["tok"].dtype  # caches take the params' type
        self.kvq = kv_quant is not None
        self.kv_quant = kv_quant
        self.Bl = batch // self.dp.size
        self.r0 = self.dp.index * self.Bl
        ck, cv = empty_caches(mesh, cfg, batch, self.cdt, kv_quant)
        self.ck, self.cv = _local_cache(ck), _local_cache(cv)
        self.base_key = prandom.PRNGKey(seed, self.dev)
        self.fixed_key = prandom.PRNGKey(SEEDED_KEY, self.dev)

    def derive_keys(self, seeds, has_seed, rids):
        """(draw keys, carried slot keys) of admitted requests: seeded ->
        ``fold_in(PRNGKey(0x5EED), seed)``, else ``fold_in(PRNGKey(server
        seed), rid)``, split once."""
        k_seed = prandom.fold_in(self.fixed_key,
                                 torch.as_tensor(seeds, device=self.dev))
        k_rid = prandom.fold_in(self.base_key,
                                torch.as_tensor(rids, device=self.dev))
        keys = torch.where(torch.as_tensor(has_seed, device=self.dev)[:, None],
                           k_seed, k_rid)
        ks = prandom.split(keys)
        return ks[:, 0], ks[:, 1]

    def _fresh(self, k):
        """Fresh local caches for an admission of ``k`` prompts."""
        N, S = self.cfg["n_layers"], self.cfg["max_seq_len"]
        shape = (N, k, S) + tuple(self.ck[0].shape[3:] if self.kvq
                                  else self.ck.shape[3:])
        if self.kvq:
            return tuple((torch.zeros(shape, dtype=torch.int8,
                                      device=self.dev),
                          torch.zeros(shape[:-1], device=self.dev))
                         for _ in range(2))
        return (torch.zeros(shape, dtype=self.cdt, device=self.dev),
                torch.zeros(shape, dtype=self.cdt, device=self.dev))

    def first_tokens(self, logits, draw_k, params, sample):
        if sample:
            return sample_logits_per_row(logits, draw_k, *params).to(
                torch.int32)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def rot(self, row):
        W = self.W
        return (W["cos"][row:row + 1].float(), W["sin"][row:row + 1].float())

    def k_rows(self, c, L):
        """Rows [0, L) of a transient K cache, float32 (int8 dequantized)."""
        if self.kvq:
            return c[0][:, :, :L].float() * c[1][:, :, :L, :, None]
        return c[:, :, :L].float()

    def scatter(self, slots, pos0, rows_k, rows_v):
        """Write admitted rows (N, k, L, ...) into the slots this rank
        holds at rows [pos0, pos0 + L): K rotated float32 rows, V as the
        transient cache holds them."""
        L = rows_k.shape[2]
        if self.kvq:
            rows_k = quantize_kv(rows_k)
        for i, slot in enumerate(slots):
            j = slot - self.r0
            if not 0 <= j < self.Bl:
                continue
            if self.kvq:
                for c, rows in ((self.ck, rows_k), (self.cv, rows_v)):
                    c[0][:, j, pos0:pos0 + L] = rows[0][:, i]
                    c[1][:, j, pos0:pos0 + L] = rows[1][:, i]
            else:
                self.ck[:, j, pos0:pos0 + L] = rows_k[:, i].to(self.cdt)
                self.cv[:, j, pos0:pos0 + L] = rows_v[:, i].to(self.cdt)

    def v_rows(self, c, L):
        if self.kvq:
            return c[0][:, :, :L], c[1][:, :, :L]
        return c[:, :, :L]

    def admit_many(self, prompts, pos0, slots, keys, params, sample):
        """Prefill k same-length prompts at position 0 in fresh caches,
        rotate their K rows by angle(pos0) and write them into their slots'
        rows [pos0, pos0 + L); returns the first tokens (k,) int32."""
        k, L = prompts.shape
        S = self.cfg["max_seq_len"]
        ck1, cv1 = self._fresh(k)
        win = min(S, 1 << (L - 1).bit_length())
        ids = torch.as_tensor(prompts, device=self.dev).long()
        logits = _forward_tokens_local(self.W, ck1, cv1, ids, 0, self.cfg,
                                       self.tp, win=win)
        tok1 = self.first_tokens(logits, keys, params, sample)
        self.scatter(slots, pos0, _rope(self.k_rows(ck1, L), *self.rot(pos0)),
                     self.v_rows(cv1, L))
        return tok1

    def _donor(self, c, slot, start, kb):
        """The donor slot's rows [start, start + kb) from the dp rank that
        holds them, on every rank."""
        owner, j = divmod(slot, self.Bl)
        rows = c[:, j:j + 1, start:start + kb].clone()
        if self.dp.size > 1:
            dist.broadcast(rows, dist.get_global_rank(self.dp.group, owner),
                           group=self.dp.group)
        return rows

    def admit_prefix(self, suffix, dslot, dstart, pos0, slot, kb, keys,
                     params, sample):
        """A prefix-cache admission: the donor's ``kb`` rows from
        ``dstart``, K un-rotated by angle(-dstart), seed a fresh cache; only
        the suffix runs the forward, at position ``kb``; rows [0, kb + Ls)
        are rotated by angle(pos0) and written into ``slot``."""
        S = self.cfg["max_seq_len"]
        Ls = suffix.shape[1]
        ck1, cv1 = self._fresh(1)
        cd, sd = self.rot(dstart)
        if self.kvq:
            d, s = (self._donor(x, dslot, dstart, kb) for x in self.ck)
            ck1[0][:, :, :kb], ck1[1][:, :, :kb] = quantize_kv(
                _rope(d.float() * s[..., None], cd, -sd))
            for c1, c in zip(cv1, self.cv):
                c1[:, :, :kb] = self._donor(c, dslot, dstart, kb)
        else:
            ck1[:, :, :kb] = _rope(self._donor(self.ck, dslot, dstart,
                                               kb).float(), cd,
                                   -sd).to(self.cdt)
            cv1[:, :, :kb] = self._donor(self.cv, dslot, dstart, kb)
        win = min(S, 1 << (kb + Ls - 1).bit_length())
        ids = torch.as_tensor(suffix, device=self.dev).long()
        logits = _forward_tokens_local(self.W, ck1, cv1, ids, kb, self.cfg,
                                       self.tp, win=win)
        tok1 = self.first_tokens(logits, keys, params, sample)
        L = kb + Ls
        self.scatter([slot], pos0, _rope(self.k_rows(ck1, L),
                                         *self.rot(pos0)),
                     self.v_rows(cv1, L))
        return tok1

    def decode(self, tok, pos, starts, n, win, keys=None, params=None):
        """``n`` lockstep steps of every slot from ``pos``: (n, B) int32
        tokens, the same on every rank (and the slots' keys, split once a
        step, when sampling)."""
        rows = slice(self.r0, self.r0 + self.Bl)
        st = starts[rows]
        toks = []
        for i in range(n):
            logits = _forward_tokens_local(
                self.W, self.ck, self.cv, tok[rows, None].long(), pos + i,
                self.cfg, self.tp, st, win)
            logits = C.gather(logits, 0, self.dp.group)
            if keys is None:
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                ks = prandom.split(keys)
                tok = sample_logits_per_row(logits, ks[:, 0],
                                            *params).to(torch.int32)
                keys = ks[:, 1]
            toks.append(tok)
        return torch.stack(toks), keys


def make_serve_fns(mesh, cfg, seed: int = 0, kv_quant=None, params=None,
                   batch_size: int = 8):
    """The device half of :class:`SpmdLlamaServer` for ``params`` (sharded
    by ``llama_spmd.shard_params``) and ``batch_size`` slots."""
    return _ServeFns(params, as_mesh(mesh), cfg, batch_size, seed, kv_quant)


class SpmdLlamaServer(_FleetScheduler):
    """Continuous-batching server over a ``(dp, tp)`` mesh, greedy or
    sampled, with weight-only ``quant=``, ``kv_quant="int8"`` and
    ``prefix_cache=True``.

    >>> mesh = make_mesh({"dp": 2, "tp": 4})
    >>> srv = SpmdLlamaServer(model, mesh, batch_size=8, quant="int8")
    >>> rid = srv.submit(prompt_ids, temperature=0.8, seed=7)
    >>> done = srv.run()

    Every rank builds the server and submits the same requests (the host
    scheduling is deterministic, so the ranks agree). Takes a ``Llama``
    (:func:`params_from_model`) or a ``(params, cfg)`` pair in the
    ``llama_spmd`` layout; the ``dp`` size must divide ``batch_size``.
    ``step`` admits what fits and decodes one chunk, synchronously."""

    def __init__(self, model_or_params, mesh, cfg=None,
                 batch_size: int = 8, chunk: int = 32, eos_id: int = 2,
                 dtype=torch.float32, temperature: float = 0.0,
                 top_k: int = None, top_p: float = None, seed: int = 0,
                 quant=None, prefix_cache: bool = False, kv_quant=None):
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unsupported kv_quant mode: {kv_quant!r}")
        mesh = as_mesh(mesh)
        if cfg is None:
            params, cfg = params_from_model(model_or_params, dtype)
        else:
            params = model_or_params
        if quant is not None:
            params = quantize_params(params, quant)
        dp = mesh.axis_size("dp")
        if batch_size % dp:
            raise ValueError(f"batch_size {batch_size} must be divisible "
                             f"by the dp axis ({dp})")
        self.mesh, self.cfg = mesh, cfg
        self.B, self.chunk, self.eos_id = batch_size, chunk, eos_id
        self.S = cfg["max_seq_len"]
        self._params = shard_params(params, mesh)
        self._fns = make_serve_fns(mesh, cfg, seed, kv_quant, self._params,
                                   batch_size)
        self._prefix_cache = bool(prefix_cache)
        self.prefix_hits = 0
        self.prefix_rows_reused = 0
        dev = self._fns.dev
        self._pkeys = prandom.fold_in(self._fns.base_key,
                                      torch.arange(batch_size, device=dev))
        self._tok = torch.ones(batch_size, dtype=torch.int32, device=dev)
        self._init_fleet_state()
        self._init_sampling_state(cfg["vocab_size"], temperature, top_k,
                                  top_p)

    def _vectors(self, idx=None):
        dev = self._fns.dev
        vs = (self._ptemp, self._ptopk, self._ptopp)
        if idx is not None:
            vs = tuple(v[idx] for v in vs)
        return tuple(torch.as_tensor(v, device=dev) for v in vs)

    def _try_admit(self):
        plan = self._plan_admissions()
        if not plan:
            return
        by_len, reuse = {}, []
        planned = {s for s, _ in plan}
        samples = {}
        for slot, req in plan:
            samples[slot] = self._slot_params(slot, req)
            donor = self._find_donor(req.prompt, slot, planned) \
                if self._prefix_cache else None
            if donor is not None:
                reuse.append((slot, req, donor))
            else:
                by_len.setdefault(len(req.prompt), []).append((slot, req))
        fns = self._fns
        waves, firsts = [], []
        for L, group in sorted(by_len.items()):
            pos0 = self._pos - L
            for sub in self._pow2_subwaves(group):
                prompts, slots, seeds, has_seed, rids = \
                    self._wave_arrays(sub)
                draw, carry = fns.derive_keys(seeds, has_seed, rids)
                tok1 = fns.admit_many(prompts, pos0, slots, draw,
                                      self._vectors(slots),
                                      any(samples[s] for s in slots))
                idx = torch.as_tensor(slots, device=fns.dev)
                self._tok[idx] = tok1
                self._pkeys[idx] = carry
                for s, r in sub:
                    self._starts[s] = pos0
                    if self._prefix_cache:
                        self._resident[s] = (r.rid, tuple(r.prompt), pos0)
                waves.append(sub)
                firsts.append(tok1)
        for slot, req, (dslot, dstart, kb) in reuse:
            pos0 = self._pos - len(req.prompt)
            _, _, seeds, has_seed, rids = self._wave_arrays([(slot, req)])
            draw, carry = fns.derive_keys(seeds, has_seed, rids)
            tok1 = fns.admit_prefix(np.array([req.prompt[kb:]], np.int64),
                                    dslot, dstart, pos0, slot, kb, draw,
                                    self._vectors([slot]), samples[slot])
            self._tok[slot] = tok1[0]
            self._pkeys[slot] = carry[0]
            self._starts[slot] = pos0
            self._resident[slot] = (req.rid, tuple(req.prompt), pos0)
            self.prefix_hits += 1
            self.prefix_rows_reused += kb
            waves.append([(slot, req)])
            firsts.append(tok1)
        self._credit_firsts(waves, firsts)

    @torch.no_grad()
    def step(self, n: int = None):
        """Admit what fits, decode ``n`` (default ``chunk``) lockstep
        tokens, credit them; returns the requests that finished."""
        before = set(self._finished)
        self._try_admit()
        if self.active:
            navail = self.S - self._pos
            if navail <= 0:
                self._truncate_fleet()
            else:
                n = n or self.chunk
                win = min(self.S, 1 << (self._pos + n - 1).bit_length())
                starts = torch.as_tensor(self._starts, device=self._fns.dev)
                sampled = any(self._ptemp[i] > 0 for i in range(self.B)
                              if self._slots[i] is not None)
                toks, keys = self._fns.decode(
                    self._tok, self._pos, starts, n, win,
                    self._pkeys if sampled else None,
                    self._vectors() if sampled else None)
                if sampled:
                    self._pkeys = keys
                self._tok = toks[-1].clone()
                valid = min(n, navail)
                self._pos += valid
                toks = toks[:valid].cpu().numpy()
                for slot in range(self.B):
                    req = self._slots[slot]
                    if req is None:
                        continue
                    for t in toks[:, slot]:
                        req.tokens.append(int(t))
                        if req.tokens[-1] == self.eos_id \
                                or len(req.tokens) >= req.max_new_tokens:
                            break
                    self._maybe_finish(slot)
                    if self._prefix_cache:
                        self._grow_resident(slot, req)
        return [self._finished[r] for r in set(self._finished) - before]

    def run(self, max_steps: int = 10_000):
        """Drain the queue; returns {rid: Request}."""
        for _ in range(max_steps):
            if not self._queue and self.active == 0:
                break
            self.step()
        return dict(self._finished)
