"""Continuous-batching decode server over the batched decode kernel: the
port of ``pydynet_tpu/models/llama/serve.py`` (its fused and scan lanes).

``B`` cache slots decode in lockstep at ONE shared position, one batched
kernel step (``ops.decode_step.fused_decode_token_batched``) per fleet token,
and a finished slot is recycled for the next queued request without
touching the other slots:

* the new prompt is prefilled at position 0 in a fresh cache, and its rows
  are written into the slot's PAST cache rows ``[pos - len, pos)``, the K
  rows rotated on by the shift to their absolute positions, overwriting the
  previous request's stale keys and values;
* the slot's attention is lower-bounded at its admission row by the
  kernel's per-row ``starts``, so stale rows below it are invisible;
* rotary attention scores depend only on relative distance, so a request
  decoded at shifted absolute positions emits the tokens it would from
  position 0 (up to float rounding of the rotary tables).

Scheduling rules that fall out of the shared position:

* admission needs ``len(prompt) <= pos`` (the prompt lands in past rows),
  except on an idle server, where ``pos`` jumps to the prompt length;
* the server stops admitting at the cache end; requests still decoding at
  ``max_seq_len`` are finished as truncated.

The scan lane (``lane="xla"``, the JAX package's XLA ``lax.scan`` lane for
big dims) keeps the same protocol over the scan lane's forward
(``Llama.forward_logits_one`` with per-row ``starts``) and (N, B, S, Hkv,
hd) caches: an admission wave is prefilled at position 0 in a fresh cache,
its K rows are rotated by angle(pos0) in float32 and scattered into the
fleet's caches at rows [pos0, pos0 + L); ``quant="int8"``/``"int4"`` (and
``"int8-head"``) run its matmuls through ``ops.gemv_quant``. ``lane=None``
routes as ``generate`` does (``Llama.use_fused``): the fused lane where the
port's batched kernel takes the model, format and batch, the scan lane
where the JAX package's rule sends the model there (Llama-2-7B geometry
with int8 or int4 weights).

On the fused lane ``quant="int8"``/``"int4"`` run the batched kernel's
quantized layers, and ``kv_quant="int8"`` keeps the fleet's caches as int8
rows with per-row float32 scales: an admission wave's rows are quantized by
``quantize_kv``, K from its float32 rotated rows, as the kernel quantizes
the rows it writes, so admitted and decoded rows are alike. A grouped-query
model's fleet keeps the kernel's narrow (N, B, S, Hkv * hd) caches, with
float weights, the int8 head or the int8 KV cache; its K rows are rotated
by the first Hkv * hd columns of the (S, D) tables. With int8/int4 layers
it keeps the expanded (N, B, S, D) layout, as ``generate`` does. Any
``batch_size`` runs: the batched kernel takes its rows in groups of 32.

Sampling, server-wide (``temperature``, ``top_k``, ``top_p``) or per
request (``submit(..., temperature=, top_k=, top_p=, seed=)``), is the JAX
package's: every slot carries its own threefry key, made at admission from
the request's ``seed`` (``fold_in(PRNGKey(0x5EED), seed)``) or, unseeded,
from the server's ``seed`` and the request id, and split once a step; each
row draws with its own key (``sample_logits_per_row``), so a seeded
request's tokens depend only on its prompt, parameters and seed, not on the
fleet it joined. The admission's first token is drawn too. A chunk runs the
kernel's ``emit_logits`` mode and the sampling stage only when an active
slot samples; a fleet of greedy rows keeps the kernel's argmax mode, on a
sampling server too. Rows whose temperature is 0 take the exact argmax.

On the scan lane ``kv_quant="int8"`` keeps the fleet's caches as (int8
rows, (N, B, S, Hkv) float32 scales) pairs, with any weight ``quant``: an
admission wave is prefilled on such a pair, so it attends its quantized
rows, as standalone ``generate(kv_quant="int8", fused=False)`` does; its K
rows are dequantized, rotated by angle(pos0) in float32 and requantized,
its V rows and scales scattered as they are.

``prefix_cache=True`` (scan lane only) reuses a resident slot's KV rows for
a request that shares a prompt prefix with it (the JAX package's
``admit_prefix_xla``): the longest common prefix with the token sequence
whose rows a slot holds, rounded down to a power of two, at least
``_MIN_PREFIX`` rows and leaving one suffix token, is copied from the donor
slot, its K rows un-rotated by the donor's admission row and rotated on by
the new one (RoPE composes additively), and only the suffix runs the
prefill forward. A slot's residency grows with the tokens it decodes (a
multi-turn follow-up reuses the reply too) and dies when the slot is
re-admitted, the shared position rewinds or the weights change.
``prefix_hits`` and ``prefix_rows_reused`` count the reuse admissions and
the prefill rows they skipped.

``LlamaServer(model, speculative=K)`` builds the speculative server of
``serve_spec.py`` instead (routed on the keyword, as in the JAX package):
per-slot positions, greedy, on the scan lane's forward.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ... import random as prandom
from ...ops import decode_step as dsk
from .model import (_rope_pure, bucket_prompt, check_dtype, check_kv_quant,
                    flash_prefill_mode, sample_logits_per_row)

# seeded requests derive their keys from this fixed key, not the server's,
# so a (prompt, parameters, seed) triple gives the same stream on any server
SEEDED_KEY = 0x5EED


@dataclass
class Request:
    rid: int
    prompt: list
    max_new_tokens: int
    tokens: list = field(default_factory=list)  # generated ids
    done: bool = False
    truncated: bool = False
    # per-request sampling overrides (None: the server's defaults)
    temperature: float = None
    top_k: int = None
    top_p: float = None
    seed: int = None  # None: derived from the server's seed and the rid


class _FleetScheduler:
    """Host-side slot protocol of the server: queueing, admission planning
    (with the idle position rewind), power-of-two admission-wave splitting,
    finish rules (EOS pop, ``max_new_tokens``, truncation) and fleet
    truncation. Subclasses provide the device programs and the chunk loop.
    """

    # the shortest prefix the prefix cache reuses (rows, a power of two)
    _MIN_PREFIX = 8

    def _init_fleet_state(self):
        self._starts = np.zeros(self.B, np.int32)
        self._pos = 0
        self._slots: list = [None] * self.B
        self._queue: deque = deque()
        self._rid = itertools.count()
        self._finished: dict = {}
        self._admit_credits: list = []  # (rid, [first_token]) for stream()
        # prefix-cache residency: slot -> (rid, the tokens whose KV rows the
        # slot holds, its admission row), the donors of later admissions;
        # it outlives the request and dies at the slot's next admission
        self._resident: list = [None] * self.B

    def _on_rewind(self):
        """A reset of the shared position: every donor dies, since decode
        steps rewrite the rows above the new position."""
        self._resident = [None] * self.B

    def _init_sampling_state(self, V, temperature, top_k, top_p):
        """The server's default sampling parameters and the per-slot
        vectors of the parameters in force (a row with temperature <= 0 is
        greedy, ``top_k = V`` and ``top_p = 1`` keep every token)."""
        self._temp = float(temperature or 0.0)
        self._top_k, self._top_p = top_k, top_p
        self._V = V
        self._ptemp = np.full(self.B, self._temp, np.float32)
        self._ptopk = np.full(self.B, top_k if top_k is not None else V,
                              np.int32)
        self._ptopp = np.full(self.B, top_p if top_p is not None else 1.0,
                              np.float32)

    def submit(self, prompt_ids, max_new_tokens: int = 256,
               temperature: float = None, top_k: int = None,
               top_p: float = None, seed: int = None) -> int:
        """Queue one prompt (list or array of token ids); returns its
        request id. ``max_new_tokens`` counts the generated tokens, the
        admission token included. ``temperature``/``top_k``/``top_p``
        override the server's defaults for this request; ``seed`` (an
        int32) pins its key stream, so its sampled tokens depend only on
        its prompt, parameters and seed."""
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not 0 < len(prompt) < self.S:
            raise ValueError(f"prompt length {len(prompt)} outside "
                             f"[1, {self.S - 1}]")
        if temperature is not None and temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k is not None and not 0 < top_k:
            raise ValueError(f"top_k must be positive, got {top_k}")
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if seed is not None and not -2**31 <= int(seed) < 2**31:
            # the admission wave carries the seeds as int32: fail here, not
            # mid-serving after the slot was assigned
            raise ValueError(f"seed must fit int32, got {seed}")
        rid = next(self._rid)
        self._queue.append(Request(rid, prompt, int(max_new_tokens),
                                   temperature=temperature, top_k=top_k,
                                   top_p=top_p, seed=seed))
        return rid

    def _slot_params(self, slot, req) -> bool:
        """Put a request's sampling parameters in force in its slot's
        vectors; True when the row samples."""
        t = self._temp if req.temperature is None else float(req.temperature)
        k = self._top_k if req.top_k is None else req.top_k
        p = self._top_p if req.top_p is None else req.top_p
        self._ptemp[slot] = t
        self._ptopk[slot] = k if k is not None else self._V
        self._ptopp[slot] = p if p is not None else 1.0
        return t > 0

    @property
    def active(self) -> int:
        return sum(1 for r in self._slots if r is not None)

    def _plan_admissions(self):
        """Assign queued requests to free slots under the admission rule
        (module doc): the prompt must land in past rows, except on an
        idle server, where the position rewinds to the prompt length."""
        plan = []
        for slot in range(self.B):
            if self._slots[slot] is not None or not self._queue:
                continue
            req = self._queue[0]
            L = len(req.prompt)
            if self.active == 0 and not plan:
                # idle server: reset the shared position to the prompt
                # length so the request gets the whole cache as headroom
                # (stale rows are invisible: below the admission row
                # ``starts`` masks them, above the decode position the
                # kernel's position bound hides them until rewritten)
                self._pos = L
                self._on_rewind()
            if L > self._pos or self._pos >= self.S:
                continue  # must land in past rows (see module doc)
            self._queue.popleft()
            self._slots[slot] = req
            plan.append((slot, req))
        return plan

    @staticmethod
    def _wave_arrays(sub):
        """One admission sub-wave's host arrays: (prompts (k, L), slots,
        seeds int32 (0 when unseeded), has_seed, rids)."""
        return (np.array([r.prompt for _, r in sub], np.int64),
                [s for s, _ in sub],
                np.array([r.seed or 0 for _, r in sub], np.int32),
                np.array([r.seed is not None for _, r in sub]),
                np.array([r.rid for _, r in sub], np.int32))

    @staticmethod
    def _pow2_subwaves(group):
        """Split one same-length admission group into power-of-two
        sub-batches, which bounds the prefill shapes to (L, 2^i)."""
        i = 0
        while i < len(group):
            k = 1 << ((len(group) - i).bit_length() - 1)
            yield group[i:i + k]
            i += k

    def _find_donor(self, prompt, target_slot, planned_slots):
        """The best ``(slot, start_row, kb)`` donor for ``prompt``: the
        resident entry sharing the longest common prefix, rounded down to a
        power of two, of at least ``_MIN_PREFIX`` rows and leaving at least
        one suffix token (the first token's logits come from the suffix
        forward); None without one. A slot re-admitted in this wave donates
        only to itself: its rows are read before they are overwritten."""
        best = None
        limit = len(prompt) - 1
        for slot, ent in enumerate(self._resident):
            if ent is None or (slot in planned_slots
                               and slot != target_slot):
                continue
            _, rp, start = ent
            n = 0
            for a, b in zip(rp, prompt[:limit]):
                if a != b:
                    break
                n += 1
            if n < self._MIN_PREFIX:
                continue
            kb = 1 << (n.bit_length() - 1)
            if best is None or kb > best[2]:
                best = (slot, start, kb)
        return best

    def _grow_resident(self, slot, req):
        """Grow a slot's residency by its request's credited tokens, all
        but the last, whose row is written only when the next step reads it
        (the multi-turn reuse)."""
        ent = self._resident[slot]
        if ent is not None and ent[0] == req.rid:
            self._resident[slot] = (req.rid, tuple(req.prompt)
                                    + tuple(req.tokens[:-1]), ent[2])

    def _credit_firsts(self, waves, firsts_dev):
        """One host read back for every admission wave's first tokens,
        credited to their requests in dispatch order."""
        firsts = torch.cat(firsts_dev).cpu().tolist()
        j = 0
        for sub in waves:
            for slot, req in sub:
                req.tokens.append(firsts[j])
                j += 1
                self._maybe_finish(slot)
                if req.tokens:  # EOS as the first token was popped
                    self._admit_credits.append((req.rid, [req.tokens[-1]]))

    def _maybe_finish(self, slot, truncated=False):
        req = self._slots[slot]
        if req is None:
            return
        if req.tokens and req.tokens[-1] == self.eos_id:
            req.tokens.pop()  # EOS itself is not emitted
            req.done = True
        elif len(req.tokens) >= req.max_new_tokens or truncated:
            req.done = True
            req.truncated = truncated
        if req.done:
            self._finished[req.rid] = req
            self._slots[slot] = None

    def _truncate_fleet(self):
        for slot in range(self.B):
            self._maybe_finish(slot, truncated=True)
        if self.active == 0:
            self._pos = 0  # fleet drained: rewind for the queue
            self._on_rewind()


class LlamaServer(_FleetScheduler):
    """Continuous-batching decode for one Llama model, greedy or sampled.

    >>> srv = LlamaServer(model, batch_size=8, dtype=torch.bfloat16)
    >>> rid = srv.submit(tokenizer.encode(prompt))
    >>> done = srv.run()           # {rid: Request}

    ``quant="int8-head"`` stores the lm_head as int8 with per-row scales
    (the batched kernel quantises each row's activations with its own
    scale); ``"int8"`` and ``"int4"`` quantize every matmul, on either
    lane. ``kv_quant="int8"`` keeps the fleet's caches int8 (module doc);
    on the fused lane it takes float weights (a ``quant`` raises
    ``ValueError``, as in the JAX package), the scan lane composes it with
    any ``quant``. ``prefix_cache=True`` reuses resident KV rows for a
    shared prompt prefix on the scan lane (module doc; a ``ValueError`` on
    the fused lane, as in the JAX package), counted in ``prefix_hits`` and
    ``prefix_rows_reused``. ``temperature`` (0: greedy), ``top_k`` and
    ``top_p``
    are the requests' default sampling parameters, which ``submit`` may
    override; ``seed`` keys the unseeded requests' streams (module doc).
    ``lane`` is ``"fused"``, ``"xla"`` (the scan lane) or
    None (routed as ``generate`` routes, see the module doc).
    ``flash_prefill`` routes each admission wave's prefill attention as
    ``generate``'s does, ``None`` by the wave's prompt length
    (``flash_prefill_mode``). ``chunk`` is
    the number of decode steps a dispatch runs: a finished request's slot
    is recycled at the next chunk boundary, one chunk late under ``run``'s
    pipeline. The constructor keeps the JAX package's keyword names;
    ``speculative=K`` builds a ``serve_spec.SpecLlamaServer`` instead.
    ``dispatched_steps`` counts the decode steps dispatched so far, clamped
    filler steps included, and ``sampled_steps`` those of them in sampled
    chunks.
    """

    def __new__(cls, *args, **kwargs):
        # the speculative engine is a different fleet protocol (per-slot
        # positions) on the same scheduler base; Python skips this class's
        # __init__ on the instance it returns
        if cls is LlamaServer and kwargs.get("speculative"):
            from .serve_spec import SpecLlamaServer
            return SpecLlamaServer(*args, **kwargs)
        return super().__new__(cls)

    def __init__(self, model, batch_size: int = 8, dtype=None,
                 chunk: int = 128, eos_id: int = 2, temperature: float = 0.0,
                 top_k: int = None, top_p: float = None, seed: int = 0,
                 kv_quant=None, quant=None, lane: str = None,
                 prefix_cache: bool = False, flash_prefill=None,
                 speculative=None):
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unsupported kv_quant mode: {kv_quant!r}")
        if lane not in (None, "fused", "xla"):
            raise ValueError(f"unknown lane: {lane!r}")
        check_dtype(dtype)
        fused = model.use_fused(quant, batch_size,
                                None if lane is None else lane == "fused",
                                batched=True)
        if prefix_cache and fused:
            raise ValueError("prefix_cache runs on the scan lane "
                             "(lane='xla'): the fused lane's cache layout "
                             "has no row-reuse path")
        check_kv_quant(kv_quant, quant, fused)
        self._lane = "fused" if fused else "xla"
        self._kv_quant = kv_quant
        self._prefix_cache = bool(prefix_cache)
        self.prefix_hits = 0  # reuse admissions served
        self.prefix_rows_reused = 0  # prefill rows they skipped
        # admission prefill's attention (generate's flash_prefill): None
        # routes each wave by its prompt length (flash_prefill_mode), False
        # keeps the dense scores, True (or "interpret") takes the flash
        # forward
        self._flash_prefill = flash_prefill
        model.eval()
        self.model = model
        self.B = batch_size
        self.chunk = chunk
        self.eos_id = eos_id
        self._dtype = dtype
        self._quant = quant
        self._refresh_weights()
        N, S = model.n_layers, model.max_seq_len
        # the fused lane's cache width (JAX: serve.py:422-427): a
        # grouped-query model's narrow Hkv * hd, else D (MHA, or the
        # expanded layout of int8/int4 layers)
        W = (model.n_kv_heads * model.head_dim if "n_kv_heads" in self._w
             else model.embed_dim)
        self.S = S
        dev, cdt = model.device, self._w["tok"].dtype
        self._cdt = cdt
        if not fused:  # the scan lane's (N, B, S, Hkv, hd) layout, or pairs
            self._ck, self._cv = model._empty_caches(self.B, cdt, kv_quant)
        elif kv_quant:  # int8 rows and their scales, floored as quantize_kv's
            self._ck, self._cv = (
                (torch.zeros(N, self.B, S, W, dtype=torch.int8, device=dev),
                 torch.full((N, self.B, S), 1e-10, device=dev))
                for _ in range(2))
        else:
            self._ck = torch.zeros(N, self.B, S, W, dtype=cdt, device=dev)
            self._cv = torch.zeros(N, self.B, S, W, dtype=cdt, device=dev)
        self._tok = torch.ones(self.B, dtype=torch.int32, device=dev)
        # the decode steps' copies of _starts and of the per-slot sampling
        # vectors, written at admission only, so a decode dispatch copies
        # nothing from the host
        self._starts_dev = torch.zeros(self.B, dtype=torch.int32, device=dev)
        self._init_fleet_state()
        self._init_sampling_state(model.vocab_size, temperature, top_k, top_p)
        self._params_dev = [torch.from_numpy(v).to(dev) for v in
                            (self._ptemp, self._ptopk, self._ptopp)]
        # per-slot keys on the device: fold_in(PRNGKey(seed), slot), then at
        # admission the request's own (derive_keys), split once a step
        self._base_key = prandom.PRNGKey(seed, dev)
        self._fixed_key = prandom.PRNGKey(SEEDED_KEY, dev)
        self._pkeys = prandom.fold_in(
            self._base_key, torch.arange(self.B, device=dev))
        self.dispatched_steps = self.sampled_steps = 0

    # ------------------------------ device ------------------------------ #
    def _refresh_weights(self):
        """The decode weights of the model as it is now: the snapshot
        ``generate`` uses on this lane (same cache key), which the model
        drops when its weights change, so requests mid-decode continue on
        the new weights from their next chunk. A new snapshot kills the
        prefix cache's donors: their rows were computed under the old
        weights."""
        m = self.model
        if self._lane == "fused":
            w = m._fused_weights(self._dtype, self._quant)
        elif self._quant:
            w = m._weights_xq(self._dtype, self._quant)
        else:
            w = m._weights(self._dtype)
        if w is not getattr(self, "_w", None) and self._prefix_cache:
            self._resident = [None] * self.B
        self._w = w

    def _derive_keys(self, seeds, has_seed, rids):
        """The admitted requests' keys, split once: (draw keys (k, 2) for
        the first token, the keys the slots carry on (k, 2)). A seeded
        request's key is ``fold_in(PRNGKey(0x5EED), seed)``, an unseeded
        one's ``fold_in(PRNGKey(server seed), rid)``."""
        dev = self._pkeys.device
        k_seed = prandom.fold_in(self._fixed_key,
                                 torch.from_numpy(seeds).to(dev))
        k_rid = prandom.fold_in(self._base_key,
                                torch.from_numpy(rids).to(dev))
        keys = torch.where(torch.from_numpy(has_seed).to(dev)[:, None],
                           k_seed, k_rid)
        ks = prandom.split(keys)  # (k, 2, 2)
        return ks[:, 0], ks[:, 1]

    def draw(self, logits):
        """The fleet's next tokens (B,) int32 from its (B, V) logits: each
        row's key split, the row drawing with the first half
        (``sample_logits_per_row`` with the slots' parameters) and carrying
        the second on, as the JAX server's sampled chunk does."""
        ks = prandom.split(self._pkeys)  # (B, 2, 2)
        self._pkeys = ks[:, 1]
        return sample_logits_per_row(logits.float(), ks[:, 0],
                                     *self._params_dev).to(torch.int32)

    def _first_tokens(self, logits, idx, seeds, has_seed, rids, sample):
        """An admission's first tokens (k,) int32 from its (k, V) logits:
        greedy, or with ``sample`` drawn per row with the requests'
        parameters and keys (:meth:`_derive_keys`). The slots ``idx`` take
        the requests' keys, and the tokens as their next input."""
        draw_k, self._pkeys[idx] = self._derive_keys(seeds, has_seed, rids)
        if sample:
            tok1 = sample_logits_per_row(
                logits, draw_k, *(v[idx] for v in self._params_dev))
        else:
            tok1 = logits.argmax(-1)
        tok1 = tok1.to(torch.int32)
        self._tok[idx] = tok1
        return tok1

    def _scatter_rows(self, idx, pos0: int, rows_k, rows_v):
        """Write admitted rows, (N, k, L, ...) in the fleet's layout, into
        slots ``idx`` at rows [pos0, pos0 + L): ``rows_k`` float32 rows
        rotated to their absolute positions, ``rows_v`` the value rows.
        The int8 KV cache quantizes them by ``quantize_kv``, as the kernel
        quantizes the rows it writes; value rows given as an (int8 rows,
        scales) pair are scattered as they are."""
        L = rows_k.shape[2]
        if self._kv_quant:
            if not isinstance(rows_v, tuple):
                rows_v = dsk.quantize_kv(rows_v)
            for (data, scales), (q, sc) in ((self._ck,
                                             dsk.quantize_kv(rows_k)),
                                            (self._cv, rows_v)):
                data[:, idx, pos0:pos0 + L] = q
                scales[:, idx, pos0:pos0 + L] = sc
        else:
            self._ck[:, idx, pos0:pos0 + L] = rows_k.to(self._cdt)
            self._cv[:, idx, pos0:pos0 + L] = rows_v
        self._starts_dev[idx] = pos0

    @staticmethod
    def _k_rows(c, L: int):
        """Rows [0, L) of a transient scan-lane K cache as float32, the
        int8 KV cache's dequantized."""
        if isinstance(c, tuple):
            return c[0][:, :, :L].float() * c[1][:, :, :L, :, None]
        return c[:, :, :L].float()

    @staticmethod
    def _v_rows(c, L: int):
        """Rows [0, L) of a transient scan-lane V cache as they are, the
        int8 KV cache's an (int8 rows, scales) pair."""
        if isinstance(c, tuple):
            return tuple(x[:, :, :L] for x in c)
        return c[:, :, :L]

    def _rot(self, row: int):
        """Row ``row`` of the RoPE tables as float32 (1, hd / 2) each."""
        w = self._w
        return (w["cos"][row:row + 1].float(), w["sin"][row:row + 1].float())

    @torch.no_grad()
    def _admit_many(self, prompts, pos0: int, slots, seeds, has_seed, rids,
                    sample: bool, flash=False):
        """Prefill a wave of k same-length prompts (k, L) into ``slots`` at
        absolute rows ``[pos0, pos0 + L)`` of the fleet's caches; returns
        their first tokens (k,) int32 on the device (:meth:`_first_tokens`).
        ``flash`` takes the prefill's attention through the flash forward
        (``Llama.forward_logits_one``).

        The prefill runs at position 0 (``generate``'s bucketed dense
        prefill), and its K rows are then rotated on by ``pos0``: rotary
        rotations compose additively, so a row rotated for position p and
        again by row ``pos0`` of the table carries the rotation for p + pos0.
        The rotation is in float32 from the weight-type tables; V rows are
        not rotated. The fused lane's int8 KV cache takes the float32
        rotated K rows and the prefill's V rows through ``quantize_kv``; the
        scan lane's prefills on an int8 pair, so the wave attends its
        quantized rows as standalone ``generate`` does, and its K rows are
        dequantized, rotated and requantized (JAX ``serve.py:652-690``)."""
        model, w = self.model, self._w
        k, L = prompts.shape
        ids, last_idx = bucket_prompt(prompts, L, self.S)
        scan_kv = None if self._lane == "fused" else self._kv_quant
        ck5, cv5 = model._empty_caches(k, self._cdt, scan_kv)
        logits1 = model.prefill_logits(w, ck5, cv5, ids, last_idx, flash)
        idx = torch.as_tensor(slots, dtype=torch.long, device=logits1.device)
        tok1 = self._first_tokens(logits1, idx, seeds, has_seed, rids, sample)
        if self._lane == "xla":  # (N, k, L, Hkv, hd) rows
            self._scatter_rows(idx, pos0, _rope_pure(self._k_rows(ck5, L),
                                                     *self._rot(pos0)),
                               self._v_rows(cv5, L))
            return tok1
        # the fused lane: (N, k, L, W) rows in the fleet layout
        fk, fv = model._flat_caches(ck5, cv5, w)
        if k == 1:  # _flat_caches drops a unit batch axis
            fk, fv = fk[:, None], fv[:, None]
        W = fk.shape[-1]  # the first W columns: the pattern repeats
        self._scatter_rows(idx, pos0, dsk._rope_pairs(
            fk[:, :, :L].float(), w["cosD"][pos0, :W].float(),
            w["sinD"][pos0, :W].float()), fv[:, :, :L])
        return tok1

    @torch.no_grad()
    def _admit_prefix(self, suffix, donor_slot: int, donor_start: int,
                      pos0: int, slot: int, seeds, has_seed, rids, kb: int,
                      sample: bool):
        """A prefix-cache admission (the JAX package's ``admit_prefix_xla``,
        ``serve.py:722-835``): the request whose prompt is the donor's first
        ``kb`` resident tokens and then ``suffix`` (1, Ls) lands in
        ``slot`` at rows [pos0, pos0 + kb + Ls); returns its first token
        (1,) int32 on the device.

        The donor's ``kb`` rows from ``donor_start`` are read first, into a
        fresh transient cache at rows [0, kb): K un-rotated by
        angle(-donor_start) in float32 (the int8 KV cache's dequantized
        before and requantized after, one more rounding), V copied as it is.
        Only the suffix runs the forward, at position ``kb``; then rows
        [0, kb + Ls) are rotated by angle(pos0) and scattered as a wave's
        are, so the donor may be the slot itself."""
        model = self.model
        dsl = slice(donor_slot, donor_slot + 1)
        drows = slice(donor_start, donor_start + kb)
        ck1, cv1 = model._empty_caches(1, self._cdt, self._kv_quant)
        cd, sd = self._rot(donor_start)
        if self._kv_quant:
            pk = (self._ck[0][:, dsl, drows].float()
                  * self._ck[1][:, dsl, drows, :, None])
            ck1[0][:, :, :kb], ck1[1][:, :, :kb] = dsk.quantize_kv(
                _rope_pure(pk, cd, -sd))
            cv1[0][:, :, :kb] = self._cv[0][:, dsl, drows]
            cv1[1][:, :, :kb] = self._cv[1][:, dsl, drows]
        else:
            ck1[:, :, :kb] = _rope_pure(self._ck[:, dsl, drows].float(), cd,
                                        -sd).to(self._cdt)
            cv1[:, :, :kb] = self._cv[:, dsl, drows]
        tokens = torch.as_tensor(suffix, dtype=torch.long,
                                 device=model.device)
        logits1 = model.forward_logits_one(self._w, ck1, cv1, tokens, kb)
        idx = torch.tensor([slot], dtype=torch.long, device=model.device)
        tok1 = self._first_tokens(logits1, idx, seeds, has_seed, rids, sample)
        L = kb + suffix.shape[1]
        self._scatter_rows(idx, pos0, _rope_pure(self._k_rows(ck1, L),
                                                 *self._rot(pos0)),
                           self._v_rows(cv1, L))
        return tok1

    @torch.no_grad()
    def _decode(self, n: int):
        """Dispatch ``n`` decode steps from the fleet's position; returns
        the (n, B) int32 tokens on the device, not yet read back. The steps
        sample (:meth:`draw`) only when an active slot samples: the slot
        vectors already hold the inherited defaults, so a fleet whose rows
        all override to greedy runs the greedy chunk, on a sampling server
        too."""
        decode = (self.model.decode_chunk if self._lane == "fused"
                  else self.model.decode_chunk_plain)
        sampled = any(self._ptemp[i] > 0 for i in range(self.B)
                      if self._slots[i] is not None)
        self.sampled_steps += n if sampled else 0
        toks = decode(self._w, self._ck, self._cv, self._tok, self._pos, n,
                      starts=self._starts_dev,
                      sampler=self if sampled else None)
        self._tok.copy_(toks[-1])  # a copy: admission writes _tok in place
        return toks

    # ------------------------------- API -------------------------------- #
    def _try_admit(self):
        plan = self._plan_admissions()
        if not plan:
            return
        # the wave grouped by prompt length, each group split into
        # power-of-two sub-batches: one prefill per sub-batch; then the
        # prefix cache's reuse admissions, one each (donors vary); one host
        # read back for every admission's first token at the end
        by_len: dict = {}
        reuse = []  # (slot, req, (donor slot, donor start, kb))
        samples = {slot: self._slot_params(slot, req) for slot, req in plan}
        for dev_v, host_v in zip(self._params_dev,
                                 (self._ptemp, self._ptopk, self._ptopp)):
            dev_v.copy_(torch.from_numpy(host_v))
        planned = {slot for slot, _ in plan}
        for slot, req in plan:
            donor = (self._find_donor(req.prompt, slot, planned)
                     if self._prefix_cache else None)
            if donor is not None:
                reuse.append((slot, req, donor))
            else:
                by_len.setdefault(len(req.prompt), []).append((slot, req))
        waves, firsts_dev = [], []
        for L, group in sorted(by_len.items()):
            pos0 = self._pos - L
            flash = (flash_prefill_mode(self._w, L)
                     if self._flash_prefill is None else self._flash_prefill)
            for sub in self._pow2_subwaves(group):
                prompts, slots, seeds, has_seed, rids = self._wave_arrays(sub)
                firsts_dev.append(self._admit_many(
                    prompts, pos0, slots, seeds, has_seed, rids,
                    sample=any(samples[s] for s in slots), flash=flash))
                self._starts[slots] = pos0
                for s, r in sub:
                    self._resident[s] = (r.rid, tuple(r.prompt), pos0)
                waves.append(sub)
        for slot, req, (dslot, dstart, kb) in reuse:
            pos0 = self._pos - len(req.prompt)
            _, _, seeds, has_seed, rids = self._wave_arrays([(slot, req)])
            firsts_dev.append(self._admit_prefix(
                np.array([req.prompt[kb:]], np.int64), dslot, dstart, pos0,
                slot, seeds, has_seed, rids, kb, samples[slot]))
            self._starts[slot] = pos0
            self._resident[slot] = (req.rid, tuple(req.prompt), pos0)
            self.prefix_hits += 1
            self.prefix_rows_reused += kb
            waves.append([(slot, req)])
        self._credit_firsts(waves, firsts_dev)

    _EXHAUSTED = object()  # _dispatch sentinel: cache end reached

    def _dispatch(self, n: int = None):
        """Admit what fits, then dispatch one decode chunk with no host
        read back. Returns ``(toks, slots_snapshot, valid)``, ``None``
        (nothing active), or ``_EXHAUSTED`` (cache end reached).

        ``toks`` is a :class:`_Pending` read back: on a GPU the chunk's
        tokens are copied into pinned host memory right after the chunk is
        dispatched, with an event behind the copy. Waiting on that event
        waits for this chunk only, where ``tensor.cpu()`` would wait for
        everything queued since, the next chunk included, and so stall the
        one-deep pipeline of ``run`` and ``stream``."""
        self._refresh_weights()
        self._try_admit()
        if self.active == 0:
            return None
        navail = self.S - self._pos
        if navail <= 0:
            return self._EXHAUSTED
        # a fixed chunk size: steps past the cache end run against the
        # kernel's clamp of pos to S - 1 (in bounds, filler tokens) and are
        # trimmed by _process through ``valid``
        n = n or self.chunk
        toks = _Pending(self._decode(n))
        self.dispatched_steps += n
        self._pos += min(n, navail)
        # chunk tokens belong to the slot -> request mapping AT DISPATCH:
        # by the time they are read back a slot may have been recycled
        return toks, list(self._slots), min(n, navail)

    def _process(self, toks, snapshot, valid=None):
        """Read one dispatched chunk back and credit its tokens to the
        requests that occupied each slot at dispatch time. ``valid`` trims
        the clamped filler steps decoded past the cache end. Returns
        [(rid, new_tokens)] for :meth:`stream` (EOS excluded, as in
        ``Request.tokens``)."""
        toks = toks.numpy()[:valid]  # (n, B)
        credited = []
        for slot in range(self.B):
            req = snapshot[slot]
            if req is None or req.done:
                continue  # empty at dispatch, or already finished (the
                # slot decoded one chunk of discarded filler before the
                # pipeline caught up; see run())
            before = len(req.tokens)
            for t in toks[:, slot]:
                req.tokens.append(int(t))
                if req.tokens[-1] == self.eos_id \
                        or len(req.tokens) >= req.max_new_tokens:
                    break
            if self._slots[slot] is req:
                self._maybe_finish(slot)
            new = req.tokens[before:]  # after _maybe_finish pops the EOS
            if new:
                credited.append((req.rid, new))
            if self._prefix_cache:
                self._grow_resident(slot, req)
        return credited

    def step(self, n: int = None):
        """Admit what fits, then decode ``n`` (default ``chunk``) tokens for
        every slot; returns the requests that finished. Synchronous
        (dispatch, then read back); ``run`` pipelines instead."""
        before = set(self._finished)
        disp = self._dispatch(n)
        self._admit_credits.clear()  # stream()-only bookkeeping: stale
        # entries must not leak into a later stream() call
        if disp is self._EXHAUSTED:
            self._truncate_fleet()
        elif disp is not None:
            self._process(*disp)
        return [self._finished[r] for r in set(self._finished) - before]

    def stream(self, max_steps: int = 10_000):
        """Generator over ``(rid, new_tokens)`` chunks as they are read
        back, until the queue and all slots drain; :meth:`run` is this loop
        drained.

        A one-deep pipeline: chunk k+1 is dispatched BEFORE chunk k is read
        back, so tokens arrive one chunk late while the device keeps busy;
        each request's tokens arrive in order, interleaved across requests
        chunk by chunk."""
        pending = None
        for _ in range(max_steps):
            if pending is None and not self._queue and self.active == 0:
                break
            disp = self._dispatch()
            if self._admit_credits:  # admission-time first tokens
                yield from self._admit_credits
                self._admit_credits = []
            if disp is self._EXHAUSTED:
                if pending is not None:  # account in-flight tokens first
                    yield from self._process(*pending)
                    pending = None
                    continue  # retry: the chunk may have finished slots
                self._truncate_fleet()
                continue
            if pending is not None:
                yield from self._process(*pending)
            pending = disp
        if pending is not None:
            yield from self._process(*pending)

    def run(self, max_steps: int = 10_000) -> dict:
        """Drive until the queue and all slots drain; {rid: Request}.

        The one-deep pipeline of :meth:`stream`: the host's read back and
        bookkeeping for chunk k overlap the device's work on chunk k+1. The
        cost: a slot whose request finished in chunk k decodes one chunk of
        filler in k+1 before it is recycled (the filler rows are
        overwritten or masked by the next admission's ``starts``), and
        admissions lag one chunk behind EOS discovery."""
        for _ in self.stream(max_steps):
            pass
        return dict(self._finished)


class _Pending:
    """A dispatched chunk's (n, B) tokens on their way to the host."""

    def __init__(self, toks):
        if toks.device.type == "cuda":
            self._host = torch.empty(toks.shape, dtype=toks.dtype,
                                     pin_memory=True)
            self._host.copy_(toks, non_blocking=True)
            self._ready = torch.cuda.Event()
            self._ready.record()
        else:
            self._host, self._ready = toks, None

    def numpy(self):
        if self._ready is not None:
            self._ready.synchronize()
        return self._host.numpy()
