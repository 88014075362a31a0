"""Speculative continuous-batching serving: per-slot prompt-lookup
speculation inside the fleet protocol (the port of
``pydynet_tpu/models/llama/serve_spec.py``). ``LlamaServer(model,
speculative=K)`` builds a :class:`SpecLlamaServer`.

One verify iteration advances a slot by 1 to K + 1 tokens (its own
accepted drafts), so slots decode at their own positions, not at the shared
one of ``serve.py``:

* slot b's cache row p holds the KV of its token at position p, and a query
  at position q attends rows [0, q] of its own slot only. An admission
  writes the new prompt at rows [0, L) with no shift rotation and no
  ``starts`` mask: the previous tenant's stale rows lie above the slot's
  position and are rewritten before any query reads them (the cache
  discipline of ``speculative.py``, per slot);
* a wave of admissions is grouped by prompt length and split into
  power-of-two sub-waves; each runs one forward of its (k, L) prompts at
  position 0 straight into the fleet's caches (the JAX package builds fresh
  (N, k, S, Hkv, hd) caches and copies rows [0, L) over, the same
  mathematics), its window the next power of two of L;
* one chunk is ``chunk`` verify iterations with no read back to the host.
  Each drafts K tokens per slot from the slot's own text
  (``speculative.lookup_draft_rows``), runs one (B, K + 1) forward at the
  per-row positions n - 1 (``Llama.forward_logits_one``'s per-row mode),
  takes the argmax, accepts the leading run of drafts that match it, and,
  where the slot has headroom (``n + K + 1 <= min(S, window)``), writes
  the tokens and advances n. Rows and tokens past ``max_seq_len`` land in
  spare rows past it, which nothing reads (the JAX package drops them);
* after a chunk the host reads the tokens once, credits each request up to
  its eos or ``max_new_tokens``, and truncates a slot left without
  headroom (``n + K + 1 > S``).

Every emitted token is the greedy stream's (drafts are verified), so a
request's stream is standalone ``generate(fused=False)``'s with the same
``dtype`` and ``quant``. Greedy only, as in the JAX package: ``submit``
rejects a sampled request. The forward is the scan lane's: with ``quant``
its layer products run through ``qmatmul_stacked`` and its head through
``qmatmul`` (K5-K7 on a GPU), the attention is dense torch.
``spec_iterations`` and ``spec_accepted`` count as the JAX package's do.
"""
from __future__ import annotations

import numpy as np
import torch

from .model import check_dtype
from .serve import _FleetScheduler
from .speculative import lookup_draft_rows


class SpecLlamaServer(_FleetScheduler):
    """Continuous-batching greedy serving with per-slot prompt-lookup
    speculation.

    >>> srv = LlamaServer(model, speculative=7, batch_size=4)
    >>> rid = srv.submit(prompt_ids)
    >>> done = srv.run()

    ``chunk`` counts verify iterations a dispatch (each gives a slot 1 to
    K + 1 tokens), ``ngram`` the length of the gram the drafts are looked
    up by. The other keywords of ``LlamaServer`` (``lane``, ``kv_quant``,
    ``prefix_cache``, ``flash_prefill``) raise ``ValueError`` unless None
    or False, as do ``temperature > 0`` and a ``quant`` outside None,
    ``"int8"``, ``"int4"`` and ``"int8-head"``."""

    def __init__(self, model, batch_size: int = 4, speculative: int = 7,
                 ngram: int = 3, chunk: int = 16, eos_id: int = 2,
                 dtype=None, quant=None, temperature: float = 0.0,
                 top_k=None, top_p=None, seed: int = 0, **extra):
        bad = sorted(k for k, v in extra.items() if v not in (None, False))
        if bad:
            raise ValueError(f"unsupported with speculative serving: {bad}")
        if temperature and temperature > 0:
            raise ValueError("speculative serving is greedy-only "
                             "(serve_spec.py module doc)")
        if quant not in (None, "int8", "int4", "int8-head"):
            raise ValueError(f"unsupported quant mode: {quant!r}")
        check_dtype(dtype)
        model.eval()
        self.model = model
        self.B = batch_size
        self.K, self.g = int(speculative), int(ngram)
        self.chunk = chunk
        self.eos_id = eos_id
        self.S = S = model.max_seq_len
        if not (1 <= self.g < S and 1 <= self.K <= S - 2):
            raise ValueError(f"speculative={self.K}, ngram={self.g} "
                             f"outside the cache (max_seq_len {S})")
        self._dtype, self._quant = dtype, quant
        self._refresh_weights()
        dev = model.device
        # K + 1 spare rows past S take the writes of slots out of headroom
        rows = S + self.K + 1
        shape = (model.n_layers, self.B, rows, model.n_kv_heads,
                 model.head_dim)
        cdt = self._w["tok"].dtype
        self._ck = torch.zeros(shape, dtype=cdt, device=dev)
        self._cv = torch.zeros(shape, dtype=cdt, device=dev)
        self._seq = torch.zeros(self.B, rows, dtype=torch.int64, device=dev)
        self._n = torch.ones(self.B, dtype=torch.int64, device=dev)
        self._nh = np.ones(self.B, np.int64)  # the host's copy of _n
        self._init_fleet_state()
        self.spec_iterations = 0
        self.spec_accepted = 0

    def _refresh_weights(self):
        """The model's scan-lane snapshot (``generate(fused=False)``'s, the
        same cache key), which the model drops when its weights change
        (fine-tune steps, ``add_lora``, ``merge_lora``): the next chunk
        serves the new weights."""
        m = self.model
        self._w = (m._weights_xq(self._dtype, self._quant) if self._quant
                   else m._weights(self._dtype))

    def submit(self, prompt_ids, max_new_tokens: int = 256,
               temperature: float = None, top_k: int = None,
               top_p: float = None, seed: int = None) -> int:
        if any(v is not None for v in (temperature, top_k, top_p, seed)) \
                and (temperature or 0) != 0:
            raise ValueError("speculative serving is greedy-only")
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if len(prompt) + self.K + 2 > self.S:
            raise ValueError(
                f"prompt length {len(prompt)} leaves no speculative "
                f"headroom (need K+2={self.K + 2} rows before "
                f"max_seq_len {self.S})")
        return super().submit(prompt, max_new_tokens)

    def _plan_admissions(self):
        """Per-slot positions: any free slot takes the next queued request,
        with no shared-position rule."""
        plan = []
        for slot in range(self.B):
            if self._slots[slot] is not None or not self._queue:
                continue
            req = self._queue.popleft()
            self._slots[slot] = req
            plan.append((slot, req))
        return plan

    @torch.no_grad()
    def _admit_many(self, prompts, slots):
        """Prefill a wave of k same-length prompts (k, L) into ``slots`` at
        their rows [0, L); record each prompt and its first token in the
        slot's token buffer and set its position to L + 1. Returns the
        first tokens (k,) on the device."""
        k, L = prompts.shape
        dev = self.model.device
        idx = torch.as_tensor(slots, dtype=torch.long, device=dev)
        toks = torch.as_tensor(prompts, dtype=torch.long, device=dev)
        win = min(self.S, 1 << (L - 1).bit_length())
        logits = self.model.forward_logits_one(
            self._w, self._ck, self._cv, toks,
            torch.zeros(k, dtype=torch.long, device=dev), win=win, slots=idx)
        tok1 = logits.argmax(-1)
        self._seq[idx, :L] = toks
        self._seq[idx, L] = tok1
        self._n[idx] = L + 1
        return tok1

    def _try_admit(self):
        plan = self._plan_admissions()
        if not plan:
            return
        by_len: dict = {}
        for slot, req in plan:
            by_len.setdefault(len(req.prompt), []).append((slot, req))
        waves, firsts_dev = [], []
        for L, group in sorted(by_len.items()):
            for sub in self._pow2_subwaves(group):
                firsts_dev.append(self._admit_many(
                    np.array([r.prompt for _, r in sub], np.int64),
                    [s for s, _ in sub]))
                for s, _ in sub:
                    self._nh[s] = L + 1
                waves.append(sub)
        self._credit_firsts(waves, firsts_dev)

    @torch.no_grad()
    def _spec_chunk(self, win: int):
        """``chunk`` verify iterations for every slot over the caches'
        first ``win`` rows, all on the device (module doc); updates the
        token buffer and the positions in place."""
        K, S = self.K, self.S
        n, seq = self._n, self._seq
        offs = torch.arange(K + 1, device=n.device)
        limit = min(S, win)
        for _ in range(self.chunk):
            draft = lookup_draft_rows(seq[:, :S], n, K, self.g)   # (B, K)
            toks_in = torch.cat([seq.gather(1, (n - 1)[:, None]), draft], 1)
            logits = self.model.forward_logits_one(
                self._w, self._ck, self._cv, toks_in, n - 1,
                all_positions=True, win=win)
            toks = logits.argmax(-1)                             # (B, K + 1)
            a = torch.cumprod((draft == toks[:, :K]).long(), 1).sum(1)
            ok = n + K + 1 <= limit  # headroom in the cache and the window
            rows = n[:, None] + offs
            seq.scatter_(1, rows, torch.where(ok[:, None], toks,
                                              seq.gather(1, rows)))
            n = torch.where(ok, n + a + 1, n)
        self._n = n

    def step(self, n: int = None):
        """Admit into the free slots, run one chunk, and credit each slot's
        advance; returns the requests that finished."""
        before = set(self._finished)
        self._refresh_weights()
        self._try_admit()
        self._admit_credits.clear()  # stream()'s bookkeeping: unused here
        if self.active:
            # the window: a power of two covering the chunk's most advance
            need = int(self._nh.max()) + self.chunk * (self.K + 1)
            win = min(self.S, 1 << max(need - 1, 1).bit_length())
            self._spec_chunk(win)
            host = torch.cat([self._n[:, None], self._seq[:, :self.S]],
                             1).cpu().numpy()
            nh, seq = host[:, 0], host[:, 1:]
            self.spec_iterations += self.chunk
            for slot in range(self.B):
                req = self._slots[slot]
                if req is None:
                    continue
                old, new = int(self._nh[slot]), int(nh[slot])
                self.spec_accepted += max(new - old - self.chunk, 0)
                for t in seq[slot, old:new]:
                    req.tokens.append(int(t))
                    if req.tokens[-1] == self.eos_id \
                            or len(req.tokens) >= req.max_new_tokens:
                        break
                self._nh[slot] = new
                self._maybe_finish(slot)
                if self._slots[slot] is not None \
                        and new + self.K + 1 > self.S:
                    self._maybe_finish(slot, truncated=True)
        return [self._finished[r] for r in set(self._finished) - before]

    def run(self, max_steps: int = 10_000) -> dict:
        """Drain the queue; returns {rid: Request}."""
        for _ in range(max_steps):
            if not self._queue and self.active == 0:
                break
            self.step()
        return dict(self._finished)
