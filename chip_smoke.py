#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Run from the repository root on a machine with one CUDA GPU, nvcc and
PyTorch built for CUDA. Phases, each printed as it ends; any failure ends
the run with a nonzero exit and no result line:

1. the device, and ``nvidia-smi``'s name and power limit;
2. build the CUDA kernels from ``pydynet_tpu_torch/csrc`` (timed; says
   whether the library for these sources was already built);
3. the B=1 decode-step kernel (K1) against its plain PyTorch version at
   stories15M width with seeded random weights, in float32, bfloat16,
   bfloat16 with the int8 head, and with int8 layers and head (float32 and
   bfloat16) and int4 layers and head (bfloat16), at positions 0, 1, 17,
   255, 1023 and 1030 (the last one exercises the clamp to S - 1); then
   K1's ``emit_logits`` mode at the same formats and positions: its (1, V)
   logits against the plain logits (``EMIT_RTOL``), its argmax equal to
   the argmax mode's token on the same inputs, its caches as the plain
   step's;
3b. the batched decode-step kernel (K2) against its plain version the same
   way at B = 4 and 32, positions 1, 255 and 1030, with per-row
   ``starts`` (one row starting at pos), in float32, bfloat16, bfloat16 with
   the int8 head, int8 and int4 layers and head (bfloat16) and the int8 KV
   cache (float32 and bfloat16 weights; its int8 entries at most one apart,
   its scales within a relative tolerance), and each K2 row at B = 8
   against K1 on that row alone (the int8 KV cache's against K2 at B = 1);
   then K2's ``emit_logits`` mode in every one of these formats at B = 4
   and 32, positions 17 and 1030, as K1's;
3n. the narrow mode: phases 3 and 3b again on bench.py's ``GQA_15M``
   (stories15M with 2 KV heads, 96-wide caches): K1 and K2 with float
   weights and the int8 head on the narrow cache (K2 also with the int8 KV
   cache, ``starts`` and ``emit_logits``), with int8/int4 layers on the
   expanded layout;
3w. K2 above 32 rows (its row groups): phase 3b's checks at B = 33 and 64
   in every format, the argmax mode at position 1030 and the emit mode
   at 17, and each row of a B = 64 step against K1 on that row alone;
3c. the quantized-matmul kernels against their plain versions, bit for
   bit: the activation quantization, the decode kernel (K5) at M up to 32
   on each side of every tile edge (``QMM_ROWS``) and the prefill kernel
   (K6) at M in {33, 64, 256, 1000} rows (64: the scan lane's padded
   40-token prompt), float32, bfloat16 and float16 rows, int8 and int4
   weights, at stories15M's and
   Llama-2-7B's (K, N); at each of those decode cases the stacked kernel
   (K7) with a device layer index, eagerly and captured in a CUDA graph
   replayed at another layer and at indices past either end (clamped) on
   new rows; and K7 over 32 layers at the first, a middle and the last
   layer and at two indices outside them;
3d. the train-mode BatchNorm kernel (K8) against its plain version at
   (N, C) from (1, 7) to (8192, 1024) in float32 and bfloat16, its
   gradients through the autograd op against the plain forward's, and a
   float64 CUDA input raising;
3e. the greedy head alone (K9, K1's tensor-core head stage at one row
   without the final norm) against its plain version at stories15M's head
   (D 288, V 32000), a float32 h against float32 and bfloat16 weights, with
   a forced tie between two rows in different vocab blocks (the lower must
   win), and a float32 h against bfloat16 weights whose argmax differs from
   that of h rounded to bfloat16 (the kernel must not round it); the
   layers-only step (K10) against its plain version at stories15M width
   (6 layers, S 1024) in float32 and bfloat16 with the pair-swap and
   head-mask matrices at positions 0, 511, 1023 and 1030 (which must act
   as 1023),
   its output and both caches compared and the rows other than pos
   untouched; then the path K9 and K10 make together, a float32 greedy
   decode of the prompt and 63 tokens teacher-forced along the float32
   truth stream, one K10 and one K9 launch a token, equal to the truth at
   every confident step;
4. the B=1 path: ``Llama.generate`` of a 1024-token request in bfloat16,
   with ``quant`` None, ``"int8-head"``, ``"int8"`` and ``"int4"``, through
   K1 (its launch counter must equal the decode steps), the confident-step
   argmax gate against a float32 truth stream (int8: against the stream of
   a copy whose weights went through int8 and back; int4: majority
   agreement with the int4 round trip's), and the ``infer`` CLI once plain
   and once with ``--quant int8``; then ``generate`` of a 1024-token
   request with ``kv_quant="int8"``, which runs K2 at B = 1 (its launch
   counter must equal the decode steps), the ``b1-kvint8`` gate (majority
   agreement with the float32 stream) and ``infer --kv-quant int8``;
4s. the sampled path: the threefry key stream on the card against the CPU
   (bits equal, Gumbel within 2e-6); bench.py's ``logits-head-f32`` and
   ``sampled-t0.8-k50-p0.9`` gates (float32, B = 1, 64 steps); a sampled
   bfloat16 256-token request (t 0.8, k 50, p 0.9) through K1's emit mode
   (its emit launches must equal the decode steps, the argmax mode
   unused), the same seed twice giving the same stream, ``top_k=1`` giving
   the greedy stream (256 tokens); 8,192 draws from one logits row against
   the filtered softmax (chi-square p > 1e-3); sampled 256-token
   ``generate`` at B = 8 and with the int8 KV cache at B = 1 through K2's
   emit mode;
4b. the serving path: ``LlamaServer`` (B = 8, bfloat16; plain, with the
   int8 head, with int8 and int4 layers, and with the int8 KV cache)
   serving 24 requests with slot recycling, shifted admissions and
   truncation at the cache end, through K2 (its launch counter must equal
   the steps the server dispatched); a float32 server whose streams equal
   standalone float32 ``generate`` (K1) up to the first near-tie; the
   batched argmax gates at B = 4 and 32 (bench.py's ``batched-b4-int8``
   and ``-kvint8`` by majority agreement with the float32 stream,
   ``-int4`` with the int4 round trip's); ``generate`` of a 1024-token
   request at B = 8 through K2; and the ``serve_cli`` once plain and once
   with ``--kv-quant int8``; then a sampling B = 8 server (t 0.8, k 50,
   p 0.9) over the 24 requests capped at 128 new tokens, every odd one
   seeded and every fourth greedy, whose K2 emit launches must equal the steps of its sampled
   chunks and its argmax launches the rest; a seeded request's tokens
   equal in two fleets; ``infer`` and ``serve_cli`` with ``--temperature
   0.8 --top-k 50 --top-p 0.9``;
4g. the grouped-query path: ``generate`` of a 1024-token bfloat16 request
   on ``GQA_15M`` routed by ``fused=None`` (K1's narrow launches must equal
   the decode steps, every K1 call's caches 96 wide; their bytes beside
   MHA's), bench.py's ``gqa-6q2kv-narrow`` gate, a sampled request through
   the narrow emit mode, and ``quant="int8"`` on the expanded layout;
4w. grouped-query and wide fleets: a B = 8 ``GQA_15M`` server over the 24
   requests in bfloat16 and with the int8 KV cache (K2's narrow launches
   must equal the dispatched steps), its float32 twin against standalone
   float32 ``generate``; a 64-slot stories15M server over 96 requests and
   a B = 64 1024-token ``generate`` through K2's row groups;
4c. the training path: the flash-attention forward (K3) and its dq and
   dk/dv backward kernels (K4) against their plain versions at
   (B, L, 6, 48), B in {1, 8}, L in {1, 7, 64, 1000, 1024}, in float32,
   bfloat16 and float16; a full-parameter fine-tune of the stories15M model at B = 1,
   L = 1024 over ``TRAIN_STEPS`` Adam steps through ``finetune_steps``
   (each kernel's launch counter must equal 6 layers x the steps, and the
   loss must fall), whose first step is held against the same step on the
   CPU; and the ``finetune`` CLI once;
4d. the big-dims path: a Llama-2-7B-geometry model (32 layers, bf16,
   seeded random weights) generating a 64-token request with ``quant="int8"``
   and ``"int4"`` (its weights drawn on the card from a CUDA generator),
   routed by ``fused=None`` to the scan lane, with the
   quantized-matmul launch counters equal to the counts the code implies
   (4 x 32 stacked launches and one head launch a forward, each the
   product's only launch; a prefill's 8 bucketed rows are quantized by
   ``quantize_rows`` first, 4 x 32 launches more; every scan-lane layer
   product goes through K7, the head through K5); the int8 stream
   teacher-forced against the bf16 scan lane at confident steps; a B=4
   ``LlamaServer(quant="int4")`` that routes itself to the scan lane and
   serves 8 requests (launches counted the same way), every served stream
   teacher-forced through standalone B=1 ``generate``'s forward and equal
   to it at every confident step; the int4 lane against the truth of
   ``dequant_inplace`` weights by majority agreement; the stories15M scan
   lane with a 40-token prompt (its prefill through K6's kernel, K7's
   prefill branch) against the same lane on the CPU; and the ``serve_cli`` once with ``--lane xla --quant
   int8``;
4l. long-prompt prefill: a 1,000-token prompt on stories15M (bfloat16, the
   fused lane, padded to 1,024) and a 4,000-token prompt on the 7B geometry
   (its 4,096-token context; int8, the scan lane), each through
   ``generate(flash_prefill=False)`` (the dense (L, L) scores) and
   ``generate(flash_prefill=True)`` (K3), then 23 tokens: K3's launch
   counter must be the model's layers on a flash prefill and 0 on a dense
   one, and both routes must pass the confident-step gate, the prefill
   token included, against the float32 truth (stories15M) or the dense
   route's (7B); each route's time to the first token (3 in turns); the 7B
   int8 prefill on both routes at padded lengths 256 to 4,096, whose
   crossover sets ``FLASH_PREFILL_MIN``; K3 against its plain version at
   (1, 4096, 32, 128) bfloat16, timed beside its bound and
   ``F.scaled_dot_product_attention(is_causal=True)``;
4p. the scan lane's int8 KV cache and prefix cache at the 7B geometry,
   with int8 weights: a B=4 server (``chunk=32``) over 8 requests, each a
   seeded 2,048-token system prompt and a seeded suffix of 8-64 tokens,
   ``max_new_tokens`` cycling 16, 32, 48, with
   ``prefix_cache=True`` and then ``False`` after an untimed warm-up: the
   launches of K7, K5, K6 (as K7's prefill branch), K3 and
   ``quantize_rows`` equal to the implied counts, at least 4 prefix hits
   of 2,048 rows each, the peak memory beside the KV cache's bytes in int8
   and bf16, the median ms to the first token of the reuse and the full
   admissions, generated tok/s; each reuse stream equal to the no-reuse
   server's up to a step where it parts at a near-tie; standalone
   ``generate(kv_quant="int8")`` in both formats on the scan lane against
   the same request without it (int8 at every confident step, int4 by
   majority); ``serve_cli --lane xla --quant int4 --kv-quant int8
   --prefix-cache`` (a reuse admission counted); then, at stories15M width
   in bf16 on the scan lane, ``generate_speculative`` of a 256-token
   request and ``generate_beam(num_beams=1)`` against greedy
   ``generate(fused=False)`` up to a near-tie at their parting step, their
   tok/s and tokens a dispatch, and ``num_beams=4`` timed;
4r. LoRA fine-tuning and speculative serving: 2^20 threefry ``uniform``,
   ``bernoulli`` and bfloat16 draws of the port's ``Generator`` on the card
   equal to the CPU's bit for bit; DNN_dropout's first step on the card
   against the CPU's (the DNN_BN gate of 4e; its masks from that
   ``Generator``; phase 5 times the dropout_bn step); a rank-8
   LoRA fine-tune of stories15M (alpha 16, Q, K, V, O, gate, up, down,
   dropout 0.05; f32, Adam lr 1e-2) on a seeded 16-token pattern repeated
   to 256 tokens: its first step on the card equal to the CPU's (the
   training gate), K3 once and K4 twice a layer a step, the base weights
   bit-unchanged, steps until greedy decoding of the pattern's first 8
   tokens repeats it (at most 200), the loss curve and steps/s; the
   adapted model in bf16 on the fused lane, ``generate`` (K1) and a B=8
   ``LlamaServer`` (K2) over 24 requests cut from the pattern (64, 128 or
   256 new tokens), unmerged
   and merged streams bit-identical and unlike the base model's;
   ``LlamaServer(speculative=7, batch_size=8, chunk=16)`` over the same
   requests, each stream equal to ``generate(fused=False)``'s up to a
   parting at a near-tie, drafts accepted, tokens per verify iteration and
   generated tok/s beside the scan-lane and fused servers in turns; then
   the 7B geometry with int8 weights, ``LlamaServer(speculative=7,
   batch_size=4, chunk=16, quant="int8")`` over 8 seeded 128-token
   prompts, 64 new tokens each: streams against ``generate(quant="int8",
   fused=False)`` by the parting rule, the launches of K7, K5,
   ``quantize_rows`` and K6 (K7's prefill branch) equal to the implied
   counts, tok/s beside the scan-lane server, tokens per verify iteration,
   peak memory, and one verify chunk's device time by kernel;
4e. the nn-stack trainers: DNN_BN's first step on the card (through K8)
   against the same step on the CPU; the ``dropout_bn`` trainer at its
   published setting, 20 epochs of 8 steps through ``jit`` (K8's launches,
   the eager first step's plus those captured in the graph times its
   replays, must equal 2 x 160, and every net's mean loss must fall); the
   MNIST ConvNet at its defaults through ``jit`` (test accuracy above
   0.5); and both CLIs once;
4j. ``jit``: each case (a scalar gradient step, BatchNorm with SGD, Adam,
   Adam with dropout, microbatch accumulation, an LSTM, a dropout mask,
   the ts_prediction step, the dropout_bn step) ``JIT_STEPS`` calls
   through the jit's graph and eagerly from one seed, outputs and state
   within ``JIT_RTOL`` (and whether bit-equal), the threefry keys equal
   after every call, one graph of ``JIT_STEPS - 1`` replays, K8 captured
   once a BatchNorm layer and run replays x that; ts_prediction's 50
   epochs (final test loss below its first and below 0.7); the transformer
   at full width (dim 512), its first step against the CPU's (the training
   gate) and two epochs through ``jtrain.foreach``; then, eager against
   the jit in turns: the dropout_bn step (steps/s, kernels a step, busy
   share), the ts_prediction epoch and the transformer epoch;
4v. CLIP ViT-B/32 at its published width (12 image layers at width 768,
   12 text layers at 512, vocab 49,408; seeded random weights built on
   the CPU and copied to the card), float32 with TF32 off: zero-shot of
   the infer CLI's synthetic image against "a fish,a dog,a cat", the
   card's probabilities within 1e-5 of the CPU's and the same argmax; the
   B=1 zero-shot ms, images/s of a batch of 64 seeded images, kernels a
   forward and the device's busy share (``torch.profiler``); the first
   fine-tune step with the finetune CLI's projections trainable and with
   rank-8 LoRA on QKV and O against the CPU's (the training gate), then
   20 Adam steps each with the loss falling, steps/s, kernels a step and
   busy share; a checkpoint of the projection run written on the card,
   resumed on the CPU bit for bit, and the next step on both held to the
   gate; one SGD, Adagrad and Adadelta step on the card against the CPU;
   both CLIP CLIs on the card; no port kernel launched (this path reaches
   none);
4t. the tape (``core/tensor.py``: ``Tensor``, ``backward``, the data
   setter, ``jit`` over tape state): autograd1d on the card, its float64
   trajectory within 1e-12 of the CPU's; autograd2d's 60 steps through
   ``jit`` (one CUDA graph, 59 replays) bit-equal to the same steps run
   eagerly on the card and within 1e-12 of the CPU's, reaching (3, -1);
   every tape op's value and gradients on the card against the CPU in
   float64 (1e-12) and float32 (1e-6, TF32 switched on globally to show
   the tape's products ignore it); a mixed-device op raising; the steps/s
   of the autograd2d step eagerly and through the jit in turns; a 64-token
   ``generate(fused="numpy")`` request on the stories15M model (the NumPy
   lane on the host, float32 copies of the card's weights), teacher-forced
   equal to the eager float32 stream at every confident step, its stream
   equal to the fused lane's up to a near-tie, and its tok/s with the host
   CPU's name; the native merge engine loaded and equal to the Python
   merge; no port kernel launched by the tape or the NumPy lane;
4m. the parallel package over a one-rank NCCL group (``HashStore``, no
   network) on a ``{"dp": 1, "tp": 1}`` mesh on the card, no port kernel on
   this path: ``SpmdLlamaServer`` at stories15M width (float32, 8 slots,
   ``MESH_REQUESTS`` requests, so slots are recycled) against the port's
   ``LlamaServer(lane="xla")`` on the same weights, each stream equal up
   to a parting at a near-tie (``parts_at_a_tie``), and its tok/s; one
   ``quant="int8"`` request against the float server on int8-round-tripped
   weights and one ``kv_quant="int8"`` request against the scan lane's
   ``generate(kv_quant="int8")``, both by the parting rule; three
   ``llama_spmd.make_train_step`` steps, the loss falling and equal to the
   same steps with no mesh; a ``jit(mesh=)`` dp step, its graph replays
   bit-equal to the same step run eagerly; ``save_sharded`` and
   ``load_sharded`` of that state bit for bit; ``debug_nans`` trapping an
   injected NaN and ``utils.profiler.trace`` listing CUDA kernels; no
   port kernel launched inside any of those mesh calls (the launch counts
   read before and after each, the references they are held against left
   out); every number beside the card's name and power limit, the phase's
   seconds;
4h. float16 through every kernel of its path (each kernel's float16
   instances): K1 against its plain version in float16, float16 with the
   int8 head, int8 and int4 layers at positions 0, 255 and 1030, and its
   emit mode; K2 at B = 8 (those formats and the int8 KV cache) at 1 and
   1030 with per-row starts, its rows against K1 and its emit mode; both
   on ``GQA_15M``'s narrow caches; K3 at the 7B prefill's (1, 4096, 32,
   128) (K3/K4's other float16 shapes in phase 4c, and ``quantize_rows``
   and K5-K7 on float16 rows in phase 3c); K9 with float16 weights against a float32 h (the
   CUDA cores) and a float16 h (the tensor cores) and a cross-tile tie;
   K10 at positions 0, 64, 511 and 1030. Then the path in float16, each run
   with its counters zeroed just before it: a 256-token stories15M request
   (K1's launches = the decode steps; the confident-step gate against the
   float32 truth), a 300-token prompt whose prefill runs K3 (a launch a
   layer; the gate with the flash prefill), a B = 8 server over 12
   requests of at most 64 new tokens (K2's launches = the dispatched steps;
   each stream against standalone float16 ``generate`` up to a parting at
   a near-tie), a 5-step SGD fine-tune at L = 1024 (K3/K4 6 x 5 launches
   each, the loss falling; Adam's eps is 0 in float16), the scan lane
   with int8 weights and a 40-token prompt (K5, K6 as K7's prefill branch,
   K7, ``quantize_rows``; the majority gate) and the K10 + K9 path in
   float16. Each kernel's float16 time beside its bfloat16 time in turns
   (bfloat16, float16, float16, bfloat16), with the float16 plain version,
   bound and library call (SDPA for K3/K4, ``torch.argmax(w @ h + b)`` for
   K9, ``torch._int_mm`` for K6); the kernels line's ``[f16]`` entries;
5. timings: tokens per second of the 1024-token request in each format
   (bfloat16, int8-head, int8, int4, and the int8 KV cache through K2),
   timed ``REPEATS`` times in turns, K1's (also with int8 and int4 layers)
   and K2's (at B = 8, bfloat16, int8 and int4 layers, the int8 KV
   cache) time per step beside their plain versions' and their bounds,
   K9's beside its bound and ``torch.argmax(head_w @ h + b)``, K10's beside
   its bound and its plain version's, the serving run's generated tokens per second in each of
   4b's formats (``REPEATS`` times, in turns) and the B = 8 request's; the
   sampled request's (256 tokens) and the sampling server's (its requests
   capped at 128 new tokens) tokens per second beside the greedy bf16 ones
   (in the first turn only); K1's and K2's (B = 8) emit
   step beside the argmax mode at pos 512, the emit head's device time
   beside ``F.linear(h, head_w, head_b)``, and the sampling stage's
   launches, device time and elapsed time a step at B = 1 and 8; K3's
   and K4's times beside their plain versions' at (1, 1024, 6, 48) and
   (8, 1024, 6, 48), and the training step's time and training tokens per
   second at B = 1 and 8, L = 1024 (``REPEATS`` steps in turns); the 7B
   request's tokens per second in int8 and int4 and the B=4 server's over
   ``BIG_TIME_REQUESTS`` requests, the milliseconds to the first token of a
   ``TTFT_PROMPT``-token prompt in int8 and int4 (its 4 x 32 layer products
   through the prefill kernel; ``BIG_REPEATS`` runs in turns), and each
   quantized matmul at the 7B shapes (M = 1, 4 and 256, and with int8
   weights also at phase 4r's speculative rows: ``BIG_SPEC_ROWS``, a
   verify's, and ``BIG_SPEC_WAVE``, an admission wave's, with
   ``quantize_rows`` at the verify's rows) beside its plain
   version, ``torch._int_mm`` (int8, M > 16) on the weights as stored,
   row-major, and on a column-major copy, and its bound; each kernel's
   bound (bytes over 3.35 TB/s or operations over the peak for its type;
   K3's and K4's float32 products at float32 accuracy on the tensor cores,
   a third of the TF32 peak) and, for K3/K4, ``F.scaled_dot_product_attention``'s
   forward and backward; K8's time at (40, 512), (40, 128), (1024, 1024) and
   (8192, 1024) beside its plain version, its bound and ``F.batch_norm``,
   and the MNIST ConvNet's epochs through ``jit`` in steps/s and
   samples/s (phase 4j times the dropout_bn step); K1 narrow against K1 MHA (bf16, pos 512), K2
   narrow B = 8 against MHA B = 8, K2 at B = 64 (bf16), each in turns
   beside its plain version and bound, and the
   tokens per second of the ``GQA_15M`` request, the ``GQA_15M`` B = 8
   server and the 64-slot server; all with the card's name and power
   limit;
6. only with ``--profile``: for K1 the step by CUDA events and the host's
   enqueue time per call at positions 0, 512 and 1023, and for K1 and K2
   the device time of each kernel of the chain and of each stage (q/k/v,
   attention, wo, gate/up, down, head, argmax) from ``torch.profiler``,
   with the kernels a step;
   the device's busy share of a 1024-token request and of a serving run
   under the profiler; for the training step at B = 1 and 8 the device time
   of its largest kernels and the device's busy share; for a 7B int8 and
   int4 token on the scan lane the device time by kernel and the busy
   share, and the same for phase 4p's reuse admission, a full admission
   and 4 decode steps (int8, B=4); for the dropout_bn train step its
   largest kernels and the busy share.

The last two lines of standard output are a JSON object describing the
kernels and then ``{"ok": true, "device": {...}}``.
"""
import json
import os
import platform
import subprocess
import sys
import time
import types

import numpy as np
import torch

CFG = dict(vocab_size=32000, embed_dim=288, n_heads=6, ffn_dim=768,
           max_seq_len=1024, max_batch_size=32, n_layers=6)  # stories15M
POSITIONS = (0, 1, 17, 255, 1023, 1030)
BATCH_POSITIONS = (1, 255, 1030)
BATCHES = (4, 32)  # K2 against its plain version
WIDE_BATCHES = (33, 64)  # K2 above one group of 32 rows
WIDE_REQUESTS = 96  # the 64-slot server's requests (SERVE's mix)
# bench.py's GQA_15M: stories15M with 2 KV heads (head_dim 48, Dkv 96)
GQA_CFG = dict(CFG, n_kv_heads=2)
FORMATS = {"f32": (torch.float32, None), "bf16": (torch.bfloat16, None),
           "bf16-int8head": (torch.bfloat16, "int8-head"),
           "f32-int8": (torch.float32, "int8"),
           "bf16-int8": (torch.bfloat16, "int8"),
           "bf16-int4": (torch.bfloat16, "int4"),
           "f16": (torch.float16, None),
           "f16-int8head": (torch.float16, "int8-head"),
           "f16-int8": (torch.float16, "int8"),
           "f16-int4": (torch.float16, "int4")}
B1_FORMATS = ("f32", "bf16", "bf16-int8head", "f32-int8", "bf16-int8",
              "bf16-int4")  # phases 3 and 3n (phase 4h: F16_FORMATS)
F16_FORMATS = ("f16", "f16-int8head", "f16-int8", "f16-int4")
# K2's int8 KV cache (float weights only): its formats' weight types
KV8_FORMATS = {"f32-kv8": torch.float32, "bf16-kv8": torch.bfloat16,
               "f16-kv8": torch.float16}
BATCHED_FORMATS = ("f32", "bf16", "bf16-int8head", "bf16-int8", "bf16-int4",
                   "f32-kv8", "bf16-kv8")  # what K2 takes (phase 3b)
F16_BATCHED = F16_FORMATS + ("f16-kv8",)  # phase 4h
# int8 KV caches, kernel vs plain: both quantize the same new K/V rows, whose
# float32 values differ by summation order (and, in bf16, by a matmul input
# rounded to a neighbouring bf16 value), so an entry may land one step apart.
# A query element or cache entry one step apart moves a score by about 1/127
# of one element's share, and the layers after it carry that on (as for
# QUANT_CACHE_ATOL), so a row's scale (its amax / 127) may move by ~1e-4 of
# itself (1.7e-4 seen at f32, B=32); one bf16 ulp, 2**-7, bounds that and
# keeps a row's entries within one step of each other
KV8_SCALE_RTOL = {torch.float32: 2.0**-7, torch.bfloat16: 2.0**-7,
                  torch.float16: 2.0**-7}
# int8 KV caches at a rounding tie: where the plain step's new K or V entry
# x lies within float noise of a half step (x / s, s its row's scale, that
# close to n + 1/2), a kernel's entry may take the other side, and its
# scale may move the row's largest entry (127 steps) by that noise. The
# float32 sums of these rows in two orders differ by at most 4.4e-5 of a
# step at stories15M's widths (tests/test_torch_tie_check.py measures it),
# and the kernels' 3xTF32 products by a few times that; 2**-8 of a step
# leaves a wide margin and takes in under 1 % of entries spread evenly
KV8_TIE_STEPS = 2.0**-8
# cache tolerance, kernel vs plain: f32 differs only in summation order
# (values are O(1), so 1e-4 is ~1000 f32 ulps); bf16 rows may round to a
# neighbouring bf16 value (one ulp at |x| < 8 is at most 2**-5), f16 rows
# to a neighbouring f16 value (2**-8 there)
CACHE_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-5,
              torch.float16: 2.0**-8}
# int8/int4 layers: an activation whose x * 127 / amax lies within float32
# summation noise of a half-integer rounds to the other integer in one of
# the two; that moves its matmul's outputs by up to max |w| * amax / 127 and
# the layers after it carry the change on through the residual, so a
# cache row may move by several such steps; bf16's bound holds that
QUANT_CACHE_ATOL = 2.0**-5
# the sampled path (bench.py's sampled-t0.8-k50-p0.9 gate's parameters)
SAMPLE = dict(temperature=0.8, top_k=50, top_p=0.9)
SAMPLE_SEED = 7
SAMPLED_SHORT = 256  # total length of the sampled requests: the sampling
# stage costs 8-16 ms a token (PERF.md), so none runs 1024 tokens
SAMPLED_SERVE_NEW = 128  # the sampling server's cap on max_new_tokens
GUMBEL_ATOL = 2e-6  # -log(-log(u)): the card's float32 log against the CPU's
LAW_DRAWS, LAW_SEED, LAW_P_MIN = 8192, 3, 1e-3  # the law check
EMIT_POSITIONS_B = (17, 1030)  # K2 emit vs plain (rows start in [0, pos])
# emit_logits vs plain, as a share of the plain logits' largest |value|:
# float32 differs in summation order only; bfloat16 rounds every matmul
# input, and the int8/int4 formats quantize every activation vector, so an
# input landing on the neighbouring value moves the logits by a few
# bfloat16 ulps: the logits gate's 2e-2 (utils/fidelity.gate_fused_logits)
EMIT_RTOL = {"f32": 1e-4, "other": 2e-2}
# K10 vs plain: h_out (1, D) is RMS-normed, O(1): float32 differs in
# summation order only (the JAX package's 1e-4 for its kernel,
# tests/test_ops_kernels.py:107); bf16 rounds every matmul input and the
# probabilities, one of which may land on a neighbouring bf16 value
STEP_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-5,
             torch.float16: 2.0**-8}
# around the attention stage's 16-row tiles and its blocks' shares of
# them; 1030 >= S acts as S - 1
STEP_POSITIONS = (0, 63, 64, 65, 255, 256, 511, 1023, 1030)
HEAD_TIE = (100, 20000)  # vocab rows in different head tiles
PATH_STEPS = 64  # truth tokens of the K10 + K9 path and the gates
B1_QUANTS = (None, "int8-head", "int8", "int4")  # phase 4's requests
K2_TIMED = ("bf16", "bf16-int8", "bf16-int4", "bf16-kv8")  # phase 5
PROMPT = np.array([[1, 243, 532, 991]])
REQUEST = 1024  # total length of the main-path request
REPEATS = 2  # timed requests (or serving runs) per format in phase 5
SERVE = dict(batch_size=8, chunk=128, eos_id=-1)  # the phase-4b server
SERVE_FORMATS = {"bf16": {}, "bf16-int8head": dict(quant="int8-head"),
                 "bf16-int8": dict(quant="int8"),
                 "bf16-int4": dict(quant="int4"),
                 "bf16-kv8": dict(kv_quant="int8")}  # the server's formats
N_REQUESTS = 24
MAX_NEW = (64, 256, 700)  # cycled over the requests
F32_MARGIN = 1e-3  # f32 server vs f32 generate: they differ by rounding of
# the shifted rotation and summation order (~1e-6), so a stream is compared
# up to its first step whose f32 top-2 margin is below this
FLASH_BATCHES, FLASH_LENGTHS = (1, 8), (1, 7, 64, 1000, 1024)
BN_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}  # K8's, as JAX's
# the flash kernels' and the quantized matmuls' row types
DTYPES = dict(BN_DTYPES, f16=torch.float16)

# flash kernels vs their plain versions, both float32 arithmetic on the same
# inputs: they differ in summation order (and the forward's online softmax
# against a two-pass one), so outputs of O(1) get the JAX package's own
# tolerances for its kernels against the composite: 2e-5 for o and lse,
# 5e-4 for the gradients; a bfloat16 output may also round to the
# neighbouring bfloat16 value, one ulp, at most 2**-7 of its magnitude
FLASH_ATOL = {"o": 2e-5, "lse": 2e-5, "dq": 5e-4, "dk": 5e-4, "dv": 5e-4}
BF16_ULP = 2.0**-7
# one ulp of a 16-bit output, as a share of its magnitude at most
ULP16 = {torch.bfloat16: BF16_ULP, torch.float16: 2.0**-10}
TRAIN_CFG = dict(CFG, max_batch_size=1)
TRAIN_PREFIXES = ("tok_embedding", "layers", "norm", "lm_head")
TRAIN_L, TRAIN_LR, TRAIN_STEPS = 1024, 1e-3, 20
# the first Adam step on the card vs the CPU: the loss differs by summation
# order over 1024 x 32000 logits (~1e-6 relative); each gradient tensor is
# held within 1e-4 of its largest element; a weight moves by
# lr * g / (|g| + 3.2e-7), about +-lr wherever |g| >> 3e-7, so a gradient
# difference d moves it by at most lr * d / 3.2e-7: lr / 10 allows d up to
# 3e-8, far above float32 summation noise of these gradients
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_W_ATOL = 1e-5, 1e-4, TRAIN_LR / 10
TRAIN_TEXT = ("Once upon a time, there was a little girl named Lily. She "
              "loved to play outside in the park with her friends.")
# Llama-2-7B geometry (scripts/bench_7b_full.py:48), all 32 layers, bf16,
# at Llama-2's published 4,096-token context
LLAMA2_7B = dict(vocab_size=32000, embed_dim=4096, n_heads=32, ffn_dim=11008,
                 max_seq_len=4096, max_batch_size=1, n_layers=32)
# (K, N) of every quantized matmul: fused qkv, wo, fused gate/up, down, head
QMM_SHAPES = {"stories15M": ((288, 864), (288, 288), (288, 1536), (768, 288),
                             (288, 32000)),
              "7B": ((4096, 12288), (4096, 4096), (4096, 22016),
                     (11008, 4096), (4096, 32000))}
QMM_NAMES = ("wqkv", "wo", "wgu", "down", "head")
# decode row counts (M <= 32: the fused route up to 4 rows, then the int8
# rows in tiles of 8, each side of every tile edge and partial tiles among
# them) and prefill rows (M > 32) in tiles of 64, full and partial
QMM_ROWS = (1, 2, 3, 4, 5, 7, 8, 9, 12, 15, 16, 17, 24, 25, 31, 32, 33, 64,
            256, 1000)
BIG_NEW = 64  # tokens of the 7B request (prefill token included)
BIG_SERVE = dict(batch_size=4, chunk=32, eos_id=-1)
BIG_REQUESTS, BIG_MAX_NEW = 8, (48, 64, 24, 40)
BIG_TIME_REQUESTS = 8  # the timed server: two admission waves
BIG_REPEATS = 2
LONG_PROMPT = 40  # a stories15M scan-lane prompt past 32 rows: the K6 path
TTFT_PROMPT = 512  # the 7B prompt whose time to the first token is timed
# the long-prompt phase: a prompt of each length prefilled through the dense
# scores and through the flash forward (K3), then LONG_NEW tokens (the
# prefill token included); stories15M's pads to its 1,024 rows, the 7B's to
# its 4,096
LONG_PROMPTS = {"stories15M": 1000, "7B": 4000}
LONG_NEW = 24
# the padded prompt lengths at which the two routes' prefills are timed at
# 7B width: the smallest from which flash is faster at every one is the
# crossover that sets the port's FLASH_PREFILL_MIN
CROSSOVER_LENGTHS = (256, 512, 1024, 2048, 4096)
LONG_REPEATS = 2  # first tokens a route and length, the routes in turns
LONG_FLASH_SHAPE = (1, 4096, 32, 128)  # K3 at the 7B prefill: (B, L, H, d)
INT4_MIN_AGREE = 0.75  # bench.py's majority floor for the lossy formats
QMM_KERNELS = ("quantize_rows", "qmatmul", "qmatmul_prefill",
               "qmatmul_stacked")
# the shared-system-prompt phase (4p): a B=4 scan-lane server with the int8
# KV cache over PREFIX_REQUESTS requests, each a seeded PREFIX_SYSTEM-token
# system prompt and a seeded suffix of PREFIX_SUFFIX tokens,
# max_new_tokens cycling over PREFIX_MAX_NEW
PREFIX_SERVE = dict(batch_size=4, chunk=32, eos_id=-1, kv_quant="int8")
PREFIX_SYSTEM = 2048
PREFIX_SUFFIX = (8, 64)
PREFIX_REQUESTS = 8
# past one chunk for some: a server whose requests all end in its first
# chunk goes idle, rewinds, and drops every donor
PREFIX_MAX_NEW = (16, 32, 48)
PREFIX_MIN_HITS = PREFIX_REQUESTS - PREFIX_SERVE["batch_size"]
# Part B of phase 4p: beam search and speculative decoding at stories15M
# width, bf16, on the scan lane
SPEC_REQUEST = 256  # total length of the speculative and greedy requests
SPEC_PROMPT = np.array([[1, 243, 532, 991] * 4])
BEAM_REQUEST = 128  # total length of the beam-search requests
# phase 4r: the LoRA fine-tune (rank, alpha, targets, dropout), its row of
# LORA_L tokens (a seeded LORA_PERIOD-token pattern repeated), Adam's lr,
# the step budget, and how often greedy decoding is checked for the loop
LORA = dict(r=8, alpha=16.0, targets=("Q", "K", "V", "O", "gate", "up",
                                      "down"), dropout=0.05)
LORA_L, LORA_PERIOD, LORA_LR, LORA_MAX_STEPS, LORA_EVERY = 256, 16, 1e-2, \
    200, 10
LORA_PROMPTS = (8, 12, 16)  # prompt lengths of the requests cut from it
LORA_MAX_NEW = (64, 128, 256)  # their max_new_tokens, cycled
SPEC_SERVE = dict(speculative=7, batch_size=8, chunk=16, eos_id=-1)
BIG_SPEC = dict(speculative=7, batch_size=4, chunk=16, eos_id=-1,
                quant="int8")
BIG_SPEC_REQUESTS, BIG_SPEC_PROMPT, BIG_SPEC_NEW = 8, 128, 64
# the rows of its quantized products: a verify iteration's B (K + 1), and
# an admission wave's B prompts (phase 5 times the kernels at both)
BIG_SPEC_ROWS = BIG_SPEC["batch_size"] * (BIG_SPEC["speculative"] + 1)
BIG_SPEC_WAVE = BIG_SPEC["batch_size"] * BIG_SPEC_PROMPT
GEN_DRAWS = 1 << 20  # threefry draws compared between the card and the CPU
# K8, the train-mode BatchNorm, against its plain version: (N, C) from one
# row to a wide batch, the dropout_bn trainer's (40, 512) and (40, 128) among
# them. Inputs are O(1) (x normal, gamma in [0.5, 1.5], beta normal / 2), so
# float32 gets the JAX package's tolerances for its kernel against its
# composite (tests/test_ops_kernels.py:241-243): the sums are taken in
# another order. A bfloat16 out may also round to the neighbouring bfloat16
# value, one ulp (BF16_ULP of its magnitude); its float32 mean and var keep
# 1e-5. Gradients through the autograd op against autograd through the plain
# forward: within BN_GRAD_RTOL of each gradient tensor's largest element.
BN_SHAPES = ((1, 7), (8, 128), (40, 512), (40, 128), (1000, 300),
             (1024, 1024), (8192, 1024))
BN_ATOL = {"out": 1e-5, "mean": 1e-6, "var": 1e-5}
BN_BF16_STATS_ATOL = 1e-5
BN_GRAD_RTOL = 1e-4
BN_TIME_SHAPES = ((40, 512), (40, 128), (1024, 1024), (8192, 1024))
# K8's four (x, gamma/beta) type pairs
BN_TYPE_PAIRS = ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                 (torch.bfloat16, torch.float32),
                 (torch.bfloat16, torch.bfloat16))
# the dropout_bn trainer at its published setting (examples/pydynet/
# dropout_bn.py:128): 320 training faces at batch 40 are 8 steps an epoch,
# each with two BatchNorm1d layers in train mode, so 2 K8 launches a step
DBN_EPOCHS, DBN_STEPS, DBN_LR = 20, 8, 5e-5
MNIST_MIN_ACC = 0.5  # chance is 0.1; tests/test_utils_examples.py:128
# phase 4j: the jit's graph route against its eager route, JIT_STEPS steps of
# each case from one seed. The graph replays the kernels the eager step
# launched, on the same inputs in the same order, so the two should agree
# to the bit; JIT_RTOL (of each output's or state tensor's largest element)
# leaves room for a library call that picks another algorithm under capture
# (cuBLAS's workspace there is the graph's own). Dropout masks and the
# threefry keys are integer draws and must be equal.
JIT_STEPS = 20
JIT_RTOL = 1e-5
JIT_CASES = ("gd", "bn-sgd", "adam", "adam-dropout", "accum", "lstm",
             "dropout-mask", "ts_prediction", "dropout_bn")
TS_MAX_LOSS = 0.7  # ts_prediction's final test loss (tests/
# test_utils_examples.py:123-125 holds the JAX example to it)
TF_EPOCHS, TF_LR = 2, 5e-4  # the transformer example: epochs, its Adam's lr
JIT_ROUNDS = 2  # timed runs of each route, in turns
JIT_TIMED = 50  # dropout_bn steps a timed run
TS_TIMED = 20  # ts_prediction epochs a timed run
# phase 4v: CLIP ViT-B/32 at its published width (the CLIP() defaults),
# seeded random weights: the infer CLI's labels and synthetic image; the
# card's probabilities against the CPU's within CLIP_PROB_ATOL (float32
# throughout, the products without TF32, so they differ by summation order
# only); the finetune CLI's default projections and a rank-8 LoRA on QKV
# and O, each trained CLIP_STEPS Adam steps at CLIP_LR after its first step
# is held to the CPU's by the training gate; the other optimizers at their
# defaults (SGD needs a rate) for one step each
CLIP_LABELS = "a fish,a dog,a cat"
CLIP_TARGET = 2
CLIP_PROB_ATOL = 1e-5
CLIP_BATCH, CLIP_SEED = 64, 1  # the timed batch of seeded images
CLIP_REPEATS = 20  # timed zero-shot calls at B=1 and at CLIP_BATCH
CLIP_STEPS, CLIP_LR = 20, 1e-4
CLIP_PROJ = ("text_encoder.proj", "image_encoder.proj")
CLIP_LORA = dict(r=8, alpha=16.0, targets=("QKV", "O"))
CLIP_OPTIMIZERS = {"SGD": dict(lr=1e-3), "Adagrad": {}, "Adadelta": {}}
# phase 4t: the tape. TAPE_STEPS autograd2d steps (the JAX example's 60);
# every tape op against the CPU within TAPE_TOL; the eager and jitted
# autograd2d step timed TAPE_TIMED steps a run, TAPE_ROUNDS runs in turns; a
# NUMPY_REQUEST-token request on the NumPy lane
TAPE_STEPS = 60
TAPE_TOL = {np.float64: 1e-12, np.float32: 1e-6}
TAPE_TIMED, TAPE_ROUNDS = 200, 2
NUMPY_REQUEST = 64
# (op, shapes): the loss is the op's output times seeded weights, summed
TAPE_OPS = {
    "add": (lambda pdt, x, y: pdt.add(x, y), [(2, 3), (1, 3)]),
    "sub": (lambda pdt, x, y: x - y, [(4, 2, 3), (3,)]),
    "mul": (lambda pdt, x, y: x * y, [(2, 3), (2, 1)]),
    "div": (lambda pdt, x, y: x / (y * y + 1), [(2, 3), (3,)]),
    "pow": (lambda pdt, x, y: pdt.pow(x * x + 0.5, y), [(2, 3), (2, 3)]),
    "matmul": (lambda pdt, x, y: x @ y, [(5, 2, 3), (3, 4)]),
    "matmul_wide": (lambda pdt, x, y: x @ y, [(64, 256), (256, 48)]),
    "maximum": (lambda pdt, x, y: pdt.maximum(x, y), [(2, 3), (3,)]),
    "minimum": (lambda pdt, x, y: pdt.minimum(x, y), [(2, 3), (2, 3)]),
    "abs": (lambda pdt, x: pdt.abs(x), [(3, 4)]),
    "exp": (lambda pdt, x: pdt.exp(x), [(3, 4)]),
    "log": (lambda pdt, x: pdt.log(x * x + 0.1), [(3, 4)]),
    "sign": (lambda pdt, x: pdt.sign(x) * x, [(3, 4)]),
    "sigmoid": (lambda pdt, x: pdt.sigmoid(x), [(3, 4)]),
    "tanh": (lambda pdt, x: pdt.tanh(x), [(3, 4)]),
    "sqrt": (lambda pdt, x: pdt.sqrt(x * x + 1), [(3, 4)]),
    "square": (lambda pdt, x: pdt.square(x), [(3, 4)]),
    "sum": (lambda pdt, x: pdt.sum(x, axis=1), [(2, 3, 4)]),
    "mean": (lambda pdt, x: pdt.mean(x, axis=(0, 2), keepdims=True),
             [(2, 3, 4)]),
    "max": (lambda pdt, x: pdt.max(x, axis=-1), [(2, 3, 4)]),
    "min": (lambda pdt, x: pdt.min(x), [(2, 3, 4)]),
    "reshape": (lambda pdt, x: pdt.reshape(x, (4, 6)), [(2, 3, 4)]),
    "transpose": (lambda pdt, x: pdt.transpose(x, (0, -1, -2)),
                  [(2, 3, 4)]),
    "swapaxes": (lambda pdt, x: pdt.swapaxes(x, 0, 2), [(2, 3, 4)]),
    "getitem": (lambda pdt, x: x[[0, 2, 0], 1:], [(3, 4)]),
    "getitem_neg_step": (lambda pdt, x: x[::-1, 1::-2], [(3, 4)]),
    "concat": (lambda pdt, x, y: pdt.concat([x, y, x], axis=1),
               [(2, 3), (2, 2)]),
    "split": (lambda pdt, x: pdt.split(x, [1, 3], axis=1)[1] * 2
              + pdt.hsplit(x, 2)[0].sum(), [(3, 4)]),
    "squeeze": (lambda pdt, x: pdt.squeeze(pdt.unsqueeze(x, (0, 2)), 0),
                [(3, 4)]),
    "wrap_pure": (lambda pdt, x, y: pdt.wrap_pure(
        lambda a, b: torch.sin(a) @ b, x, y), [(2, 3), (3, 2)]),
    "remat_pure": (lambda pdt, x, y: pdt.remat_pure(
        lambda a, b: torch.square(a @ b) @ b.T, x, y), [(4, 5), (5, 6)]),
}
# phase 4m: the parallel package on a one-rank mesh. MESH_REQUESTS requests
# of MESH_NEW new tokens from seeded prompts of 4 to 12 tokens on 8 slots;
# the train step's batch (MESH_B, MESH_L) and rate; the jit's MLP steps
MESH_REQUESTS, MESH_NEW = 12, 32
MESH_B, MESH_L, MESH_LR, MESH_STEPS = 4, 64, 0.5, 3
MESH_JIT_STEPS = 6
TRACE_PRODUCTS = 50  # the (1024, 1024) products under utils.profiler.trace
# phase 4h: float16 through every kernel of its path. K1 against plain at
# F16_POSITIONS (every float16 format, and the emit mode), K2 at B =
# F16_BATCH at F16_BATCH_POSITIONS, K10 at F16_STEP_POSITIONS; K3/K4 timed
# at F16_FLASH (B, L, H, d, with the backward). The main path: a F16_REQUEST-token stories15M
# request, a F16_LONG_PROMPT-token prompt (a flash prefill), a B=8 server
# over F16_SERVE_REQUESTS requests capped at F16_SERVE_NEW new tokens, a
# F16_TRAIN_STEPS-step SGD fine-tune (Adam's eps of 1e-8 is 0 in float16)
F16_POSITIONS = (0, 255, 1030)
F16_BATCH, F16_BATCH_POSITIONS = 8, (1, 1030)
F16_STEP_POSITIONS = (0, 64, 511, 1030)
F16_FLASH = ((1, TRAIN_L, 6, 48, True), LONG_FLASH_SHAPE + (False,))
F16_REQUEST, F16_LONG_PROMPT = 256, 300
F16_SERVE_REQUESTS, F16_SERVE_NEW = 12, 64
F16_TRAIN_STEPS, F16_TRAIN_LR = 5, 0.1
# the least time of a function: bytes over the memory rate, or operations
# over the card's peak for their type (NVIDIA's H100 SXM data sheet, dense)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.float32: 67e12, torch.bfloat16: 989e12,
              torch.float16: 989e12, torch.int8: 1979e12,
              # float32 products at float32 accuracy on the tensor cores:
              # three TF32 products each (3xTF32), a third of 495 TFLOP/s
              "3xtf32": 495e12 / 3}


def phase(name, t0):
    print(f"[chip_smoke] phase {name}: ok ({time.perf_counter() - t0:.1f} s)",
          flush=True)


def i32(values, dev):
    return torch.tensor(values, dtype=torch.int32, device=dev)


def step_args(model, weights, ck, cv, pos, tok):
    from pydynet_tpu_torch.models.llama.model import (decode_quant_kwargs,
                                                      decode_weight_args)

    dev = model.device
    return ((i32([pos], dev), i32([tok], dev),
             *decode_weight_args(weights), ck, cv),
            dict(n_heads=model.n_heads, **decode_quant_kwargs(weights)))


def cache_atol(fmt):
    dtype, quant = FORMATS[fmt]
    return QUANT_CACHE_ATOL if quant in ("int8", "int4") else \
        CACHE_ATOL[dtype]


def fmt_of(fmt):
    """(weight type, quant) of a K1 or K2 format."""
    return (KV8_FORMATS[fmt], None) if fmt in KV8_FORMATS else FORMATS[fmt]


def cache_diff(ck, rck):
    """Max |difference| of two caches; of two int8 KV caches, (max int8
    difference, max relative difference of the scales)."""
    if isinstance(ck, tuple):
        return (max_diff(ck[0], rck[0]),
                float(((ck[1] - rck[1]).abs() / rck[1]).max()))
    return max_diff(ck, rck)


def worst(*errs):
    """The largest of several cache_diffs, element by element."""
    if isinstance(errs[0], tuple):
        return tuple(max(e[i] for e in errs) for i in range(len(errs[0])))
    return max(errs)


def cache_ok(fmt, err):
    """Whether a cache_diff is within the format's stated tolerance."""
    if fmt in KV8_FORMATS:
        return err[0] <= 1 and err[1] <= KV8_SCALE_RTOL[KV8_FORMATS[fmt]]
    return err <= cache_atol(fmt)


def batched_args(model, weights, ck, cv, pos, toks, starts=None):
    """K2's arguments in the snapshot's weight format; ``ck``/``cv`` may be
    the int8 KV cache's (rows, scales) pairs."""
    from pydynet_tpu_torch.models.llama.model import (decode_quant_kwargs,
                                                      decode_weight_args)

    dev = model.device
    kv = {}
    if isinstance(ck, tuple):
        (ck, sk), (cv, sv) = ck, cv
        kv = dict(sk=sk, sv=sv)
    return ((i32([pos], dev), i32(list(toks), dev),
             *decode_weight_args(weights), ck, cv),
            dict(n_heads=model.n_heads, **decode_quant_kwargs(weights),
                 starts=None if starts is None else i32(list(starts), dev),
                 **kv))


def cache_width(model, weights):
    """The fused lane's cache width for a snapshot: a grouped-query model's
    narrow Hkv * hd, else D (MHA, or the expanded layout)."""
    return (model.n_kv_heads * model.head_dim if "n_kv_heads" in weights
            else model.embed_dim)


def random_caches(model, dtype, seed, batch=None, kv8=False, width=None):
    """Seeded random caches: (N, S, W), or (N, B, S, W) for ``batch``, W
    ``width`` (D when not given); with ``kv8`` their int8 rows and scales
    (``quantize_kv``)."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    g = torch.Generator(device=model.device).manual_seed(seed)
    shape = (model.n_layers, model.max_seq_len, width or model.embed_dim)
    if batch is not None:
        shape = (model.n_layers, batch) + shape[1:]
    caches = [torch.randn(shape, generator=g, device=model.device)
              .mul_(0.5).to(dtype) for _ in range(2)]
    return [dsk.quantize_kv(c) for c in caches] if kv8 else caches


def clone_caches(ck, cv):
    if isinstance(ck, tuple):
        return tuple(c.clone() for c in ck), tuple(c.clone() for c in cv)
    return ck.clone(), cv.clone()


def batched_caches(model, fmt, seed, batch):
    """Random caches for K2 in ``fmt`` at the width of its snapshot."""
    dtype, quant = fmt_of(fmt)
    return random_caches(model, dtype, seed, batch, fmt in KV8_FORMATS,
                         cache_width(model, model._fused_weights(dtype,
                                                                 quant)))


def confident_rows(logits):
    """Whether each row's top-2 logit margin clears bf16 noise."""
    from pydynet_tpu_torch.utils.fidelity import REL_MARGIN, MARGIN

    srt = torch.sort(logits.float(), dim=-1).values
    top, margin = srt[..., -1], srt[..., -1] - srt[..., -2]
    return (margin > MARGIN + REL_MARGIN * top.abs()).cpu()


def max_diff(a, b):
    return float((a.float() - b.float()).abs().max())


def kernel_vs_plain(model, fmt, pos, tok=1234, seed=0):
    """One decode step through the kernel and through the plain version on
    the same inputs. Returns (kernel token, plain token, plain logits,
    max |cache difference|)."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    dtype, quant = FORMATS[fmt]
    w = model._fused_weights(dtype, quant)
    ck, cv = random_caches(model, dtype, seed, width=cache_width(model, w))
    args, kw = step_args(model, w, ck, cv, pos, tok)
    rck, rcv = ck.clone(), cv.clone()
    got = int(dsk.fused_decode_token(*args, **kw)[0])
    rargs = args[:-2] + (rck, rcv)
    logits = dsk.decode_token_logits_ref(*rargs, **kw)
    want = int(torch.argmax(logits))
    torch.cuda.synchronize()
    err = max(max_diff(ck, rck), max_diff(cv, rcv))
    return got, want, bool(confident_rows(logits)), err


def to_cpu(v):
    """A call's argument on the CPU: a tensor, or a tuple of them, copied."""
    if isinstance(v, torch.Tensor):
        return v.cpu()
    return tuple(to_cpu(t) for t in v) if isinstance(v, tuple) else v


def row_cache_diffs(ck, cv, rck, rcv):
    """``cache_diff`` of each batch row (dim 1) of two pairs of (N, B, S, W)
    caches, or of int8 KV caches' (rows, (N, B, S) scales) pairs: a list of
    B."""
    def rows(a, b):
        if isinstance(a, tuple):
            d = (a[0].float() - b[0].float()).abs().amax(dim=(0, 2, 3))
            r = ((a[1] - b[1]).abs() / b[1]).amax(dim=(0, 2))
            return list(zip(d.tolist(), r.tolist()))
        return (a.float() - b.float()).abs().amax(dim=(0, 2, 3)).tolist()

    return [worst(x, y) for x, y in zip(rows(ck, rck), rows(cv, rcv))]


def against_plain(errs, others, ok):
    """Hold each batch row of a kernel's step to the plain version, robust
    to int8 rounding ties. ``errs``: each row's errors against the plain
    version run on the card; ``ok(e)``: whether a row's errors are within
    the stated tolerances, which stay as they are. A row that fails is
    held instead to the next reference of ``others`` (callables, each
    giving every row's errors against it; called in order, and only while
    a row still fails): the plain version run on the CPU, and for the
    logits with the int8 KV cache the plain version teacher-forced on the
    kernel's own new cache rows where those differ from the plain step's
    only at ties and by float noise (``kv8_tie_gap``).

    Why this is the right check: the plain runs compute the same function
    with their float sums in other orders than the kernel. Where a value's
    ``x * 127 / amax`` lies within that float noise of a half integer (an
    activation of the int8/int4 layers, an entry of the int8 KV cache's
    new row), one run rounds it to the neighbouring integer, and the
    layers after it carry that step on. At such a value the reference is
    known only up to the choice of side: at pos 0 and B >= 31 the plain
    version on the card and on the CPU differ by 0.046875 in a bf16-int4
    cache row, beyond QUANT_CACHE_ATOL; and at pos 0, where a row attends
    to its new cache row alone, one int8 V step moves float32 logits by
    about 3e-4 of their scale, beyond EMIT_RTOL. A kernel row that
    matches the other plain run, or whose logits match the plain step
    given cache rows that differ from the plain step's own only on the
    other side of such ties (their scales within the same float noise),
    is as close to the plain version as the plain version is to itself. A
    row that matches no reference still fails, a KV entry off by a step
    where no tie is, or a scale off by more than noise, fails, and each
    row is held to one whole reference, not entry by entry. Returns (the errors kept, one
    per row; the reference each row took: 0 the card's, i the i-th of
    ``others``)."""
    errs = list(errs)
    took = [0] * len(errs)
    for i, other in enumerate(others, 1):
        bad = [b for b, e in enumerate(errs) if not ok(e)]
        if not bad:
            break
        alt = other()
        for b in bad:
            if ok(alt[b]):
                errs[b], took[b] = alt[b], i
    return errs, took


def kv8_tie_gap(got, rows):
    """How far a kernel's new int8 KV rows are from the plain step's,
    beyond rounding ties and float noise, in steps. ``got``: each layer's
    ((K int8 row, its scale), (V row, scale)) the kernel wrote; ``rows``:
    each layer's (K, V) float rows of the plain step that was given the
    kernel's rows of the layers before (``kv_rows`` of the teacher-forced
    step), quantized by ``quantize_kv``. Returns the largest of: the
    distance of an entry that differs from the plain one from the half
    step between the two (x / s against n + 1/2; inf when it differs by
    more than a step), and how far the kernel's scale moves the row's
    largest entry (127 |s_kernel / s - 1|). 0.0 when the rows are the
    plain step's. The rows are the plain step's up to ties and float
    noise when it is at most KV8_TIE_STEPS."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    gap = 0.0
    for pair, fpair in zip(got, rows):
        for (q, sq), x in zip(pair, fpair):
            x = x.float()
            want, s = dsk.quantize_kv(x)
            gap = max(gap, 127 * abs(float(sq) / float(s) - 1))
            d = q.int() - want.int()
            off = d != 0
            if not bool(off.any()):
                continue
            if bool((d.abs() > 1).any()):
                return float("inf")
            half = torch.minimum(q, want)[off].float() + 0.5
            gap = max(gap, float((x[off] / s - half).abs().max()))
    return gap


def forced_plain(args, kw, ck, cv, pos):
    """The plain batched step on ``args``/``kw`` (fresh int8 KV caches)
    teacher-forced on the new rows of the int8 KV caches ``ck``, ``cv``
    ((rows, scales) pairs, (N, B, S, W) and (N, B, S)) that a kernel wrote
    at ``pos``. Returns (its (B, V) logits, each batch row's
    ``kv8_tie_gap``)."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    kv = []
    logits = dsk.decode_token_batched_logits_ref(
        *args, forced=(ck[0], cv[0], ck[1], cv[1]), kv_rows=kv, **kw)
    p = min(pos, ck[0].shape[2] - 1)
    return logits, [kv8_tie_gap(
        [tuple((c[0][n, b, p], c[1][n, b, p]) for c in (ck, cv))
         for n in range(len(rows))], rows) for b, rows in enumerate(kv)]


def batched_inputs(model, fmt, batch, pos, seed):
    """Seeded inputs of one K2 step: (weights, caches, tokens, starts),
    rows starting in [0, min(pos, S - 1)], row 0 at pos itself."""
    w = model._fused_weights(*fmt_of(fmt))
    ck, cv = batched_caches(model, fmt, seed, batch)
    rng = np.random.default_rng(seed)
    p = min(pos, model.max_seq_len - 1)
    starts = rng.integers(0, p + 1, size=batch)
    starts[0] = p
    toks = rng.integers(0, model.vocab_size, size=batch)
    return w, ck, cv, toks, starts


def batched_plain_on_cpu(model, fmt, batch, pos, seed):
    """The plain batched step on the CPU, on the inputs ``batched_inputs``
    draws: (logits, ck, cv) after it, on the model's device."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    w, ck, cv, toks, starts = batched_inputs(model, fmt, batch, pos, seed)
    w = {k: to_cpu(v) for k, v in w.items()}
    ck, cv = to_cpu(ck), to_cpu(cv)
    model_cpu = types.SimpleNamespace(device=torch.device("cpu"),
                                      n_heads=model.n_heads)
    args, kw = batched_args(model_cpu, w, ck, cv, pos, toks, starts)
    logits = dsk.decode_token_batched_logits_ref(*args, **kw)
    dev = model.device
    back = (lambda c: tuple(t.to(dev) for t in c)) if isinstance(ck, tuple) \
        else (lambda c: c.to(dev))
    return logits.to(dev), back(ck), back(cv)


def batched_vs_plain(model, fmt, batch, pos, seed=0):
    """One batched step of ``batch`` rows through K2 and through its plain
    version on the same inputs (``batched_inputs``), each row held to the
    plain version by ``against_plain``. Returns (kernel tokens, plain
    tokens of each row's reference, confident rows, the worst of the rows'
    cache_diffs against their references)."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    w, ck, cv, toks, starts = batched_inputs(model, fmt, batch, pos, seed)
    rck, rcv = clone_caches(ck, cv)
    args, kw = batched_args(model, w, ck, cv, pos, toks, starts)
    rargs, rkw = batched_args(model, w, rck, rcv, pos, toks, starts)
    got = dsk.fused_decode_token_batched(*args, **kw).cpu()
    logits = dsk.decode_token_batched_logits_ref(*rargs, **rkw)
    torch.cuda.synchronize()
    want = logits.argmax(-1).cpu().int()
    cpu = []

    def cpu_errs():
        cpu.append(batched_plain_on_cpu(model, fmt, batch, pos, seed))
        return row_cache_diffs(ck, cv, *cpu[0][1:])

    errs, took = against_plain(row_cache_diffs(ck, cv, rck, rcv),
                               [cpu_errs], lambda e: cache_ok(fmt, e))
    for b in np.flatnonzero(took):
        want[b] = int(cpu[0][0][b].argmax())
    return got, want, confident_rows(logits), worst(*errs)


def emit_ok(fmt, err, scale):
    """Whether emitted logits are within the stated tolerance of the plain
    version's: float32 EMIT_RTOL[f32] of the logit scale, bfloat16,
    float16 and the quantized formats EMIT_RTOL[other]."""
    rtol = EMIT_RTOL["f32" if fmt in ("f32", "f32-kv8") else "other"]
    return err <= rtol * scale


def emit_vs_plain(model, fmt, pos, tok=1234, seed=0):
    """One K1 step in ``emit_logits`` mode, one in argmax mode and the
    plain version, on the same inputs. Returns (max |logit difference| to
    the plain logits, the plain logits' largest |value|, whether the
    emitted row's argmax is the argmax mode's token, max |cache difference|
    of the emitting step to the plain one)."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    dtype, quant = FORMATS[fmt]
    w = model._fused_weights(dtype, quant)
    ck, cv = random_caches(model, dtype, seed, width=cache_width(model, w))
    gck, gcv = ck.clone(), cv.clone()
    rck, rcv = ck.clone(), cv.clone()
    args, kw = step_args(model, w, ck, cv, pos, tok)
    lg = dsk.fused_decode_token(*args, emit_logits=True, **kw)
    greedy = dsk.fused_decode_token(*args[:-2], gck, gcv, **kw)
    ref = dsk.decode_token_logits_ref(*args[:-2], rck, rcv, **kw)
    torch.cuda.synchronize()
    same = int(torch.argmax(lg[0])) == int(greedy[0])
    err = max(max_diff(ck, rck), max_diff(cv, rcv))
    return (max_diff(lg[0], ref), float(ref.abs().max()), same, err)


def batched_emit_vs_plain(model, fmt, batch, pos, seed=0):
    """``batched_vs_plain`` for K2's ``emit_logits`` mode: the (B, V)
    logits against the plain version's and against K2's argmax mode on the
    same inputs, each row's logits and caches held to one reference by
    ``against_plain``. Returns (max |logit difference|, the plain logits'
    largest |value|, whether every row's argmax is the argmax mode's token,
    the worst cache_diff of the emitting step to the plain one)."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    w, ck, cv, toks, starts = batched_inputs(model, fmt, batch, pos, seed)
    gck, gcv = clone_caches(ck, cv)
    rck, rcv = clone_caches(ck, cv)
    args, kw = batched_args(model, w, ck, cv, pos, toks, starts)
    gargs, gkw = batched_args(model, w, gck, gcv, pos, toks, starts)
    rargs, rkw = batched_args(model, w, rck, rcv, pos, toks, starts)
    lg = dsk.fused_decode_token_batched(*args, emit_logits=True, **kw)
    greedy = dsk.fused_decode_token_batched(*gargs, **gkw)
    ref = dsk.decode_token_batched_logits_ref(*rargs, **rkw)
    torch.cuda.synchronize()
    same = bool(torch.equal(lg.argmax(-1).int(), greedy))
    scale = float(ref.abs().max())

    def row_errs(logits, c_k, c_v):
        d = (lg.float() - logits.float()).abs().amax(dim=-1).tolist()
        return list(zip(d, row_cache_diffs(ck, cv, c_k, c_v)))

    gaps = []

    def forced():  # the card's plain step given the kernel's new KV rows
        _, fck, fcv, _, _ = batched_inputs(model, fmt, batch, pos, seed)
        fargs, fkw = batched_args(model, w, fck, fcv, pos, toks, starts)
        logits, row_gaps = forced_plain(fargs, fkw, ck, cv, pos)
        gaps.extend(row_gaps)
        return [(e[0] if gap <= KV8_TIE_STEPS else float("inf"), e[1])
                for e, gap in zip(row_errs(logits, rck, rcv), row_gaps)]

    others = [lambda: row_errs(*batched_plain_on_cpu(model, fmt, batch, pos,
                                                      seed))]
    if fmt in KV8_FORMATS:
        others.append(forced)

    def ok(e):
        return emit_ok(fmt, e[0], scale) and cache_ok(fmt, e[1])

    errs, took = against_plain(row_errs(ref, rck, rcv), others, ok)
    for b, e in enumerate(errs):
        if took[b] == 2 or (gaps and not ok(e)):
            print(f"[chip_smoke] {fmt} B={batch} pos {pos} row {b}: "
                  f"{'held to' if ok(e) else 'fails'} the plain step "
                  f"teacher-forced on its new KV rows, {gaps[b]} steps "
                  f"from its own beyond ties (at most {KV8_TIE_STEPS})")
    return (max(e[0] for e in errs), scale, same,
            worst(*(e[1] for e in errs)))


def batched_rows_vs_one(model, fmt, batch=8, pos=512, seed=5):
    """K2 over ``batch`` rows starting at 0 against each row alone: through
    K1 (which has no int8 KV cache: K2 at B=1 for that). Returns (tokens
    equal, cache_diff)."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    w = model._fused_weights(*fmt_of(fmt))
    ck, cv = batched_caches(model, fmt, seed, batch)
    kv8 = fmt in KV8_FORMATS
    one = ((lambda c, b: tuple(t[:, b:b + 1].clone() for t in c)) if kv8
           else (lambda c, b: c[:, b].clone()))
    rows = [(one(ck, b), one(cv, b)) for b in range(batch)]
    toks = np.random.default_rng(seed).integers(0, model.vocab_size,
                                                size=batch)
    args, kw = batched_args(model, w, ck, cv, pos, toks)
    got = dsk.fused_decode_token_batched(*args, **kw).tolist()
    alone = []
    for b, (rk, rv) in enumerate(rows):
        if kv8:
            a1, k1 = batched_args(model, w, rk, rv, pos, [int(toks[b])])
            alone.append(int(dsk.fused_decode_token_batched(*a1, **k1)[0]))
        else:
            a1, k1 = step_args(model, w, rk, rv, pos, int(toks[b]))
            alone.append(int(dsk.fused_decode_token(*a1, **k1)[0]))
    if kv8:
        err = worst(*(cache_diff(tuple(t[:, b:b + 1] for t in c), r)
                      for b, (rk, rv) in enumerate(rows)
                      for c, r in ((ck, rk), (cv, rv))))
    else:
        err = max(max(max_diff(ck[:, b], rk), max_diff(cv[:, b], rv))
                  for b, (rk, rv) in enumerate(rows))
    return got == alone, err


def head_inputs(model, dtype, seed=0, tie=False):
    """K9's inputs at the model's head: a seeded normed-like h (1, D)
    float32 and the model's head (V, D) and bias in ``dtype``; with ``tie``
    the rows HEAD_TIE both hold the same row, aligned with h, and the same
    bias, so they tie for the maximum."""
    w = model._fused_weights(dtype)
    g = torch.Generator(device=model.device).manual_seed(seed)
    h = torch.randn(1, model.embed_dim, generator=g, device=model.device)
    head_w, head_b = w["head_w"], w["head_b"]
    if tie:
        head_w, head_b = head_w.clone(), head_b.clone()
        for r in HEAD_TIE:
            head_w[r] = (h[0].sign() * 0.5).to(dtype)
            head_b[r] = 1.0
    return h, head_w, head_b


def head_unrounded_inputs(model):
    """tests/test_torch_decode_step.py's not-rounded case at the model's
    head: a float32 h (1, D), 1 + 2**-9 and 1 + 2**-8 in its first two
    entries and zero elsewhere, against bfloat16 weights whose rows 0 and 1
    read those entries, and a zero bias. Unrounded, row 1 wins; h rounded to
    bfloat16 ties the two rows at 1.0, and row 0 wins."""
    dev, D, V = model.device, model.embed_dim, model.vocab_size
    h = torch.zeros(1, D, device=dev)
    h[0, 0], h[0, 1] = 1 + 2.0**-9, 1 + 2.0**-8
    w = torch.zeros(V, D, dtype=torch.bfloat16, device=dev)
    w[0, 0] = w[1, 1] = 1.0
    return h, w, torch.zeros(V, dtype=torch.bfloat16, device=dev)


def head_vs_plain(model, dtype, seed=0, tie=False, inputs=None):
    """K9 and its plain version on the same inputs (``inputs`` (h, w, b),
    else ``head_inputs``'). Returns (kernel token, plain token, the plain
    logit the kernel's token falls short of the plain maximum by)."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    h, w, b = inputs or head_inputs(model, dtype, seed, tie)
    got = int(dsk.lm_head_argmax(h, w, b)[0, 0])
    want = int(dsk.lm_head_argmax_ref(h, w, b)[0, 0])
    logits = w.float() @ h[0].float() + b.float()
    return got, want, float(logits.max() - logits[got])


def step_inputs(model, dtype, pos, tok=1234, seed=0):
    """K10's arguments at the model's width: h0 the embedding row of
    ``tok``, the RoPE rows of ``pos``, the pair-swap and head-mask
    matrices, the model's layer weights in ``dtype`` and seeded random
    caches."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    w = model._fused_weights(dtype)
    dev, D = model.device, model.embed_dim
    p = min(pos, model.max_seq_len - 1)
    tok %= model.vocab_size
    ck, cv = random_caches(model, dtype, seed)
    return (i32([pos], dev), w["tok"][tok:tok + 1].float(),
            w["cosD"][p:p + 1].float(), w["sinD"][p:p + 1].float(),
            dsk.rope_pair_swap_matrix(D).to(dev),
            dsk.head_mask_matrix(D, model.n_heads).to(dev), w["norm"],
            *(w[k] for k in ("wq", "wk", "wv", "wo", "gate_w", "up_w",
                             "down", "in_norm", "post_norm")), ck, cv)


def step_vs_plain(model, dtype, pos, seed=0):
    """K10 and its plain version on the same inputs, the caches copied
    (``alias=False``). Returns (max |h_out difference|, max |cache
    difference|, rows other than min(pos, S - 1) unchanged in both, the
    kernel's h_out)."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    args = step_inputs(model, dtype, pos, seed=seed)
    ck0, cv0 = args[-2:]
    h, ck, cv = dsk.fused_decode_step(*args, alias=False)
    rh, rck, rcv = dsk.fused_decode_step_ref(*args, alias=False)
    torch.cuda.synchronize()
    p = min(pos, model.max_seq_len - 1)
    rows = torch.ones(model.max_seq_len, dtype=torch.bool, device=h.device)
    rows[p] = False
    kept = all(torch.equal(new[:, rows], old[:, rows])
               for new, old in ((ck, ck0), (cv, cv0), (rck, ck0), (rcv, cv0)))
    return (max_diff(h, rh), max(max_diff(ck, rck), max_diff(cv, rcv)),
            kept, h)


def check_head_and_step(model, truth, margins, tops):
    """Phase 3e: K9 and K10 against their plain versions, then the path
    they make together (K10's layers, K9's head): a float32 greedy decode
    of PROMPT and the first PATH_STEPS - 1 truth tokens, one token a step
    from position 0, teacher-forced. Its token after each step from the
    prompt's last on must equal the truth at every confident step. Returns
    ({kernel: max error}, {kernel: launches on the path})."""
    from pydynet_tpu_torch.ops import decode_step as dsk
    from pydynet_tpu_torch.utils import fidelity

    err = {"lm_head_argmax": 0.0, "fused_decode_step": 0.0}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for seed in range(3):
            got, want, short = head_vs_plain(model, dtype, seed)
            print(f"[chip_smoke] K9 {name} seed {seed}: kernel {got} plain "
                  f"{want}, logit shortfall {short:.3g}")
            if got != want:
                raise AssertionError(f"K9 {name}: kernel {got} != plain "
                                     f"{want}")
            err["lm_head_argmax"] = max(err["lm_head_argmax"], short)
        got, want, _ = head_vs_plain(model, dtype, 7, tie=True)
        print(f"[chip_smoke] K9 {name} tie of rows {HEAD_TIE}: kernel {got} "
              f"plain {want}")
        if got != want or got != HEAD_TIE[0]:
            raise AssertionError(f"K9 {name} tie: kernel {got}, plain {want}"
                                 f", want {HEAD_TIE[0]}")
    # a float32 h against bfloat16 weights is not rounded to bfloat16
    h, w, b = head_unrounded_inputs(model)
    got = head_vs_plain(model, None, inputs=(h, w, b))[:2]
    rounded = head_vs_plain(model, None, inputs=(h.to(torch.bfloat16), w, b))
    print(f"[chip_smoke] K9 not-rounded case: kernel, plain {got}; h rounded "
          f"to bf16: kernel, plain {rounded[:2]}")
    if got != (1, 1) or rounded[:2] != (0, 0):
        raise AssertionError(f"K9 not-rounded case: {got}, rounded "
                             f"{rounded[:2]}; want (1, 1) and (0, 0)")
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        outs = {}
        for pos in STEP_POSITIONS:
            h_err, c_err, kept, outs[pos] = step_vs_plain(model, dtype, pos)
            print(f"[chip_smoke] K10 {name} pos {pos}: h_out err {h_err:.3g}"
                  f", cache err {c_err:.3g}, other rows kept {kept}")
            if h_err > STEP_ATOL[dtype] or c_err > CACHE_ATOL[dtype] \
                    or not kept:
                raise AssertionError(f"K10 {name} pos {pos}: h_out err "
                                     f"{h_err}, cache err {c_err}, kept "
                                     f"{kept}")
            err["fused_decode_step"] = max(err["fused_decode_step"], h_err)
        last = model.max_seq_len - 1
        if not torch.equal(outs[STEP_POSITIONS[-1]], outs[last]):
            raise AssertionError(f"K10 {name}: pos {STEP_POSITIONS[-1]} "
                                 f"differs from pos {last}")
    launches = head_and_step_path(model, truth, margins, tops)
    return err, launches


def head_and_step_path(model, truth, margins, tops, dtype=torch.float32):
    """The path K10 and K9 make together: a greedy decode of PROMPT and the
    first PATH_STEPS - 1 truth tokens in ``dtype``, one K10 (the layers)
    and one K9 (the head, on K10's float32 h) launch a token from position
    0, teacher-forced, with the counters zeroed just before it and read just
    after. Its token after each step from the prompt's last on must equal
    the float32 truth at every confident step. Returns {kernel: launches}."""
    from pydynet_tpu_torch.ops import decode_step as dsk
    from pydynet_tpu_torch.utils import fidelity

    w = model._fused_weights(dtype)
    dev, D, L = model.device, model.embed_dim, PROMPT.shape[1]
    rot = dsk.rope_pair_swap_matrix(D).to(dev)
    hmask = dsk.head_mask_matrix(D, model.n_heads).to(dev)
    ck, cv = model._flat_caches(*model._empty_caches(1, dtype), w)
    feed = list(PROMPT[0]) + [int(t) for t in truth[:PATH_STEPS - 1, 0]]
    toks = torch.tensor(feed, dtype=torch.long, device=dev)
    positions = torch.arange(len(feed), dtype=torch.int32, device=dev)
    outs = torch.empty(len(feed), 1, 1, dtype=torch.int32, device=dev)
    layers = [w[k] for k in ("wq", "wk", "wv", "wo", "gate_w", "up_w",
                             "down", "in_norm", "post_norm")]
    torch.cuda.synchronize()
    dsk.fused_decode_step.launches = dsk.lm_head_argmax.launches = 0
    for i in range(len(feed)):
        h, _, _ = dsk.fused_decode_step(
            positions[i:i + 1], w["tok"][toks[i]][None].float(),
            w["cosD"][i][None].float(), w["sinD"][i][None].float(), rot,
            hmask, w["norm"], *layers, ck, cv)
        dsk.lm_head_argmax(h, w["head_w"], w["head_b"], out=outs[i])
    launches = {"fused_decode_step": dsk.fused_decode_step.launches,
                "lm_head_argmax": dsk.lm_head_argmax.launches}
    got = outs[L - 1:, 0].cpu().numpy()  # (PATH_STEPS, 1)
    conf = fidelity._confident(margins[:PATH_STEPS], tops[:PATH_STEPS],
                               fidelity.MARGIN, fidelity.REL_MARGIN)
    ok = int((got[conf] == truth[:PATH_STEPS][conf]).sum())
    print(f"[chip_smoke] {dtype} K10 + K9 path: {len(feed)} steps, launches "
          f"{launches}, {ok}/{int(conf.sum())} confident steps equal the "
          f"f32 truth")
    if any(n != len(feed) for n in launches.values()):
        raise AssertionError(f"K10 + K9 path launches {launches}, want "
                             f"{len(feed)} each")
    if not conf.any() or ok != int(conf.sum()):
        raise AssertionError("K10 + K9 path differs from the truth at a "
                             "confident step")
    return launches


def time_k1(model, fmt, card, label=""):
    """K1's step at pos 512 in ``fmt`` beside its plain version, in turns:
    (kernel ms, plain ms, bound ms, bound by)."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    dtype, quant = FORMATS[fmt]
    w = model._fused_weights(dtype, quant)
    ck, cv = random_caches(model, dtype, 1)
    args, kw = step_args(model, w, ck, cv, 512, 1234)
    kern = lambda: dsk.fused_decode_token(*args, **kw)
    ref = lambda: dsk.fused_decode_token_ref(*args, **kw)
    plain, kernel = time_step(ref, 20), time_step(kern, 200)
    plain2, kernel2 = time_step(ref, 20), time_step(kern, 200)
    t = (min(kernel, kernel2), min(plain, plain2)) \
        + decode_step_bound(w, ck, 512, 1)
    print(f"[chip_smoke] {card}: {label}{fmt} step at pos 512: kernel "
          f"{t[0] * 1e3:.1f} us, plain {t[1] * 1e3:.1f} us, bound "
          f"{t[2] * 1e3:.1f} us ({t[3]})")
    return t


def time_k2(model, fmt, batch, card, label=""):
    """K2's step of ``batch`` rows at pos 512 in ``fmt`` beside its plain
    version, in turns: (kernel ms, plain ms, bound ms, bound by)."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    w = model._fused_weights(*fmt_of(fmt))
    ck, cv = batched_caches(model, fmt, 1, batch)
    args, kw = batched_args(model, w, ck, cv, 512, range(100, 100 + batch))
    kern = lambda: dsk.fused_decode_token_batched(*args, **kw)
    ref = lambda: dsk.fused_decode_token_batched_ref(*args, **kw)
    plain, kernel = time_step(ref, 3), time_step(kern, 200)
    plain2, kernel2 = time_step(ref, 3), time_step(kern, 200)
    t = (min(kernel, kernel2), min(plain, plain2)) \
        + decode_step_bound(w, ck, 512, batch)
    print(f"[chip_smoke] {card}: {label}K2 {fmt} B={batch} step at pos 512: "
          f"kernel {t[0] * 1e3:.1f} us, plain {t[1] * 1e3:.1f} us, bound "
          f"{t[2] * 1e3:.1f} us ({t[3]})")
    return t


def time_head_and_step(model, card):
    """Phase 5's K9 and K10 part: device time by CUDA-graph replay beside
    the bound, the plain version (CUDA events around a loop) and, for K9,
    ``torch.argmax(head_w @ h + b)``; in float32 and bfloat16, K10 at pos
    512. Returns {"K9 <fmt>" / "K10 <fmt>": (ms, plain_ms, bound_ms,
    bound_by, library_ms)}."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        h, w, b = head_inputs(model, dtype)
        hv = h[0].to(dtype)
        kern = lambda i: dsk.lm_head_argmax(h, w, b)
        lib = lambda i: torch.argmax(w @ hv + b)
        plain = lambda: dsk.lm_head_argmax_ref(h, w, b)
        k1, l1, p1 = time_graph(kern, 1, 50), time_graph(lib, 1, 50), \
            time_step(plain, 20)
        k2, l2, p2 = time_graph(kern, 1, 50), time_graph(lib, 1, 50), \
            time_step(plain, 20)
        V, D = w.shape
        b_ms, b_by = bound(nbytes(h, w, b) + 4, 2 * V * D, dtype)
        out["K9 " + name] = (min(k1, k2), min(p1, p2), b_ms, b_by,
                             min(l1, l2))
        print(f"[chip_smoke] {card}: K9 lm_head_argmax {name} ({V}, {D}): "
              f"kernel {min(k1, k2) * 1e3:.1f} us, plain "
              f"{min(p1, p2) * 1e3:.1f} us, torch.argmax(head_w @ h + b) "
              f"{min(l1, l2) * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us "
              f"({b_by})")
        pos = 512
        args = step_inputs(model, dtype, pos)
        kern = lambda i: dsk.fused_decode_step(*args)
        plain = lambda: dsk.fused_decode_step_ref(*args)
        k1, p1 = time_graph(kern, 1, 20), time_step(plain, 5)
        k2, p2 = time_graph(kern, 1, 20), time_step(plain, 5)
        N, S, D = args[-1].shape
        H = model.n_heads
        mats = args[7:14]
        rows = pos + 1
        n_bytes = (nbytes(*args[1:16]) + 4 * D
                   + 2 * N * D * args[-1].element_size() * (rows + 1))
        n_ops = N * (2 * sum(m.numel() for m in mats) + 4 * D * D
                     + 2 * rows * D * H + rows * D * (2 * H + 2))
        b_ms, b_by = bound(n_bytes, n_ops, dtype)
        out["K10 " + name] = (min(k1, k2), min(p1, p2), b_ms, b_by, None)
        print(f"[chip_smoke] {card}: K10 fused_decode_step {name} pos {pos}: "
              f"kernel {min(k1, k2) * 1e3:.1f} us, plain "
              f"{min(p1, p2) * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us "
              f"({b_by})")
    return out


def serve_requests(model, seed=0, n=N_REQUESTS):
    """``n`` seeded (prompt, max_new_tokens) requests: prompt lengths in
    [2, 16], max_new_tokens cycling over MAX_NEW."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, model.vocab_size,
                          size=int(rng.integers(2, 17))).tolist(),
             MAX_NEW[i % len(MAX_NEW)]) for i in range(n)]


def serve(model, requests, **kw):
    """One server run over ``requests``, (prompt, max_new_tokens) or
    (prompt, max_new_tokens, sampling overrides); returns (server, requests
    done)."""
    from pydynet_tpu_torch.models.llama.serve import LlamaServer

    srv = LlamaServer(model, **kw)
    rids = [srv.submit(r[0], max_new_tokens=r[1], **(r[2:] or ({},))[0])
            for r in requests]
    done = srv.run()
    torch.cuda.synchronize()
    return srv, [done[r] for r in rids]


def sampled_requests(model, cap=None):
    """The serving mix with per-request sampling overrides: every odd
    request seeded, every fourth overriding to greedy, the rest drawing
    from the server's defaults and keys; ``max_new_tokens`` capped at
    ``cap`` when given."""
    return [(p, min(n, cap or n), dict(temperature=0.0) if i % 4 == 0 else
             dict(seed=1000 + i) if i % 2 else {})
            for i, (p, n) in enumerate(serve_requests(model))]


def batch_prompt(batch):
    """bench.py's batched prompts: PROMPT shifted by 7 a row, BOS first."""
    prompt = np.tile(PROMPT, (batch, 1)) + np.arange(batch)[:, None] * 7
    prompt[:, 0] = 1
    return prompt


def busy_share(prof, wall):
    """Device busy seconds (the union of kernel intervals) over ``wall``."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in kernel_events(prof))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e6


def time_step(fn, n):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n  # ms per step


def enqueue_us(fn, n=20, rounds=10):
    """Host time per call of ``fn`` with no sync inside a round: the median
    over ``rounds`` rounds of ``n`` calls, each round started on an idle
    device so the launch queue (n x 32 launches) never fills."""
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - start) / n * 1e6)
        torch.cuda.synchronize()
    return float(np.median(times))


def kernel_events(prof):
    """The profiler's device-side kernel events."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def by_kernel(prof, n, label, top=None):
    """Print the device time of each kernel over ``n`` steps (the ``top``
    largest when given)."""
    by_name = {}
    for e in kernel_events(prof):
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    total = sum(t for t, _ in by_name.values()) / n
    print(f"[chip_smoke] profile {label}, device time by kernel over {n} "
          f"steps:")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (t, c) in ranked[:top]:
        print(f"[chip_smoke]   {t / n:8.2f} us/step "
              f"{100 * t / n / total:5.1f} % x{c // n}  {name[:70]}")
    print(f"[chip_smoke]   device total {total:.1f} us/step")


def by_stage(prof, n, label):
    """Print the device time of each decode-step stage over ``n`` steps
    (kernel_times.py's stages: q/k/v, attention, wo, gate/up, down, head,
    argmax) and the kernels a step."""
    from kernel_times import stage_of

    events = kernel_events(prof)
    stages = {}
    for e in events:
        stage = stage_of(e.name)
        stages[stage] = stages.get(stage, 0.0) + e.time_range.elapsed_us() / n
    print(f"[chip_smoke] profile {label}, device time by stage: " +
          ", ".join(f"{k} {t:.1f} us" for k, t in stages.items()) +
          f"; {len(events) / n:.0f} kernels a step")


def profile(model, card):
    """Phase 6: where a decode step's time goes on the card."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from pydynet_tpu_torch.ops import decode_step as dsk

    print(f"[chip_smoke] profile on {card}")
    cuda = [ProfilerActivity.CUDA]
    n = 50
    with torch.no_grad():
        for fmt in B1_FORMATS:
            dtype, quant = FORMATS[fmt]
            w = model._fused_weights(dtype, quant)
            ck, cv = random_caches(model, dtype, 1)
            for pos in (0, 512, 1023):
                args, kw = step_args(model, w, ck, cv, pos, 1234)
                step = lambda: dsk.fused_decode_token(*args, **kw)
                ev = time_step(step, 200) * 1e3
                print(f"[chip_smoke] profile {fmt} pos {pos}: event "
                      f"{ev:.1f} us/step, host enqueue "
                      f"{enqueue_us(step):.1f} us/call")
            if fmt == "f32":
                continue
            args, kw = step_args(model, w, ck, cv, 512, 1234)
            with torch_profile(activities=cuda) as prof:
                for _ in range(n):
                    dsk.fused_decode_token(*args, **kw)
                torch.cuda.synchronize()
            by_kernel(prof, n, f"K1 {fmt} pos 512")
            by_stage(prof, n, f"K1 {fmt} pos 512")
        w = model._fused_weights(torch.bfloat16, None)
        ck, cv = random_caches(model, torch.bfloat16, 1, 8)
        args, kw = batched_args(model, w, ck, cv, 512, range(100, 108))
        step = lambda: dsk.fused_decode_token_batched(*args, **kw)
        print(f"[chip_smoke] profile K2 bf16 B=8 pos 512: event "
              f"{time_step(step, 200) * 1e3:.1f} us/step, host enqueue "
              f"{enqueue_us(step):.1f} us/call")
        with torch_profile(activities=cuda) as prof:
            for _ in range(n):
                step()
            torch.cuda.synchronize()
        by_kernel(prof, n, "K2 bf16 B=8 pos 512")
        by_stage(prof, n, "K2 bf16 B=8 pos 512")
        del ck, cv
        for quant in (None, "int8-head"):
            with torch_profile(activities=cuda) as prof:
                start = time.perf_counter()
                n_tok = sum(1 for _ in model.generate(PROMPT, REQUEST,
                                                      dtype=torch.bfloat16,
                                                      quant=quant))
                torch.cuda.synchronize()
                wall = time.perf_counter() - start
            busy = busy_share(prof, wall)
            print(f"[chip_smoke] profile generate bf16 quant={quant} under "
                  f"the profiler: {n_tok} tokens in {wall:.3f} s, device "
                  f"busy {busy:.3f} s = {100 * busy / wall:.1f} %, idle "
                  f"{100 - 100 * busy / wall:.1f} %")
    requests = serve_requests(model)
    with torch_profile(activities=cuda) as prof:
        start = time.perf_counter()
        srv, done = serve(model, requests, dtype=torch.bfloat16, **SERVE)
        wall = time.perf_counter() - start
    busy = busy_share(prof, wall)
    n_tok = sum(len(r.tokens) for r in done)
    print(f"[chip_smoke] profile serve bf16 B=8 under the profiler: {n_tok} "
          f"tokens, {srv.dispatched_steps} steps in {wall:.3f} s, device "
          f"busy {busy:.3f} s = {100 * busy / wall:.1f} %, idle "
          f"{100 - 100 * busy / wall:.1f} %")
    del srv, done
    n = 5
    for B in (1, 8):  # the training step
        tm, opt = train_model("cuda")
        inp, tgt = train_pair(B)
        tm.finetune_steps(inp, tgt, opt, 2)  # warm-up
        torch.cuda.synchronize()
        with torch_profile(activities=cuda) as prof:
            start = time.perf_counter()
            tm.finetune_steps(inp, tgt, opt, n)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
        by_kernel(prof, n, f"train step B={B} L={TRAIN_L} f32", top=25)
        busy = busy_share(prof, wall)
        print(f"[chip_smoke] profile train step B={B} under the profiler: "
              f"{n} steps in {wall:.3f} s, {len(kernel_events(prof)) // n} "
              f"kernels a step, device busy {busy:.3f} s = "
              f"{100 * busy / wall:.1f} %, idle "
              f"{100 - 100 * busy / wall:.1f} %")
        del tm, opt


def profile_big(model):
    """Phase 6's 7B part: the device time by kernel of Llama-2-7B int8 and
    int4 tokens on the scan lane, and the device's busy share over them."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    bf16, n = torch.bfloat16, 8
    with torch.no_grad():
        for quant in ("int8", "int4"):
            w = model._weights_xq(bf16, quant)
            ck, cv = model._empty_caches(1, bf16)
            tok = model.prefill(w, ck, cv, PROMPT).to(torch.int32)
            model.decode_chunk_plain(w, ck, cv, tok, PROMPT.shape[1], 2)
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                start = time.perf_counter()
                model.decode_chunk_plain(w, ck, cv, tok, PROMPT.shape[1] + 2,
                                         n)
                torch.cuda.synchronize()
                wall = time.perf_counter() - start
            by_kernel(prof, n, f"7B {quant} token, scan lane", top=12)
            busy = busy_share(prof, wall)
            print(f"[chip_smoke] profile 7B {quant}: {n} tokens in "
                  f"{wall:.3f} s, {len(kernel_events(prof)) // n} kernels a "
                  f"token, {busy / n * 1e6:.1f} us of device time a token "
                  f"({wall / n * 1e3:.2f} ms a token), device busy "
                  f"{busy:.3f} s = "
                  f"{100 * busy / wall:.1f} %, idle "
                  f"{100 - 100 * busy / wall:.1f} %")
            del ck, cv


def profile_prefix(model):
    """Phase 6's part for phase 4p: the device time by kernel and the busy
    share of a reuse admission, a full admission (a prompt sharing no
    prefix) and 4 decode steps of the 7B int8 kv8 prefix-cache server at
    B=4, as phase 4p serves them."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from pydynet_tpu_torch.models.llama.serve import LlamaServer

    requests, other = prefix_requests(model), prefix_requests(model, seed=1)
    with torch.no_grad():
        srv = LlamaServer(model, dtype=torch.bfloat16, quant="int8",
                          prefix_cache=True, **PREFIX_SERVE)
        srv.submit(requests[0][0], max_new_tokens=PREFIX_SYSTEM)
        srv.step()  # a full admission, then two chunks: the donor is
        srv.step()  # resident and every prompt fits below the position
        for label, prompt, n in (("reuse admission", requests[1][0], 1),
                                 ("full admission", other[0][0], 1),
                                 ("decode steps", None, 4)):
            if prompt is not None:
                srv.submit(prompt, max_new_tokens=PREFIX_SYSTEM)
            torch.cuda.synchronize()
            hits = srv.prefix_hits
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                start = time.perf_counter()
                if prompt is None:
                    srv._decode(n)
                else:
                    srv._try_admit()
                torch.cuda.synchronize()
                wall = time.perf_counter() - start
            if (label == "reuse admission") != (srv.prefix_hits > hits):
                raise AssertionError(f"profile: the {label} was not one")
            by_kernel(prof, n, f"7B int8 kv8 B=4 {label}", top=10)
            busy = busy_share(prof, wall)
            print(f"[chip_smoke] profile 7B int8 kv8 B=4 {label}: "
                  f"{wall / n * 1e3:.2f} ms each, "
                  f"{len(kernel_events(prof)) // n} kernels each, device "
                  f"busy {100 * busy / wall:.1f} %")


def check_f32_server(model, label=""):
    """A float32 B=4 server against standalone float32 ``generate`` (K1) on
    each of 8 prompts, both against the eager float32 stream, up to each
    stream's first near-tie."""
    from pydynet_tpu_torch.utils import fidelity

    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, model.vocab_size,
                            size=int(rng.integers(2, 17))).tolist()
               for _ in range(8)]
    _, done = serve(model, [(p, 48) for p in prompts], dtype=torch.float32,
                    batch_size=4, chunk=128, eos_id=-1)
    compared = 0
    for p, req in zip(prompts, done):
        truth, margins, _ = fidelity.greedy_truth(model, np.array([p]), 48)
        conf = fidelity._confident(margins[:, 0], None, F32_MARGIN, 0.0)
        k = int(np.argmin(conf)) if not conf.all() else len(conf)
        alone = [int(t[0, 0]) for t in model.generate(
            np.array([p]), len(p) + 48, dtype=torch.float32)]
        if req.tokens[:k] != alone[:k] or alone[:k] != truth[:k, 0].tolist():
            raise AssertionError(f"f32 server stream {req.tokens[:k]} != "
                                 f"generate {alone[:k]} (truth "
                                 f"{truth[:k, 0].tolist()})")
        compared += k
    print(f"[chip_smoke] {label}f32 server B=4 vs standalone f32 generate: "
          f"{compared} tokens equal up to each stream's first near-tie")
    if compared < 100:
        raise AssertionError(f"only {compared} f32 tokens compared")


def check_serving(model):
    """Phase 4b: the serving path through K2. Returns K2's launches."""
    from pydynet_tpu_torch.models.llama import Llama, serve_cli
    from pydynet_tpu_torch.ops import decode_step as dsk
    from pydynet_tpu_torch.utils import fidelity

    k2 = dsk.fused_decode_token_batched
    requests = serve_requests(model)
    for kw in SERVE_FORMATS.values():  # warm-up
        serve(model, requests[:2], dtype=torch.bfloat16, **kw, **SERVE)
    k2.launches = 0
    for name, kw in SERVE_FORMATS.items():
        before = k2.launches
        start = time.perf_counter()
        srv, done = serve(model, requests, dtype=torch.bfloat16, **kw,
                          **SERVE)
        wall = time.perf_counter() - start
        launched = k2.launches - before
        n_tok = sum(len(r.tokens) for r in done)
        print(f"[chip_smoke] serve {name} B=8: {len(done)} requests, "
              f"{n_tok} tokens, {sum(r.truncated for r in done)} truncated, "
              f"{srv.dispatched_steps} steps dispatched, {launched} K2 "
              f"launches, {n_tok / wall:.1f} tok/s")
        if not all(r.done and r.tokens for r in done):
            raise AssertionError(f"serve {name}: a request did not finish")
        if not all(0 <= t < model.vocab_size for r in done for t in r.tokens):
            raise AssertionError(f"serve {name}: token out of range")
        if not any(r.truncated for r in done):
            raise AssertionError(f"serve {name}: no request reached the "
                                 "cache end")
        if launched != srv.dispatched_steps:
            raise AssertionError(f"serve {name}: {launched} launches for "
                                 f"{srv.dispatched_steps} dispatched steps")
    serve_launches = k2.launches
    check_f32_server(model)

    # the batched argmax gates (bench.py's batched-b4, -b32, -b4-int8head;
    # -b4-int8 and -b4-kvint8 by majority agreement with the f32 stream)
    gates = ((4, dict(quant=None)), (4, dict(quant="int8-head")),
             (4, dict(quant="int8", min_agree=INT4_MIN_AGREE)),
             (4, dict(kv_quant="int8", min_agree=INT4_MIN_AGREE)),
             (32, dict(quant=None)))
    for batch in (4, 32):
        prompt = batch_prompt(batch)
        truth, margins, tops = fidelity.greedy_truth(model, prompt, 64)
        for kw in (kw for b, kw in gates if b == batch):
            checked, ok, agree = fidelity.gate_fused_argmax(
                model, prompt, truth, margins, tops, dtype=torch.bfloat16,
                **kw)
            print(f"[chip_smoke] gate B={batch} bf16 {kw}: checked "
                  f"{checked} ok {ok} agree {agree:.3f}")
            if not (checked > 0 and ok):
                raise AssertionError(f"batched gate failed: B={batch}, {kw}")
    # batched-b4-int4: majority agreement with the int4 round trip's stream
    rt = fidelity.dequant_inplace(
        Llama(**CFG, device="cuda",
              generator=torch.Generator().manual_seed(0)).eval(), "int4")
    prompt = batch_prompt(4)
    t_rt, m_rt, top_rt = fidelity.greedy_truth(rt, prompt, 64)
    checked, ok, agree = fidelity.gate_fused_argmax(
        rt, prompt, t_rt, m_rt, top_rt, dtype=torch.bfloat16, quant="int4",
        min_agree=INT4_MIN_AGREE)
    print(f"[chip_smoke] gate B=4 bf16 quant=int4 (against the int4 "
          f"round-trip truth, majority): checked {checked} ok {ok} agree "
          f"{agree:.3f}")
    if not (checked > 0 and ok):
        raise AssertionError("batched gate failed: B=4, quant=int4")
    del rt

    # generate at B=8 through K2
    steps = REQUEST - PROMPT.shape[1] - 1
    before = k2.launches
    rows = list(model.generate(batch_prompt(8), REQUEST,
                               dtype=torch.bfloat16))
    launched = k2.launches - before
    print(f"[chip_smoke] generate bf16 B=8: {len(rows)} rows, {launched} K2 "
          f"launches")
    if launched != steps or len(rows) != steps + 1 \
            or any(r.shape != (8, 1) for r in rows):
        raise AssertionError(f"generate B=8: {launched} launches, "
                             f"{len(rows)} rows; want {steps} steps")

    for extra in ([], ["--kv-quant", "int8"]):
        before = k2.launches
        serve_cli.main(["--random-init", "--device", "cuda", "--batch-size",
                        "8", "--max-new-tokens", "64", *extra])
        if k2.launches == before:
            raise AssertionError(f"serve CLI {extra} did not run the batched "
                                 "kernel")
    return serve_launches


FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")


def flash_counters():
    from pydynet_tpu_torch.ops import flash_attention as fa

    return [getattr(fa, name) for name in FLASH_KERNELS]


def flash_inputs(B, L, dtype, seed=0, d=48, heads=CFG["n_heads"]):
    """Seeded q, k, v and dO, (B, L, heads, d) on the card: (B, L, 6, 48)
    unless told otherwise."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((B, L, heads, d), generator=g,
                        device="cuda").to(dtype) for _ in range(4)]


def flash_vs_plain(B, L, dtype, seed=0, d=48, heads=CFG["n_heads"],
                   backward=True):
    """K3 and (with ``backward``) both K4 kernels against their plain
    versions on the same inputs (the backward ones given the kernel
    forward's o and lse). Raises beyond ``FLASH_ATOL``; returns {output:
    max |kernel - plain|}."""
    from pydynet_tpu_torch.ops import flash_attention as fa

    q, k, v, do = flash_inputs(B, L, dtype, seed, d, heads)
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v)
    plain = dict(zip(("o", "lse"), fa.flash_attention_fwd_ref(q, k, v,
                                                              scale)))
    outs = dict(o=o, lse=lse)
    if backward:
        dd = fa.attention_dd(o, do)
        outs["dq"] = fa.flash_attention_bwd_dq(q, k, v, do, lse, dd)
        outs["dk"], outs["dv"] = fa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                          dd)
        plain["dq"] = fa.flash_attention_bwd_dq_ref(q, k, v, do, lse, dd,
                                                    scale)
        plain["dk"], plain["dv"] = fa.flash_attention_bwd_dkv_ref(
            q, k, v, do, lse, dd, scale)
    torch.cuda.synchronize()
    errs = {}
    for name, got in outs.items():
        want = plain[name].float()
        err = (got.float() - want).abs()
        tol = FLASH_ATOL[name] + ULP16.get(got.dtype, 0.0) * want.abs()
        if got.shape != want.shape or not bool((err <= tol).all()):
            raise AssertionError(f"flash {name} B={B} L={L} d={d} "
                                 f"{dtype}: max error {float(err.max())} "
                                 f"beyond tolerance")
        errs[name] = float(err.max())
    return errs


FLASH_PRODUCTS = {"flash_attention_fwd": 2, "flash_attention_bwd_dq": 3,
                  "flash_attention_bwd_dkv": 4}  # matrix products a kernel


def sdpa_ms(q, k, v, do):
    """The library yardstick of K3/K4 (timed, never used by the port):
    ``F.scaled_dot_product_attention(is_causal=True)`` forward, and its
    autograd backward, on the same (B, L, H, d) inputs."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    with torch.no_grad():
        fwd = time_step(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 50)
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    bwd = time_step(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                retain_graph=True), 50)
    return fwd, bwd


def train_model(device):
    """The stories15M model from seed 0 with every parameter trainable, its
    Adam, and a seeded (1, TRAIN_L) token pair."""
    from pydynet_tpu_torch.models.llama import Llama
    from pydynet_tpu_torch.optim import Adam

    model = Llama(**TRAIN_CFG, device=device,
                  generator=torch.Generator().manual_seed(0))
    model.set_trainable_parameters(TRAIN_PREFIXES)
    opt = Adam([p for p in model.parameters() if p.requires_grad],
               lr=TRAIN_LR)
    return model, opt


def train_pair(batch=1, seed=0):
    ids = np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], size=(batch, TRAIN_L + 1))
    return ids[:, :-1], ids[:, 1:]


def check_step_vs_cpu(gpu, cpu, w_atol=TRAIN_W_ATOL, skip=()):
    """A model after one step on the card against the same step on the CPU:
    gradients within ``TRAIN_GRAD_RTOL`` of each tensor's largest element and
    weights within ``w_atol`` (lr / 10 of the step), for every parameter not
    named in ``skip``. Returns the largest (gradient, weight) differences."""
    g_err = w_err = 0.0
    theirs = dict(cpu.named_parameters())
    for name, p in gpu.named_parameters():
        if name in skip:
            continue
        c = theirs[name]
        dg = float((p.grad.cpu() - c.grad).abs().max())
        dw = float((p.detach().cpu() - c.detach()).abs().max())
        if dg > TRAIN_GRAD_RTOL * float(c.grad.abs().max()) + 1e-12 \
                or dw > w_atol:
            raise AssertionError(f"first step vs CPU: {name} gradient "
                                 f"error {dg}, weight error {dw}")
        g_err, w_err = max(g_err, dg), max(w_err, dw)
    return g_err, w_err


ADAM_EPS1 = 1e-8 / (1 - 0.999) ** 0.5  # eps' of Adam's first step


def check_adam_step_vs_cpu(gpu, cpu, lr, noise=None):
    """The training gate, elementwise, for a first Adam step (betas 0.9,
    0.999, eps 1e-8) on the card against the CPU's: gradients within
    ``TRAIN_GRAD_RTOL`` of each tensor's largest; each weight within lr / 10
    where its CPU gradient is above 10 eps', and within 2 lr below that.
    The step moves a weight by lr g / (|g| + eps'), eps' = 3.2e-7, whose
    slope in g is lr eps' / (|g| + eps')^2: above 10 eps' a gradient
    difference d moves the weight by under lr d / (100 eps'), far below
    lr / 10 for any d the gradient gate allows here; near zero (a bias
    before a normalization, a row no token reached) the step is up to lr
    either way on each device. ``noise`` maps a bias whose gradient is
    rounding noise on both devices (one before a normalization that takes
    away a constant shift) to its layer's weight, whose largest gradient
    scales its gate instead of its own. Parameters that do not train are
    skipped. Returns (largest gradient error, largest such weight error,
    the count of weights under 10 eps')."""
    g_err = w_err = 0.0
    small = 0
    theirs = dict(cpu.named_parameters())
    for name, p in gpu.named_parameters():
        if not p.requires_grad:
            continue
        c = theirs[name]
        g = c.grad
        dg = float((p.grad.cpu() - g).abs().max())
        scale = theirs[(noise or {}).get(name, name)].grad
        if dg > TRAIN_GRAD_RTOL * float(scale.abs().max()) + 1e-12:
            raise AssertionError(f"first Adam step vs CPU: {name} gradient "
                                 f"error {dg}")
        dw = (p.detach().cpu() - c.detach()).abs()
        near = g.abs() < 10 * ADAM_EPS1
        if bool((dw > torch.where(near, 2 * lr, lr / 10)).any()):
            raise AssertionError(f"first Adam step vs CPU: {name} weight "
                                 f"error {float(dw.max())}")
        g_err = max(g_err, dg)
        w_err = max(w_err, float(dw[~near].max()) if bool((~near).any())
                    else 0.0)
        small += int(near.sum())
    return g_err, w_err, small


def check_training():
    """Phase 4c: K3/K4 against plain, the fine-tune through them, the CLI.
    Returns ({kernel: launches in the main run}, {kernel: max f32 error},
    {kernel: max f16 error})."""
    from pydynet_tpu_torch.models.llama import finetune

    errs = {d: {name: 0.0 for name in FLASH_KERNELS} for d in ("f32", "f16")}
    for dname, dtype in DTYPES.items():
        for B in FLASH_BATCHES:
            for L in FLASH_LENGTHS:
                e = flash_vs_plain(B, L, dtype)
                print(f"[chip_smoke] flash {dname} B={B} L={L}: max error "
                      + ", ".join(f"{k} {v:.3g}" for k, v in e.items()))
                if dname in errs:
                    for name, keys in zip(FLASH_KERNELS,
                                          (("o", "lse"), ("dq",),
                                           ("dk", "dv"))):
                        errs[dname][name] = max([errs[dname][name]]
                                                + [e[x] for x in keys])

    inp, tgt = train_pair()
    gpu, opt = train_model("cuda")
    cpu, cpu_opt = train_model("cpu")
    counters = flash_counters()
    for c in counters:
        c.launches = 0
    losses = [gpu.finetune_steps(inp, tgt, opt, 1)]
    t0 = time.perf_counter()
    cpu_loss = cpu.finetune_step(inp, tgt, cpu_opt)
    cpu_s = time.perf_counter() - t0
    gpu_loss = float(losses[0][0])
    g_err, w_err = check_step_vs_cpu(gpu, cpu)
    print(f"[chip_smoke] train step 1 vs CPU ({cpu_s:.1f} s there): loss "
          f"{gpu_loss:.6f} vs {cpu_loss:.6f}, max gradient error "
          f"{g_err:.3g}, max weight error {w_err:.3g}")
    if abs(gpu_loss - cpu_loss) > TRAIN_LOSS_RTOL * abs(cpu_loss):
        raise AssertionError(f"first step loss {gpu_loss} != CPU {cpu_loss}")
    losses.append(gpu.finetune_steps(inp, tgt, opt, TRAIN_STEPS - 1))
    losses = torch.cat(losses).tolist()
    launches = {name: c.launches for name, c in zip(FLASH_KERNELS, counters)}
    print(f"[chip_smoke] fine-tune stories15M B=1 L={TRAIN_L}, all "
          f"parameters, Adam lr {TRAIN_LR}: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; launches {launches}")
    want = CFG["n_layers"] * TRAIN_STEPS
    if any(n != want for n in launches.values()):
        raise AssertionError(f"launches {launches}, want {want} each")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"the loss did not fall: {losses}")

    before = [c.launches for c in counters]
    cli = finetune.main(["--random-init", "--device", "cuda", "--trainable",
                         ",".join(TRAIN_PREFIXES), "--steps", "5", "--lr",
                         "1e-3", "--text", TRAIN_TEXT, "--save",
                         "build/chip_smoke_finetuned.npz"])
    ran = [c.launches - b for c, b in zip(counters, before)]
    print(f"[chip_smoke] finetune CLI: losses {cli}, launches {ran}")
    if ran != [CFG["n_layers"] * 5] * 3 or not cli[-1] < cli[0]:
        raise AssertionError("finetune CLI did not train through the "
                             "kernels")
    return launches, errs["f32"], errs["f16"]


def time_flash(B, L, card, dtype=torch.float32, d=48, heads=CFG["n_heads"],
               backward=True):
    """K3 and (with ``backward``) both K4 kernels on (B, L, heads, d) inputs
    of ``dtype`` beside their plain versions (in turns), their bounds and
    the SDPA forward and backward: {kernel: (ms, plain_ms, bound_ms,
    bound_by, library_ms)}."""
    from pydynet_tpu_torch.ops import flash_attention as fa

    out = {}
    scale = d ** -0.5
    q, k, v, do = flash_inputs(B, L, dtype, 1, d, heads)
    o, lse = fa.flash_attention_fwd(q, k, v)
    dd = fa.attention_dd(o, do)
    pairs = {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v),
            lambda: fa.flash_attention_fwd_ref(q, k, v, scale)),
        "flash_attention_bwd_dq": (
            lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, dd),
            lambda: fa.flash_attention_bwd_dq_ref(q, k, v, do, lse, dd,
                                                  scale)),
        "flash_attention_bwd_dkv": (
            lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, dd),
            lambda: fa.flash_attention_bwd_dkv_ref(q, k, v, do, lse, dd,
                                                   scale)),
    }
    if not backward:
        del pairs["flash_attention_bwd_dq"], pairs["flash_attention_bwd_dkv"]
    lib = sdpa_ms(q, k, v, do)
    for name, (kern, ref) in pairs.items():
        plain, kernel = time_step(ref, 10), time_step(kern, 50)
        kernel2, plain2 = time_step(kern, 50), time_step(ref, 10)
        b_ms, b_by = flash_bound(q, FLASH_PRODUCTS[name], True)
        t = out[name] = (min(kernel, kernel2), min(plain, plain2), b_ms,
                         b_by, lib[name != "flash_attention_fwd"])
        way = "forward" if name == "flash_attention_fwd" else "backward"
        print(f"[chip_smoke] {card}: {name} {dtype} {tuple(q.shape)}: kernel "
              f"{t[0] * 1e3:.1f} us, plain {t[1] * 1e3:.1f} us, bound "
              f"{b_ms * 1e3:.1f} us ({b_by}), "
              f"F.scaled_dot_product_attention {way} {t[4] * 1e3:.1f} us")
    return out


def time_training(card):
    """Phase 5's training part: K3 and K4 against plain, then the step."""
    ms = {(name, B): t for B in (1, 8)
          for name, t in time_flash(B, TRAIN_L, card).items()}
    runs = {}
    for B in (1, 8):
        model, opt = train_model("cuda")
        inp, tgt = train_pair(B)
        model.finetune_steps(inp, tgt, opt, 2)  # warm-up
        runs[B] = (model, opt, inp, tgt, [])
    for _ in range(REPEATS):  # the batches in turns
        for B, (model, opt, inp, tgt, times) in runs.items():
            torch.cuda.synchronize()
            start = time.perf_counter()
            model.finetune_step(inp, tgt, opt, sync=False)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
    for B, (*_, times) in runs.items():
        step = float(np.median(times))
        print(f"[chip_smoke] {card}: train step B={B} L={TRAIN_L} f32, all "
              f"parameters: ms of {REPEATS} steps "
              f"{', '.join(f'{t * 1e3:.2f}' for t in times)}; median "
              f"{step * 1e3:.2f} ms, {B * TRAIN_L / step:.1f} training "
              f"tokens/s")
    return ms


def bound(n_bytes, n_ops, dtype):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak for ``dtype`` (a key of ``PEAK_OPS_S``)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / PEAK_OPS_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def decode_step_bound(w, ck, pos, rows, emit=False):
    """K1/K2's bound at ``pos`` for ``rows`` rows: every weight once, as
    stored (int8, or int4 two a byte, with its scales), the embedding's
    ``rows`` rows, each row's cache rows [0, pos] read and its new row
    written, in the cache type (the int8 KV cache's rows with their float32
    scales), and with ``emit`` the float32 (rows, V) logits written;
    operations two a weight and two a cache element a row, at the weight
    type's peak."""
    from pydynet_tpu_torch.models.llama.model import (FUSED_MATS,
                                                      decode_weight_args)

    kv8 = isinstance(ck, tuple)
    if kv8:
        ck = ck[0]
    N, W = ck.shape[0], ck.shape[-1]  # W: the cache width (narrow: Dkv)
    D = w["tok"].shape[1]
    mats = list(decode_weight_args(w)[4:4 + len(FUSED_MATS)])
    scales = [w[k + "_s"] for k in FUSED_MATS] if "wq_s" in w else []
    head = [w["head_wq"], w["head_s"]] if "head_s" in w else [w["head_w"]]
    small = [w[k] for k in ("norm", "in_norm", "post_norm", "head_b")]
    it = w["tok"].element_size()
    row_bytes = W * ck.element_size() + (4 if kv8 else 0)
    kv = rows * N * 2 * row_bytes * (pos + 2)  # pos + 1 rows read, 1 written
    n_bytes = nbytes(*mats, *scales, *head, *small) + rows * D * it * 3 + kv
    if emit:
        n_bytes += 4 * rows * w["head_b"].numel()
    per_byte = 2 if "q4" in w else 1  # weights a stored element holds
    n_ops = 2 * rows * per_byte * (sum(m.numel() for m in mats)
                                   + head[0].numel()) \
        + 4 * rows * N * D * (pos + 1)  # every query head's scores and p @ V
    return bound(n_bytes, n_ops, w["tok"].dtype)


def flash_bound(q, products, tensor_cores=False):
    """K3/K4's bound on (B, L, H, d) inputs: q, k, v (and dO, o) read once,
    outputs written once; ``products`` matrix products of the causal
    L (L + 1) / 2 query-key pairs, two operations a multiply-add, at the
    float32 peak, or with ``tensor_cores`` (K3 and K4) at float32 accuracy
    on the tensor cores (3xTF32) for float32 inputs."""
    B, L, H, d = q.shape
    n_bytes = nbytes(q) * {2: 4, 3: 6, 4: 7}[products]
    n_ops = 2 * products * B * H * d * L * (L + 1) // 2
    rate = "3xtf32" if tensor_cores and q.dtype == torch.float32 \
        else q.dtype
    return bound(n_bytes, n_ops, rate)


def qmm_bound(x, wq, M, N):
    """qmatmul's bound: x, the weights and their scales read once, the
    float32 (M, N) result written once; 2 M K N int8 operations."""
    K = x.shape[1]
    n_bytes = nbytes(x, wq) + 4 * N + 4 * M * N
    return bound(n_bytes, 2 * M * K * N, torch.int8)


def qmm_counters():
    """The quantized matmuls' launches. ``qmatmul_prefill`` counts K6's
    kernel however it was reached: through ``qmatmul`` above 32 rows, or
    as K7's prefill branch (``qmatmul_stacked`` above 32 rows, which the
    scan lane's layer products take), those launches counted in
    ``qmatmul_stacked`` too."""
    from pydynet_tpu_torch.ops import gemv_quant as gq

    return {"quantize_rows": gq.quantize_rows.launches,
            "qmatmul": gq.qmatmul.launches,
            "qmatmul_prefill": gq.qmatmul.prefill_launches
            + gq.qmatmul_stacked.prefill_launches,
            "qmatmul_stacked": gq.qmatmul_stacked.launches}


def zero_qmm_counters():
    from pydynet_tpu_torch.ops import gemv_quant as gq

    gq.quantize_rows.launches = gq.qmatmul.launches = 0
    gq.qmatmul.prefill_launches = gq.qmatmul_stacked.launches = 0
    gq.qmatmul_stacked.prefill_launches = 0


def random_qweights(K, N, q4, seed, layers=None):
    """Seeded int8 weights on the card, every byte value (int4: every
    nibble pair), and float32 channel scales: (K, N) / (1, N), or stacked
    (layers, Kst, N) / (layers, 1, N)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lead = () if layers is None else (layers,)
    w = torch.randint(-128, 128, lead + (K // 2 if q4 else K, N),
                      generator=g, device="cuda", dtype=torch.int8)
    ws = torch.rand(lead + (1, N), generator=g, device="cuda") * 1e-3
    return w, ws


def random_rows(M, K, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((M, K), generator=g, device="cuda") * 3
    if M > 2:
        x[1] = 0.0  # an all-zero row: the 1e-30 floor
    return x.to(dtype)


def check_qmatmul():
    """Phase 3c: the quantized-matmul kernels against their plain versions,
    bit for bit. Returns {kernel: max |kernel - plain|} on float32 and
    bfloat16 rows, and the same on float16 rows."""
    from pydynet_tpu_torch.ops import gemv_quant as gq

    errs = {name: 0.0 for name in QMM_KERNELS}
    f16_errs = dict(errs)
    counts = {}

    def same(name, got, want, what, dtype):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {what}: max error "
                                 f"{max_diff(got, want)}")
        into = f16_errs if dtype == torch.float16 else errs
        into[name] = max(into[name], max_diff(got, want))

    def replayed(x, w, ws, q4, what):
        """The stacked call at a device index, eager at layer 0, then
        captured in a CUDA graph and replayed at the last layer and at an
        index past either end (clamped), each time on new rows."""
        idx = torch.zeros((), dtype=torch.int32, device=w.device)
        L = w.shape[0]
        same("qmatmul_stacked", gq.qmatmul_stacked(x, w, ws, idx, q4=q4),
             gq.qmatmul_ref(x, w[0], ws[0], q4=q4), f"{what} index 0",
             x.dtype)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = gq.qmatmul_stacked(x, w, ws, idx, q4=q4)
        for index, layer in ((L - 1, L - 1), (L + 5, L - 1), (-3, 0)):
            idx.fill_(index)
            x.copy_(random_rows(x.shape[0], x.shape[1], x.dtype,
                                1000 + index))
            graph.replay()
            same("qmatmul_stacked", out,
                 gq.qmatmul_ref(x, w[layer], ws[layer], q4=q4),
                 f"{what} replayed at index {index}", x.dtype)

    for where, shapes in QMM_SHAPES.items():
        for K, N in shapes:
            for q4 in (False, True):
                w, ws = random_qweights(K, N, q4, K + N + q4, layers=3)
                for M in QMM_ROWS:
                    for dtype in DTYPES.values():
                        what = f"{where} ({K}, {N}) q4={q4} M={M} {dtype}"
                        x = random_rows(M, K, dtype, M + K)
                        (xq, sx), (rxq, rsx) = (gq.quantize_rows(x),
                                                gq.quantize_rows_ref(x))
                        same("quantize_rows", xq, rxq, what, dtype)
                        same("quantize_rows", sx, rsx, what, dtype)
                        decode = M <= gq.MAX_DECODE_ROWS
                        same("qmatmul" if decode else "qmatmul_prefill",
                             gq.qmatmul(x, w[1], ws[1], q4=q4),
                             gq.qmatmul_ref(x, w[1], ws[1], q4=q4), what,
                             dtype)
                        if decode:
                            replayed(x, w, ws, q4, what)
                        counts[where] = counts.get(where, 0) + 1
                del w, ws
    # the stacked kernel over 32 layers with a device index: first, middle
    # and last layer, and indices past either end, clamped
    L, (K, N) = LLAMA2_7B["n_layers"], QMM_SHAPES["7B"][1]
    layers = ((0, 0), (L // 2, L // 2), (L - 1, L - 1), (L + 3, L - 1),
              (-2, 0))  # (index, the layer it reads)
    for q4 in (False, True):
        w, ws = random_qweights(K, N, q4, 7 + q4, layers=L)
        for M in (1, 2, 3, 4, 12, 33, 256):
            x = random_rows(M, K, torch.bfloat16, M)
            for index, layer in layers:
                idx = torch.tensor(index, dtype=torch.int32, device=w.device)
                same("qmatmul_stacked",
                     gq.qmatmul_stacked(x, w, ws, idx, q4=q4),
                     gq.qmatmul_ref(x, w[layer], ws[layer], q4=q4),
                     f"index {index} of {L} q4={q4} M={M}", x.dtype)
        del w, ws
    print(f"[chip_smoke] quantized matmuls equal their plain versions bit "
          f"for bit: {counts} (shape, format, M, type) cases, int8 and int4; "
          f"at every M <= {gq.MAX_DECODE_ROWS} the stacked call at a device "
          f"index eagerly and replayed from a CUDA graph at other layers and "
          f"clamped indices; over {L} layers at indices "
          f"{[i for i, _ in layers]} (the last two clamped)")
    return errs, f16_errs


def big_requests(model, n=BIG_REQUESTS, seed=0):
    """Seeded (prompt, max_new_tokens) requests for the 7B server: prompt
    lengths in [2, 16], max_new_tokens cycling over BIG_MAX_NEW."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, model.vocab_size,
                          size=int(rng.integers(2, 17))).tolist(),
             BIG_MAX_NEW[i % len(BIG_MAX_NEW)]) for i in range(n)]


def check_big_dims():
    """Phase 4d: Llama-2-7B geometry on the scan lane through K5 and K7, the
    B=4 server, and the stories15M scan lane through K6 and the serve CLI.
    Returns (7B model, {kernel: launches in the main run})."""
    from pydynet_tpu_torch.models.llama import Llama, serve_cli
    from pydynet_tpu_torch.models.llama.model import bucket_prompt
    from pydynet_tpu_torch.ops import gemv_quant as gq
    from pydynet_tpu_torch.utils import fidelity

    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    model = Llama(**LLAMA2_7B, dtype=bf16, device="cuda",
                  generator=torch.Generator("cuda").manual_seed(0)).eval()
    torch.cuda.synchronize()
    print(f"[chip_smoke] built Llama-2-7B geometry ({model.n_layers} "
          f"layers, bf16, seeded random, drawn on the card) in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    total = PROMPT.shape[1] + BIG_NEW
    for quant in ("int8", "int4"):
        if model.use_fused(quant, 1):
            raise AssertionError(f"7B quant={quant} routed to the fused lane")
    streams, launches = {}, None
    with torch.no_grad():
        for quant in ("int8", "int4"):  # warm-up: snapshots, cuBLAS
            list(model.generate(PROMPT, PROMPT.shape[1] + 2, dtype=bf16,
                                quant=quant))
        torch.cuda.synchronize()
        zero_qmm_counters()
        for quant in ("int8", "int4"):
            start = time.perf_counter()
            streams[quant] = [int(t[0, 0]) for t in model.generate(
                PROMPT, total, dtype=bf16, quant=quant)]
            torch.cuda.synchronize()
            print(f"[chip_smoke] 7B generate {quant}: {len(streams[quant])} "
                  f"tokens in {time.perf_counter() - start:.2f} s")
        launches = qmm_counters()
    forwards = 2 * BIG_NEW  # prefill + BIG_NEW - 1 steps, two formats
    per = 4 * model.n_layers  # stacked launches a forward, one head launch
    # one launch a product up to FUSED_QUANT_MAX_ROWS rows (the decode
    # kernel quantizes them itself); the prefill's bucketed rows above that
    # are quantized by quantize_rows first, the head's last row is not
    rows = bucket_prompt(PROMPT, PROMPT.shape[1], model.max_seq_len)[0]
    prefills = 2 if rows.shape[1] > gq.FUSED_QUANT_MAX_ROWS else 0
    want = {"quantize_rows": per * prefills, "qmatmul": forwards,
            "qmatmul_prefill": 0, "qmatmul_stacked": per * forwards}
    print(f"[chip_smoke] 7B launches {launches}, implied {want}")
    if launches != want:
        raise AssertionError("7B launches differ from the implied counts")
    for quant, toks in streams.items():
        if len(toks) != BIG_NEW \
                or not all(0 <= x < model.vocab_size for x in toks):
            raise AssertionError(f"7B {quant}: bad stream {toks}")

    # int8 against the bf16 scan lane, teacher-forced, at confident steps
    truth, margins, tops = fidelity.scan_truth(model, PROMPT, BIG_NEW,
                                               dtype=bf16)
    model._weights_cache.pop((bf16, "dense", None))  # 13 GB dense stack
    checked, ok, agree = fidelity.gate_scan_argmax(
        model, PROMPT, truth, margins, tops, dtype=bf16, quant="int8")
    print(f"[chip_smoke] gate 7B int8 vs bf16 scan lane: checked {checked} "
          f"ok {ok} agree {agree:.3f}")
    if not (checked > 0 and ok):
        raise AssertionError("7B int8 gate failed")

    # the B=4 server: routed to the scan lane on its own, 8 requests
    from pydynet_tpu_torch.models.llama.serve import LlamaServer

    requests = big_requests(model)
    srv = LlamaServer(model, dtype=bf16, quant="int4", **BIG_SERVE)
    if srv._lane != "xla":
        raise AssertionError(f"7B int4 server on lane {srv._lane}")
    waves = []
    admit = srv._admit_many
    srv._admit_many = lambda *a, **kw: waves.append(1) or admit(*a, **kw)
    rids = [srv.submit(p, max_new_tokens=n) for p, n in requests]
    zero_qmm_counters()
    start = time.perf_counter()
    done = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    served = qmm_counters()
    n_tok = sum(len(done[r].tokens) for r in rids)
    forwards = srv.dispatched_steps + len(waves)
    print(f"[chip_smoke] 7B server int4 B=4: {len(rids)} requests, {n_tok} "
          f"tokens, {srv.dispatched_steps} steps, {len(waves)} admission "
          f"waves in {wall:.2f} s; launches {served}")
    if served["qmatmul_stacked"] != per * forwards \
            or served["qmatmul"] != forwards:
        raise AssertionError("7B server launches differ from the implied "
                             "counts")
    if not all(done[r].done and done[r].tokens for r in rids):
        raise AssertionError("7B server: a request did not finish")
    # every served request, teacher-forced: standalone B=1 generate's
    # forward is fed the served stream and must give the served token at
    # each of its confident steps (batched rows reduce attention in another
    # order in bf16, so a near-tie may go either way); step 0 is the
    # admission wave's prefill
    checked = agree = n_steps = 0
    for rid, (prompt, n_new) in zip(rids, requests):
        got = np.array(done[rid].tokens)
        if len(got) != n_new:
            raise AssertionError(f"7B server: {len(got)} tokens, want "
                                 f"{n_new}")
        tr, mg, tp = fidelity.scan_truth(model, np.array([prompt]), n_new,
                                         dtype=bf16, quant="int4",
                                         forced=got[:, None])
        conf = fidelity._confident(mg[:, 0], tp[:, 0], fidelity.MARGIN,
                                   fidelity.REL_MARGIN)
        same = tr[:, 0] == got
        if not same[conf].all():
            raise AssertionError(f"7B server request {rid} differs from "
                                 f"standalone generate at confident steps "
                                 f"{np.flatnonzero(conf & ~same).tolist()}")
        checked += int(conf.sum())
        agree += int(same.sum())
        n_steps += n_new
    print(f"[chip_smoke] 7B server vs standalone generate, every request "
          f"teacher-forced: {checked} of {n_steps} steps confident, all "
          f"equal; {agree} of {n_steps} equal in all")
    if checked == 0:
        raise AssertionError("7B server: no confident step to compare")
    del srv, done

    # int4 against a dequantized-weights truth, majority agreement (the
    # weights are round-tripped in place: this runs last on the model)
    fidelity.dequant_inplace(model, "int4")
    truth, margins, tops = fidelity.scan_truth(model, PROMPT, BIG_NEW,
                                               dtype=bf16)
    model._weights_cache.pop((bf16, "dense", None))
    checked, ok, agree = fidelity.gate_scan_argmax(
        model, PROMPT, truth, margins, tops, dtype=bf16, quant="int4",
        min_agree=INT4_MIN_AGREE)
    print(f"[chip_smoke] gate 7B int4 vs dequantized truth: checked "
          f"{checked} ok {ok} agree {agree:.3f}")
    if not ok:
        raise AssertionError("7B int4 majority gate failed")

    # stories15M on the scan lane: a long prompt's prefill through K6
    small = Llama(**CFG, device="cuda",
                  generator=torch.Generator().manual_seed(0)).eval()
    cpu = Llama(**CFG, device="cpu",
                generator=torch.Generator().manual_seed(0)).eval()
    prompt = np.random.default_rng(1).integers(1, CFG["vocab_size"],
                                               (1, LONG_PROMPT))
    n_new = 32
    zero_qmm_counters()
    got = {q: [int(t[0, 0]) for t in small.generate(
        prompt, LONG_PROMPT + n_new, quant=q, fused=False)]
        for q in ("int8", "int4")}
    long_run = qmm_counters()
    L = CFG["n_layers"]
    # every layer product through K7 (the prefill's through its prefill
    # branch, K6's kernel, on rows quantize_rows made), the head through K5
    want = {"quantize_rows": 2 * 4 * L, "qmatmul": 2 * n_new,
            "qmatmul_prefill": 2 * 4 * L,
            "qmatmul_stacked": 2 * 4 * L * n_new}
    print(f"[chip_smoke] stories15M scan lane, {LONG_PROMPT}-token prompt: "
          f"launches {long_run}, implied {want}")
    if long_run != want:
        raise AssertionError("stories15M scan-lane launches differ")
    # against the same lane on the CPU, teacher-forced, at confident steps:
    # float noise between the devices moves an activation across a rounding
    # boundary of its int8 now and then, so free-running streams part at
    # margins far above float32 noise
    for q, toks in got.items():
        tr, mg, tp = fidelity.scan_truth(cpu, prompt, n_new, quant=q)
        checked, ok, agree = fidelity.gate_scan_argmax(small, prompt, tr, mg,
                                                       tp, quant=q)
        same = next((i for i, (a, b) in enumerate(zip(toks, tr[:, 0]))
                     if a != b), n_new)
        print(f"[chip_smoke] stories15M f32 {q} scan lane vs the CPU: "
              f"the first {same} of {n_new} tokens equal; teacher-forced "
              f"gate checked {checked} ok {ok} agree {agree:.3f}")
        if not (checked > 0 and ok):
            raise AssertionError(f"stories15M {q} gate against the CPU "
                                 "failed")
    del small, cpu
    before = qmm_counters()["qmatmul"]
    serve_cli.main(["--random-init", "--device", "cuda", "--lane", "xla",
                    "--quant", "int8", "--batch-size", "4",
                    "--max-new-tokens", "48"])
    if qmm_counters()["qmatmul"] == before:
        raise AssertionError("serve CLI did not run the quantized matmuls")
    # the prefill kernel and the standalone row quantization before it run
    # on the long prompt's path, not on the 7B requests'
    for name in ("qmatmul_prefill", "quantize_rows"):
        launches[name] = long_run[name]
    if not all(launches.values()):
        raise AssertionError(f"a quantized-matmul kernel was not launched: "
                             f"{launches}")
    return model, launches


def prefix_requests(model, seed=0):
    """Phase 4p's traffic: (prompt, max_new_tokens) pairs, each prompt one
    seeded PREFIX_SYSTEM-token system prompt and a seeded suffix."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, model.vocab_size, PREFIX_SYSTEM).tolist()
    lo, hi = PREFIX_SUFFIX
    return [(system + rng.integers(1, model.vocab_size,
                                   int(rng.integers(lo, hi + 1))).tolist(),
             PREFIX_MAX_NEW[i % len(PREFIX_MAX_NEW)])
            for i in range(PREFIX_REQUESTS)]


def prefix_serve(model, requests, quant, prefix_cache):
    """One phase-4p server run: returns (server, streams, {"full": [s],
    "reuse": [s]} of each admission's time to its first token, wall
    seconds). An admission is timed synchronised on both sides: its
    prefill and the scatter of its rows."""
    from pydynet_tpu_torch.models.llama.serve import LlamaServer

    srv = LlamaServer(model, dtype=torch.bfloat16, quant=quant,
                      prefix_cache=prefix_cache, **PREFIX_SERVE)
    if srv._lane != "xla":
        raise AssertionError(f"7B {quant} kv8 server on lane {srv._lane}")
    ttft = {"full": [], "reuse": []}

    def timed(kind, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            ttft[kind].append(time.perf_counter() - start)
            return out
        return run

    srv._admit_many = timed("full", srv._admit_many)
    srv._admit_prefix = timed("reuse", srv._admit_prefix)
    rids = [srv.submit(p, max_new_tokens=n) for p, n in requests]
    start = time.perf_counter()
    done = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    return srv, [done[r].tokens for r in rids], ttft, wall


def first_difference(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def parts_at_a_tie(model, prompt, ref, other, **kw):
    """``(d, ok)``: ``d`` the first step where the stream ``other`` leaves
    ``ref`` (both from ``prompt``), ``ok`` whether they are equal or part at
    a near-tie: up to ``d`` both fed the same tokens, so only a top-2 gap
    within bf16 noise at ``d`` itself (not confident in the gates' sense,
    teacher-forced along ``ref`` on the scan lane with ``kw``) may send them
    apart there."""
    from pydynet_tpu_torch.utils import fidelity

    d = first_difference(ref, other)
    if d == len(ref) == len(other):
        return d, True
    _, mg, tp = fidelity.scan_truth(model, np.asarray([prompt]), d + 1,
                                    forced=np.array(ref[:d + 1])[:, None],
                                    **kw)
    return d, not fidelity._confident(mg[d, 0], tp[d, 0], fidelity.MARGIN,
                                      fidelity.REL_MARGIN)


def check_prefix_cache(big, card):
    """Phase 4p: the 7B geometry served with int8 weights and the int8 KV
    cache on the scan lane, a long shared system prompt reused by the
    prefix cache; the reuse streams against the no-reuse server's;
    standalone ``generate(kv_quant="int8")`` with int8 and int4 weights
    against the same request without it; ``serve_cli --quant int4
    --prefix-cache``. Returns {kernel: launches} of the prefix-cache
    server's run."""
    from pydynet_tpu_torch.models.llama import serve_cli
    from pydynet_tpu_torch.models.llama import serve as serve_mod
    from pydynet_tpu_torch.ops import decode_step as dsk
    from pydynet_tpu_torch.ops import flash_attention as fa
    from pydynet_tpu_torch.utils import fidelity

    bf16 = torch.bfloat16
    requests = prefix_requests(big)
    N, S, Hkv, hd = (big.n_layers, big.max_seq_len, big.n_kv_heads,
                     big.head_dim)
    B = PREFIX_SERVE["batch_size"]
    kv8_bytes = 2 * N * B * S * Hkv * (hd + 4)  # int8 rows, f32 scales
    bf16_bytes = 2 * N * B * S * Hkv * hd * 2
    path_launches = None
    with torch.no_grad():
        quant = "int8"
        t0 = time.perf_counter()
        prefix_serve(big, requests[:2], quant, True)  # warm-up
        runs = {}
        for prefix_cache in (True, False):  # in turns
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_qmm_counters()
            fa.flash_attention_fwd.launches = 0
            k2 = dsk.fused_decode_token_batched.launches
            srv, streams, ttft, wall = prefix_serve(
                big, requests, quant, prefix_cache)
            ran = dict(qmm_counters(), flash_attention_fwd=(
                fa.flash_attention_fwd.launches))
            peak = torch.cuda.max_memory_allocated()
            runs[prefix_cache] = streams
            n_tok = sum(len(t) for t in streams)
            waves, reuse = len(ttft["full"]), len(ttft["reuse"])
            forwards = srv.dispatched_steps + waves + reuse
            print(f"[chip_smoke] {card}: 7B {quant} kv8 B={B} server, "
                  f"prefix_cache={prefix_cache}: {len(requests)} "
                  f"requests, {n_tok} tokens in {wall:.2f} s, "
                  f"{n_tok / wall:.1f} generated tok/s; "
                  f"{srv.dispatched_steps} steps, {waves} full "
                  f"admission waves, {reuse} reuse admissions; "
                  f"prefix_hits {srv.prefix_hits}, prefix_rows_reused "
                  f"{srv.prefix_rows_reused}; launches {ran}; peak "
                  f"memory {peak / 2**30:.2f} GiB (KV cache "
                  f"{kv8_bytes / 2**30:.2f} GiB in int8, "
                  f"{bf16_bytes / 2**30:.2f} GiB in bf16)")
            for kind, t in ttft.items():
                if t:
                    print(f"[chip_smoke] {card}: 7B {quant} kv8 "
                          f"prefix_cache={prefix_cache}: {kind} "
                          f"admissions, ms to the first token: median "
                          f"{float(np.median(t)) * 1e3:.2f} of "
                          f"{len(t)} "
                          f"({', '.join(f'{x * 1e3:.1f}' for x in t)})")
            # every layer product through K7 and the head through K5,
            # once a forward (a decode step or an admission); each
            # admission's rows above 4 quantized by quantize_rows; K3
            # once a layer on every full wave (its padded prompt is
            # above FLASH_PREFILL_MIN), never on a reuse admission
            want = {"qmatmul_stacked": 4 * N * forwards,
                    "qmatmul": forwards,
                    "quantize_rows": 4 * N * (waves + reuse),
                    "flash_attention_fwd": N * waves}
            got = {k: ran[k] for k in want}
            if got != want or not ran["qmatmul_prefill"] \
                    or dsk.fused_decode_token_batched.launches != k2:
                raise AssertionError(f"7B {quant} kv8 launches {ran}, "
                                     f"implied {want}")
            if prefix_cache:
                if srv.prefix_hits < PREFIX_MIN_HITS or \
                        srv.prefix_rows_reused \
                        != PREFIX_SYSTEM * srv.prefix_hits:
                    raise AssertionError(
                        f"7B {quant}: {srv.prefix_hits} prefix hits, "
                        f"{srv.prefix_rows_reused} rows reused")
                path_launches = ran
            elif srv.prefix_hits:
                raise AssertionError("prefix hits without the cache")
            if not all(len(t) == n for t, (_, n) in zip(streams,
                                                         requests)):
                raise AssertionError(f"7B {quant}: a short stream")
        # the gate: reused rows carry one more rounding (the int8 K
        # rows' requantization), the only difference between the two
        # servers, whose weights are the same int8 or int4 snapshot; so
        # each stream must equal the no-reuse server's up to a step
        # where it parts at a near-tie (teacher-forced along the
        # no-reuse stream on the standalone forward). A free-running
        # stream of this random-weight model differs from there on,
        # so the share of equal tokens is printed, not gated
        parts = []
        for (prompt, _), a, b in zip(requests, runs[True], runs[False]):
            d, ok = parts_at_a_tie(big, prompt, b, a, dtype=bf16,
                                   quant=quant, kv_quant="int8")
            if not ok:
                raise AssertionError(
                    f"7B {quant} prefix-cache stream leaves the no-reuse "
                    f"one at confident step {d}: {a[:d + 1]} vs "
                    f"{b[:d + 1]}")
            parts.append(d)
        whole = sum(d == len(b) for d, b in zip(parts, runs[False]))
        same = sum(sum(x == y for x, y in zip(a, b))
                   for a, b in zip(runs[True], runs[False]))
        total = sum(len(b) for b in runs[False])
        print(f"[chip_smoke] gate 7B {quant} kv8 prefix cache vs no "
              f"reuse: {whole} of {len(requests)} streams equal "
              f"throughout, the others parting at a near-tie (steps "
              f"{parts}); {sum(parts)} tokens equal before the partings,"
              f" {same} of {total} in all ({same / total:.3f})")
        print(f"[chip_smoke] 7B {quant} kv8 prefix-cache runs: "
              f"{time.perf_counter() - t0:.1f} s")

        # standalone generate with int8 KV and int8/int4 weights: the scan
        # lane, teacher-forced against the same request without kv_quant
        total = PROMPT.shape[1] + BIG_NEW
        for quant in ("int8", "int4"):
            if big.use_fused(quant, 1, batched=True):
                raise AssertionError(f"7B {quant} kv8 routed to the fused "
                                     "lane")
            zero_qmm_counters()
            toks = [int(t[0, 0]) for t in big.generate(
                PROMPT, total, dtype=bf16, quant=quant, kv_quant="int8")]
            ran = qmm_counters()
            if len(toks) != BIG_NEW or ran["qmatmul"] != BIG_NEW \
                    or ran["qmatmul_stacked"] != 4 * N * BIG_NEW:
                raise AssertionError(f"7B generate {quant} kv8: "
                                     f"{len(toks)} tokens, launches {ran}")
            truth, margins, tops = fidelity.scan_truth(
                big, PROMPT, BIG_NEW, dtype=bf16, quant=quant)
            kw = {"min_agree": INT4_MIN_AGREE} if quant == "int4" else {}
            checked, ok, agree = fidelity.gate_scan_argmax(
                big, PROMPT, truth, margins, tops, dtype=bf16, quant=quant,
                kv_quant="int8", **kw)
            same = first_difference(toks, truth[:, 0].tolist())
            print(f"[chip_smoke] gate 7B generate {quant} kv8 vs {quant} "
                  f"(bf16 KV){', majority' if kw else ''}: checked "
                  f"{checked} ok {ok} agree {agree:.3f}; free-running, the "
                  f"first {same} of {BIG_NEW} tokens equal")
            if not (checked > 0 and ok):
                raise AssertionError(f"7B generate {quant} kv8 gate failed")

    # the serve CLI on the stories15M scan lane with both quantizations
    # and the prefix cache: the second prompt (longer than the first, so
    # admitted a chunk later) reuses the first one's resident rows
    hits = []
    admit = serve_mod.LlamaServer._admit_prefix
    serve_mod.LlamaServer._admit_prefix = \
        lambda self, *a, **kw: hits.append(1) or admit(self, *a, **kw)
    try:
        before = qmm_counters()["qmatmul_stacked"]
        serve_cli.main(["--random-init", "--device", "cuda", "--lane",
                        "xla", "--quant", "int4", "--kv-quant", "int8",
                        "--prefix-cache", "--batch-size", "2", "--chunk",
                        "8", "--max-new-tokens", "24", "--prompt",
                        "Once upon a time, there was a little girl named "
                        "Lily. She", "--prompt", "Once upon a time, there "
                        "was a little girl named Lily. She liked to play"])
    finally:
        serve_mod.LlamaServer._admit_prefix = admit
    print(f"[chip_smoke] serve CLI --lane xla --quant int4 --kv-quant int8 "
          f"--prefix-cache: {len(hits)} reuse admission(s)")
    if not hits or qmm_counters()["qmatmul_stacked"] == before:
        raise AssertionError("serve CLI --prefix-cache reused no rows or "
                             "ran no quantized matmul")
    return path_launches


def check_beam_and_speculative(model, card):
    """Phase 4p, Part B: beam search and speculative decoding at stories15M
    width, bf16, on the scan lane. ``generate_speculative`` of a
    SPEC_REQUEST-token request and ``generate_beam(num_beams=1)`` against
    greedy ``generate(fused=False)`` up to its first near-tie (its
    teacher-forced top-2 margin below the bf16 gates' floor); both
    tokens/s; ``num_beams=4`` timed."""
    bf16 = torch.bfloat16
    ids = SPEC_PROMPT
    with torch.no_grad():
        list(model.generate(ids, ids.shape[1] + 4, dtype=bf16, fused=False))
        model.generate_speculative(ids, ids.shape[1] + 16, dtype=bf16)
        torch.cuda.synchronize()
        start = time.perf_counter()
        greedy = [int(t[0, 0]) for t in model.generate(
            ids, SPEC_REQUEST, dtype=bf16, fused=False)]
        torch.cuda.synchronize()
        g_s = time.perf_counter() - start
        start = time.perf_counter()
        spec, stats = model.generate_speculative(ids, SPEC_REQUEST,
                                                 dtype=bf16)
        torch.cuda.synchronize()
        s_s = time.perf_counter() - start
        prompt, n = ids[0].tolist(), len(greedy)
        d, ok = parts_at_a_tie(model, prompt, greedy, spec.tolist(),
                               dtype=bf16)
        print(f"[chip_smoke] {card}: speculative bf16 {SPEC_REQUEST}-token "
              f"request: {n / s_s:.1f} tok/s, greedy generate(fused=False) "
              f"{n / g_s:.1f} tok/s; stats {stats}; equal to greedy for "
              f"the first {d} of {n} tokens"
              + ("" if d == n else ", parting at a near-tie"))
        if not ok or stats["tokens"] != n:
            raise AssertionError(f"speculative stream leaves greedy at "
                                 f"confident step {d}")
        beams = {}
        for W, total in ((1, SPEC_REQUEST), (4, BEAM_REQUEST)):
            model.generate_beam(ids, ids.shape[1] + 4, num_beams=W,
                                eos_id=-1, dtype=bf16)
            torch.cuda.synchronize()
            start = time.perf_counter()
            beams[W] = model.generate_beam(ids, total, num_beams=W,
                                           eos_id=-1, dtype=bf16)
            torch.cuda.synchronize()
            secs = time.perf_counter() - start
            print(f"[chip_smoke] {card}: beam search W={W} bf16 "
                  f"{total}-token request: {len(beams[W])} tokens in "
                  f"{secs:.2f} s, {len(beams[W]) / secs:.1f} tok/s")
        d, ok = parts_at_a_tie(model, prompt, greedy, beams[1], dtype=bf16)
        print(f"[chip_smoke] beam W=1 equal to greedy for the first {d} of "
              f"{n} tokens" + ("" if d == n else ", parting at a near-tie"))
        if not ok or len(beams[1]) != n:
            raise AssertionError(f"beam W=1 leaves greedy at confident "
                                 f"step {d}")
        if len(beams[4]) != BEAM_REQUEST - ids.shape[1]:
            raise AssertionError(f"beam W=4: {len(beams[4])} tokens")


# ------------------------- phase 4r: LoRA, speculative ---------------------
def check_generator(card):
    """The threefry ``Generator`` on the card against the CPU, bit for bit:
    GEN_DRAWS ``uniform`` draws in float32 and bfloat16 and ``bernoulli``
    draws, each from a fresh generator of one seed; and the key each
    leaves behind."""
    from pydynet_tpu_torch.random import Generator

    draws = ((lambda g, dev: g.uniform((GEN_DRAWS,), device=dev), "uniform"),
             (lambda g, dev: g.uniform((GEN_DRAWS,), dtype=torch.bfloat16,
                                       device=dev), "uniform bf16"),
             (lambda g, dev: g.bernoulli(0.05, (GEN_DRAWS,), device=dev),
              "bernoulli(0.05)"))
    for draw, name in draws:
        gpu, cpu = Generator(42), Generator(42)
        a, b = draw(gpu, "cuda"), draw(cpu, "cpu")
        if not (torch.equal(a.cpu(), b) and torch.equal(gpu.state.cpu(),
                                                        cpu.state)):
            raise AssertionError(f"Generator {name}: the card's draws differ "
                                 "from the CPU's")
    print(f"[chip_smoke] {card}: Generator: {GEN_DRAWS} draws each of "
          f"uniform, uniform bf16 and bernoulli equal to the CPU's bit for "
          f"bit")


def dropout_first_step(device, seed=0):
    """DNN_dropout from ``seed`` on ``device`` after one Adam step (lr
    5e-5) on the trainer's first 40 faces, its masks from
    ``default_generator`` seeded by ``manual_seed``; returns (net,
    loss)."""
    from pydynet_tpu_torch import manual_seed
    from pydynet_tpu_torch.examples import dropout_bn as dbn
    from pydynet_tpu_torch.nn import CrossEntropyLoss
    from pydynet_tpu_torch.optim import Adam

    manual_seed(seed)
    net = dbn.DNN_dropout().to(device)
    opt = Adam(net.parameters(), lr=DBN_LR)
    X, y = dbn.load_faces()
    bx, by = (torch.from_numpy(a[:40]).to(device) for a in (X, y))
    loss = dbn.train_step([net], [opt], CrossEntropyLoss(), bx, by)[0]
    return net, float(loss)


def check_dropout_step():
    """DNN_dropout's first step on the card against the CPU's (DNN_BN's
    gate in phase 4e: loss within TRAIN_LOSS_RTOL, gradients within
    TRAIN_GRAD_RTOL of each tensor's largest, weights within lr / 10).
    Phase 5 times the dropout_bn step, its masks drawn the same way."""
    gpu, gpu_loss = dropout_first_step("cuda")
    cpu, cpu_loss = dropout_first_step("cpu")
    if abs(gpu_loss - cpu_loss) > TRAIN_LOSS_RTOL * abs(cpu_loss):
        raise AssertionError(f"DNN_dropout step loss {gpu_loss} != CPU "
                             f"{cpu_loss}")
    g_err, w_err = check_step_vs_cpu(gpu, cpu, DBN_LR / 10)
    print(f"[chip_smoke] DNN_dropout step 1 vs CPU: loss {gpu_loss:.6f} vs "
          f"{cpu_loss:.6f}, max gradient error {g_err:.3g}, max weight "
          f"error {w_err:.3g}")


def lora_pattern(seed=0):
    """The LoRA phase's data: a seeded LORA_PERIOD-token pattern and the
    (1, LORA_L) shifted pair of it repeated."""
    pat = np.random.default_rng(seed).integers(1, CFG["vocab_size"],
                                               LORA_PERIOD)
    row = np.resize(pat, LORA_L + 1)[None]
    return pat, row[:, :-1], row[:, 1:]


def lora_model(device, seed=0):
    """stories15M from seed 0 with LORA's adapters (``A`` drawn after
    ``manual_seed(seed)``, which also seeds the dropout stream) and an Adam
    over them; returns (model, optimizer, (trainable, frozen))."""
    from pydynet_tpu_torch import manual_seed
    from pydynet_tpu_torch.models.llama import Llama
    from pydynet_tpu_torch.optim import Adam

    manual_seed(seed)
    model = Llama(**TRAIN_CFG, device=device,
                  generator=torch.Generator().manual_seed(0))
    counts = model.add_lora(**LORA)
    opt = Adam([p for p in model.parameters() if p.requires_grad],
               lr=LORA_LR)
    return model, opt, counts


def loop_repeats(model, pat, n=8, reps=3):
    """Whether greedy decoding (f32 scan lane) of the pattern's first ``n``
    tokens continues it for ``reps`` periods."""
    want = np.resize(pat, n + reps * LORA_PERIOD)[n:].tolist()
    with torch.no_grad():
        got = [int(t[0, 0]) for t in model.generate(
            pat[None, :n], n + reps * LORA_PERIOD, fused=False)]
    return got == want


def check_lora_training(card):
    """Phase 4r's fine-tune: the first step on the card against the CPU's,
    then LORA_EVERY steps at a time until greedy decoding repeats the
    pattern (at most LORA_MAX_STEPS), K3/K4 counted, the base weights
    unchanged. Returns (model, pattern, {kernel: launches})."""
    gpu, gopt, counts = lora_model("cuda")
    cpu, copt, _ = lora_model("cpu")
    pat, inp, tgt = lora_pattern()
    frozen = [n for n, p in gpu.named_parameters() if not p.requires_grad]
    base = {n: p.detach().clone() for n, p in gpu.named_parameters()
            if n in frozen}
    from pydynet_tpu_torch import manual_seed

    for k in flash_counters():
        k.launches = 0
    manual_seed(1)  # the same dropout masks on both devices
    gloss = gpu.finetune_step(inp, tgt, gopt)
    manual_seed(1)
    closs = cpu.finetune_step(inp, tgt, copt)
    if abs(gloss - closs) > TRAIN_LOSS_RTOL * abs(closs):
        raise AssertionError(f"LoRA step loss {gloss} != CPU {closs}")
    g_err, w_err = check_step_vs_cpu(gpu, cpu, LORA_LR / 10, skip=frozen)
    print(f"[chip_smoke] LoRA (r {LORA['r']}, alpha {LORA['alpha']}, "
          f"dropout {LORA['dropout']}, {','.join(LORA['targets'])}): "
          f"trainable {counts[0]} tensors, "
          f"{sum(p.numel() for p in gpu.parameters() if p.requires_grad)} "
          f"parameters; step 1 vs CPU: loss {gloss:.6f} vs {closs:.6f}, max "
          f"gradient error {g_err:.3g}, max weight error {w_err:.3g}")
    del cpu
    curve, secs, steps = [gloss], 0.0, 1
    while not loop_repeats(gpu, pat):
        if steps >= LORA_MAX_STEPS:
            raise AssertionError(f"greedy decoding did not repeat the "
                                 f"pattern after {steps} steps")
        torch.cuda.synchronize()
        start = time.perf_counter()
        losses = gpu.finetune_steps(inp, tgt, gopt, LORA_EVERY)
        torch.cuda.synchronize()
        secs += time.perf_counter() - start
        steps += LORA_EVERY
        curve.append(float(losses[-1]))
    launches = {k.__name__: k.launches for k in flash_counters()}
    want = {"flash_attention_fwd": CFG["n_layers"] * steps,
            "flash_attention_bwd_dq": CFG["n_layers"] * steps,
            "flash_attention_bwd_dkv": CFG["n_layers"] * steps}
    if launches != want:
        raise AssertionError(f"LoRA fine-tune launches {launches}, want "
                             f"{want}")
    for n, p in gpu.named_parameters():
        if n in base and not torch.equal(p, base[n]):
            raise AssertionError(f"LoRA fine-tune moved the base weight {n}")
    print(f"[chip_smoke] {card}: LoRA fine-tune at L={LORA_L}: greedy "
          f"decoding repeats the pattern after {steps} steps; loss at "
          f"steps 1, {LORA_EVERY + 1}, ...: "
          f"{', '.join(f'{x:.4f}' for x in curve)}; "
          f"{(steps - 1) / max(secs, 1e-9):.1f} steps/s; launches {launches}")
    return gpu.eval(), pat, launches


def lora_requests(pat):
    """The LoRA phase's traffic: N_REQUESTS prompts cut from the repeated
    pattern, request i at offset i mod LORA_PERIOD, its length cycling
    over LORA_PROMPTS every three requests, ``max_new_tokens`` over
    LORA_MAX_NEW; and each prompt's continuation of the pattern, a period
    long."""
    row = np.resize(pat, 3 * LORA_PERIOD + max(LORA_PROMPTS))
    requests, follow = [], []
    n = len(LORA_MAX_NEW)
    for i in range(N_REQUESTS):
        o = i % LORA_PERIOD
        L = LORA_PROMPTS[(i // n) % len(LORA_PROMPTS)]
        requests.append((row[o:o + L].tolist(), LORA_MAX_NEW[i % n]))
        follow.append(row[o + L:o + L + LORA_PERIOD].tolist())
    return requests, follow


def fused_streams(model, requests):
    """The requests' bf16 streams on the fused lane: ``generate`` one at a
    time (K1) and a B=8 ``LlamaServer`` (K2)."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    k1, k2 = dsk.fused_decode_token, dsk.fused_decode_token_batched
    b1, b2 = k1.launches, k2.launches
    with torch.no_grad():
        gen = [[int(t[0, 0]) for t in model.generate(
            np.asarray([p]), len(p) + n, dtype=torch.bfloat16)]
            for p, n in requests]
    _, done = serve(model, requests, dtype=torch.bfloat16, **SERVE)
    if k1.launches == b1 or k2.launches == b2:
        raise AssertionError("the adapted model did not decode on K1/K2")
    return gen, [r.tokens for r in done], (k1.launches - b1,
                                           k2.launches - b2)


def scan_references(model, requests, batch=8, **kw):
    """``generate(fused=False)``'s stream of each request in ``kw``'s
    format, up to ``batch`` requests of one prompt length decoded
    together."""
    out = [None] * len(requests)
    by_len = {}
    for i, (p, n) in enumerate(requests):
        by_len.setdefault(len(p), []).append(i)
    groups = [(L, idx[j:j + batch]) for L, idx in by_len.items()
              for j in range(0, len(idx), batch)]
    with torch.no_grad():
        for L, idx in groups:
            total = L + max(requests[i][1] for i in idx)
            rows = torch.cat(list(model.generate(
                np.asarray([requests[i][0] for i in idx]), total,
                fused=False, **kw)), 1)
            for r, i in enumerate(idx):
                out[i] = rows[r, :requests[i][1]].tolist()
    return out


def gate_partings(model, requests, refs, streams, label, **kw):
    """Each stream equal to its reference up to a parting at a near-tie
    (``parts_at_a_tie``); prints the count equal throughout and the
    tokens before the partings."""
    equal, before = 0, 0
    for (p, _), ref, got in zip(requests, refs, streams):
        if len(got) != len(ref):
            raise AssertionError(f"{label}: {len(got)} tokens, want "
                                 f"{len(ref)}")
        d, ok = parts_at_a_tie(model, p, ref, got, **kw)
        if not ok:
            raise AssertionError(f"{label}: a stream leaves "
                                 f"generate(fused=False) at confident step "
                                 f"{d}")
        equal += d == len(ref)
        before += d
    print(f"[chip_smoke] {label}: {equal} of {len(streams)} streams equal "
          f"to generate(fused=False) throughout, the rest parting at "
          f"near-ties; {before} of {sum(map(len, refs))} tokens before the "
          f"partings")


def spec_serve(model, requests, **kw):
    """One speculative server run; returns (server, streams, seconds)."""
    from pydynet_tpu_torch.models.llama.serve import LlamaServer

    srv = LlamaServer(model, **kw)
    rids = [srv.submit(p, max_new_tokens=n) for p, n in requests]
    torch.cuda.synchronize()
    start = time.perf_counter()
    done = srv.run()
    torch.cuda.synchronize()
    return srv, [done[r].tokens for r in rids], time.perf_counter() - start


def check_adapted_serving(model, base, pat, card):
    """The adapted stories15M in bf16: fused-lane streams (K1, K2)
    unmerged and merged, unlike the base model's; the speculative server
    gated against ``generate(fused=False)`` and timed beside the scan-lane
    and fused servers. Returns {kernel: launches} of the unmerged fused
    runs."""
    import copy

    bf16 = torch.bfloat16
    requests, follow = lora_requests(pat)
    gen, served, launches = fused_streams(model, requests)
    base_gen = [[int(t[0, 0]) for t in base.generate(
        np.asarray([p]), len(p) + n, dtype=bf16)] for p, n in requests[:3]]
    if base_gen == gen[:3]:
        raise AssertionError("the adapted model decodes as the base model")
    merged = copy.deepcopy(model)
    if merged.merge_lora() != CFG["n_layers"] * len(LORA["targets"]):
        raise AssertionError("merge_lora merged the wrong count")
    gen_m, served_m, _ = fused_streams(merged, requests)
    del merged
    if gen_m != gen or served_m != served:
        raise AssertionError("merged and unmerged fused streams differ")
    repeat = sum(g[:LORA_PERIOD] == f for g, f in zip(gen, follow))
    print(f"[chip_smoke] adapted model, fused lane bf16: {len(gen)} requests "
          f"through K1 ({launches[0]} launches) and a B=8 server through K2 "
          f"({launches[1]} launches), merged streams equal to unmerged bit "
          f"for bit, unlike the base model's; {repeat} of {len(gen)} K1 "
          f"streams continue the pattern for a period")
    spec_serve(model, requests[:2], dtype=bf16, **SPEC_SERVE)  # warm-up
    srv, spec, _ = spec_serve(model, requests, dtype=bf16, **SPEC_SERVE)
    refs = scan_references(model, requests, dtype=bf16)
    label = f"speculative bf16 B={SPEC_SERVE['batch_size']}"
    gate_partings(model, requests, refs, spec, label, dtype=bf16)
    if srv.spec_accepted <= 0:
        raise AssertionError("the speculative server accepted no draft")
    tokens = sum(map(len, spec))
    print(f"[chip_smoke] {label}: {tokens} tokens in "
          f"{srv.spec_iterations} verify iterations of the fleet, "
          f"{tokens / srv.spec_iterations:.2f} a verify iteration; "
          f"{srv.spec_accepted} drafts accepted")
    runs = {"speculative": lambda: spec_serve(model, requests, dtype=bf16,
                                              **SPEC_SERVE)[2],
            "fused": lambda: timed_serve(model, requests, dtype=bf16,
                                         **SERVE),
            "scan lane": lambda: timed_serve(model, requests, dtype=bf16,
                                             lane="xla", **SERVE)}
    rates = {name: [] for name in runs}
    # in turns; the scan-lane server (about 8 s a run) once, in the middle
    for name in ("speculative", "fused", "scan lane", "fused",
                 "speculative"):
        rates[name].append(tokens / runs[name]())
    print(f"[chip_smoke] {card}: adapted stories15M bf16, {N_REQUESTS} "
          f"requests, generated tok/s (in turns: speculative, fused, scan "
          f"lane, fused, speculative): " + "; ".join(
              f"{name} {', '.join(f'{r:.1f}' for r in v)}"
              for name, v in rates.items()))
    return launches


def check_adapted_kernels(model, card):
    """The kernels of phase 4r's LoRA paths against their plain versions
    at the shapes those paths give them, then timed there: K1 at
    POSITIONS and K2 (B = 8, pos 512) on the adapted model's bfloat16
    fused weights (the adapters folded in), with phase 3's gates; K3/K4 on
    float32 (1, LORA_L, 6, 48). Returns ({kernel: max error}, {kernel:
    (ms, plain_ms, bound_ms, bound_by, library_ms)})."""
    errs, ms = {}, {}
    with torch.no_grad():
        for pos in POSITIONS:
            got, want, confident, err = kernel_vs_plain(model, "bf16", pos)
            if err > cache_atol("bf16") or (got != want and confident):
                raise AssertionError(f"adapted bf16 pos {pos}: K1 token {got} "
                                     f"(plain {want}), cache error {err}")
            errs["decode_token"] = max(errs.get("decode_token", 0.0), err)
        got, want, conf, err = batched_vs_plain(model, "bf16", 8, 512)
        if not cache_ok("bf16", err) or not (got == want)[conf].all():
            raise AssertionError(f"adapted bf16 K2 B=8: tokens "
                                 f"{got.tolist()} != plain {want.tolist()}, "
                                 f"cache error {err}")
        errs["decode_token_batched"] = err
        ms["decode_token"] = time_k1(model, "bf16", card, "adapted ") \
            + (None,)
        ms["decode_token_batched"] = time_k2(model, "bf16", 8, card,
                                             "adapted ") + (None,)
    e = flash_vs_plain(1, LORA_L, torch.float32)
    for name, keys in zip(FLASH_KERNELS, (("o", "lse"), ("dq",),
                                          ("dk", "dv"))):
        errs[name] = max(e[x] for x in keys)
    ms.update(time_flash(1, LORA_L, card))
    print(f"[chip_smoke] adapted model's kernels vs plain: max errors "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    return errs, ms


def timed_serve(model, requests, **kw):
    torch.cuda.synchronize()
    start = time.perf_counter()
    serve(model, requests, **kw)
    return time.perf_counter() - start


def big_spec_requests(model, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, model.vocab_size, BIG_SPEC_PROMPT).tolist(),
             BIG_SPEC_NEW) for _ in range(BIG_SPEC_REQUESTS)]


def implied_qmm_launches(forwards, products):
    """The launches ``qmm_counters`` should read after scan-lane forwards
    of (layer rows, head rows) each, ``products`` stacked layer products a
    forward (``gemv_quant``'s routes by rows: the decode kernel quantizing
    its rows itself up to FUSED_QUANT_MAX_ROWS, ``quantize_rows`` first
    above, the prefill kernel above MAX_DECODE_ROWS)."""
    from pydynet_tpu_torch.ops import gemv_quant as gq

    out = dict.fromkeys(QMM_KERNELS, 0)
    for layer_rows, head_rows in forwards:
        for rows, n, name in ((layer_rows, products, "qmatmul_stacked"),
                              (head_rows, 1, "qmatmul")):
            out["quantize_rows"] += n * (rows > gq.FUSED_QUANT_MAX_ROWS)
            prefill = rows > gq.MAX_DECODE_ROWS
            out["qmatmul_prefill"] += n * prefill
            if name == "qmatmul_stacked" or not prefill:
                out[name] += n
    return out


def check_big_speculative(big, card):
    """The 7B geometry, int8: the speculative server's launches against
    the implied counts, its streams against ``generate(quant="int8",
    fused=False)`` by the parting rule, tok/s beside the scan-lane server,
    tokens a verify iteration, peak memory, one verify chunk's device time
    by kernel. Returns {kernel: launches}."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from pydynet_tpu_torch.models.llama import serve_spec

    bf16 = torch.bfloat16
    requests = big_spec_requests(big)
    spec_serve(big, [(requests[0][0], 4)], dtype=bf16,
               **dict(BIG_SPEC, chunk=1))  # warm-up
    waves = []
    admit = serve_spec.SpecLlamaServer._admit_many
    serve_spec.SpecLlamaServer._admit_many = \
        lambda self, prompts, slots: waves.append(len(slots)) or admit(
            self, prompts, slots)
    try:
        torch.cuda.reset_peak_memory_stats()
        zero_qmm_counters()
        srv, spec, secs = spec_serve(big, requests, dtype=bf16, **BIG_SPEC)
        launches = qmm_counters()
    finally:
        serve_spec.SpecLlamaServer._admit_many = admit
    peak = torch.cuda.max_memory_allocated() / 2**30
    iters, accepted = srv.spec_iterations, srv.spec_accepted
    del srv
    # the forwards: a verify iteration's B * (K + 1) rows (32), each wave's
    # k * BIG_SPEC_PROMPT prompt rows, its head on the k last rows; each
    # forward runs 4 layer products a layer (K7) and the head (K5)
    forwards = [(BIG_SPEC_ROWS, BIG_SPEC_ROWS)] * iters + [
        (k * BIG_SPEC_PROMPT, k) for k in waves]
    want = implied_qmm_launches(forwards, 4 * big.n_layers)
    print(f"[chip_smoke] 7B int8 speculative B=4: {iters} verify "
          f"iterations, {len(waves)} admission waves {waves}, launches "
          f"{launches}")
    if launches != want:
        raise AssertionError(f"7B speculative launches {launches}, want "
                             f"{want}")
    refs = scan_references(big, requests, batch=4, dtype=bf16,
                           quant="int8")
    gate_partings(big, requests, refs, spec, "7B int8 speculative B=4",
                  dtype=bf16, quant="int8")
    tokens = sum(map(len, spec))
    xla = [timed_serve(big, requests, dtype=bf16, quant="int8", lane="xla",
                       batch_size=4, chunk=16, eos_id=-1)]
    spec_s = [secs, spec_serve(big, requests, dtype=bf16, **BIG_SPEC)[2]]
    print(f"[chip_smoke] {card}: 7B int8 B=4, {len(requests)} requests of "
          f"{BIG_SPEC_PROMPT}-token prompts, {BIG_SPEC_NEW} new tokens: "
          f"speculative {', '.join(f'{tokens / s:.1f}' for s in spec_s)} "
          f"tok/s, scan-lane server {', '.join(f'{tokens / s:.1f}' for s in xla)}"
          f" tok/s (in turns); {tokens / iters:.2f} tokens a verify "
          f"iteration of the fleet ({accepted} drafts accepted); peak "
          f"memory {peak:.1f} GiB")
    srv = serve_spec.SpecLlamaServer(big, dtype=bf16, **dict(BIG_SPEC,
                                                              chunk=1))
    for p, _ in requests[:4]:
        srv.submit(p, max_new_tokens=BIG_SPEC_NEW)
    srv._try_admit()
    win = min(big.max_seq_len, 256)
    srv._spec_chunk(win)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        srv._spec_chunk(win)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    by_kernel(prof, 1, "7B int8 verify iteration (B=4, K=7, window 256)",
              top=8)
    print(f"[chip_smoke] 7B int8 verify iteration: {wall * 1e3:.1f} ms, "
          f"{len(kernel_events(prof))} kernels, device busy "
          f"{100 * busy_share(prof, wall) / wall:.1f} %")
    return launches


def check_lora_and_speculative(model, big, card):
    """Phase 4r (module doc). Returns ({kernel: launches} of its runs, the
    LoRA paths' {kernel: max error} and {kernel: times})."""
    check_generator(card)
    check_dropout_step()
    adapted, pat, launches = check_lora_training(card)
    k1, k2 = check_adapted_serving(adapted, model, pat, card)
    errs, ms = check_adapted_kernels(adapted, card)
    del adapted
    launches.update(decode_token=k1, decode_token_batched=k2)
    launches.update(check_big_speculative(big, card))
    return launches, errs, ms


def first_token_s(model, prompt, **kw):
    """Seconds to the first token of ``generate`` on ``prompt`` (its
    prefill: the total length is the prompt's plus one), synchronised."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    toks = list(model.generate(prompt, prompt.shape[1] + 1, **kw))
    torch.cuda.synchronize()
    if len(toks) != 1:
        raise AssertionError(f"{len(toks)} tokens from a first-token run")
    return time.perf_counter() - start


def first_tokens_in_turns(model, prompt, **kw):
    """{flash: seconds of LONG_REPEATS first tokens} on the two prefill
    routes, after one untimed run each, the routes in turns (dense, flash,
    flash, dense, ...)."""
    times = {False: [], True: []}
    for flash in times:
        first_token_s(model, prompt, flash_prefill=flash, **kw)
    for i in range(LONG_REPEATS):
        for flash in ((False, True) if i % 2 == 0 else (True, False)):
            times[flash].append(first_token_s(model, prompt,
                                              flash_prefill=flash, **kw))
    return times


def check_long_prompt(model, big, card):
    """Long-prompt prefill: stories15M (bf16, the fused lane) and the 7B
    geometry (int8, the scan lane) each prefill a LONG_PROMPTS prompt
    through the dense scores and through K3 and decode LONG_NEW tokens; K3
    launches n_layers times on a flash prefill and never on a dense one;
    both routes pass the confident-step gate (the prefill token included)
    against the dense truth; their times to the first token in turns; the
    routes' crossover at 7B width; K3 against its plain version at the 7B
    prefill's shape, timed beside its bound and SDPA's forward. Returns
    (K3 launches on the flash generates, K3's max error, its (ms,
    plain_ms, bound_ms, bound_by, library_ms))."""
    import torch.nn.functional as F

    from pydynet_tpu_torch.models.llama import model as lm
    from pydynet_tpu_torch.ops import flash_attention as fa
    from pydynet_tpu_torch.utils import fidelity

    bf16 = torch.bfloat16
    rng = np.random.default_rng(3)
    main_launches = 0
    cases = (("stories15M", model, dict(dtype=bf16)),
             ("7B", big, dict(dtype=bf16, quant="int8")))
    with torch.no_grad():
        for name, m, kw in cases:
            L = LONG_PROMPTS[name]
            prompt = rng.integers(1, m.vocab_size, (1, L))
            if name == "stories15M":
                if not m.use_fused(None, 1):
                    raise AssertionError("stories15M left the fused lane")
                truth, margins, tops = fidelity.greedy_truth(m, prompt,
                                                             LONG_NEW)
                gate = fidelity.gate_fused_argmax
            else:
                if m.use_fused("int8", 1):
                    raise AssertionError("7B int8 left the scan lane")
                truth, margins, tops = fidelity.scan_truth(
                    m, prompt, LONG_NEW, dtype=bf16, quant="int8")
                gate = fidelity.gate_scan_argmax
            streams = {}
            for flash in (False, True):
                torch.cuda.synchronize()
                fa.flash_attention_fwd.launches = 0
                streams[flash] = [int(t[0, 0]) for t in m.generate(
                    prompt, L + LONG_NEW, flash_prefill=flash, **kw)]
                launches = fa.flash_attention_fwd.launches
                want = m.n_layers if flash else 0
                print(f"[chip_smoke] long prompt {name} L={L} "
                      f"{'flash' if flash else 'dense'}: "
                      f"{len(streams[flash])} tokens, K3 launches "
                      f"{launches} (want {want})")
                if launches != want or len(streams[flash]) != LONG_NEW \
                        or not all(0 <= x < m.vocab_size
                                   for x in streams[flash]):
                    raise AssertionError(f"long prompt {name}: {launches} "
                                         f"K3 launches, stream "
                                         f"{streams[flash]}")
                main_launches += launches
                checked, ok, agree = gate(m, prompt, truth, margins, tops,
                                          flash=flash, **kw)
                print(f"[chip_smoke] gate long prompt {name} "
                      f"{'flash' if flash else 'dense'} against the "
                      f"{'f32' if name == 'stories15M' else 'dense int8'} "
                      f"truth: checked {checked} ok {ok} agree {agree:.3f}")
                if not (checked > 0 and ok):
                    raise AssertionError(f"long prompt {name}: the "
                                         f"{'flash' if flash else 'dense'} "
                                         f"route failed its gate")
            same = next((i for i, (a, b) in enumerate(zip(*streams.values()))
                         if a != b), LONG_NEW)
            print(f"[chip_smoke] long prompt {name}: the routes' streams "
                  f"agree on their first {same} of {LONG_NEW} tokens")
            times = first_tokens_in_turns(m, prompt, **kw)
            print(f"[chip_smoke] {card}: long prompt {name} L={L} time to "
                  f"the first token, ms of {LONG_REPEATS} in turns: " +
                  "; ".join(f"{'flash' if f else 'dense'} "
                            f"{', '.join(f'{t * 1e3:.1f}' for t in ts)} "
                            f"(median {float(np.median(ts)) * 1e3:.1f})"
                            for f, ts in times.items()))
        # the crossover at 7B width, on the scan lane's int8 prefill
        wins = {}
        for n in CROSSOVER_LENGTHS:
            prompt = rng.integers(1, big.vocab_size, (1, n - 1))  # pads to n
            times = first_tokens_in_turns(big, prompt, dtype=bf16,
                                          quant="int8")
            med = {f: float(np.median(ts)) for f, ts in times.items()}
            wins[n] = med[True] < med[False]
            print(f"[chip_smoke] {card}: 7B int8 prefill padded to {n}: "
                  f"median of {LONG_REPEATS} dense {med[False] * 1e3:.1f} "
                  f"ms, flash {med[True] * 1e3:.1f} ms")
        cross = next((n for n in CROSSOVER_LENGTHS
                      if all(wins[x] for x in CROSSOVER_LENGTHS if x >= n)),
                     None)
        print(f"[chip_smoke] {card}: flash prefill crossover at 7B width: "
              f"{cross} (FLASH_PREFILL_MIN is {lm.FLASH_PREFILL_MIN})")
        # K3 at the 7B prefill's shape
        B, L, H, d = LONG_FLASH_SHAPE
        errs = flash_vs_plain(B, L, bf16, d=d, heads=H, backward=False)
        q, k, v, _ = flash_inputs(B, L, bf16, 1, d, H)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        kern = lambda: fa.flash_attention_fwd(q, k, v)
        ref = lambda: fa.flash_attention_fwd_ref(q, k, v, d ** -0.5)
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=True)
        k1, p1, l1 = time_step(kern, 20), time_step(ref, 3), \
            time_step(lib, 20)
        k2, p2, l2 = time_step(kern, 20), time_step(ref, 3), \
            time_step(lib, 20)
        b_ms, b_by = flash_bound(q, FLASH_PRODUCTS["flash_attention_fwd"],
                                 True)
        ms = (min(k1, k2), min(p1, p2), b_ms, b_by, min(l1, l2))
        print(f"[chip_smoke] {card}: flash_attention_fwd bf16 "
              f"{LONG_FLASH_SHAPE}: kernel {ms[0] * 1e3:.1f} us, plain "
              f"{ms[1] * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by}), "
              f"F.scaled_dot_product_attention(is_causal=True) "
              f"{ms[4] * 1e3:.1f} us; max error {errs}")
    return main_launches, max(errs.values()), ms


def time_rotating(fn, reps, n):
    """ms a call of ``fn(i)`` for i cycling over n layers: the weights of
    one layer are cold in L2 again by the time the loop comes back. The
    host enqueues the calls as it goes, so a call that costs the host more
    than the device is timed at the host's rate."""
    return time_step(lambda: [fn(i) for i in range(n)], reps) / n


def time_graph(fn, n, replays=5):
    """Device ms a call of ``fn(i)``, i cycling over n layers: the n calls
    captured once in a CUDA graph and replayed, so no host time falls
    between the launches."""
    fn(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    ms = time_step(graph.replay, replays) / n
    del graph
    return ms


def time_big_dims(model, card):
    """Phase 5's 7B part: tokens/s of the request and the server, and each
    quantized matmul against its bound, its plain version and
    ``torch._int_mm``. Returns {(kernel): (ms, plain_ms, bound_ms,
    bound_by, library_ms)} at the shapes the kernels line reports."""
    from pydynet_tpu_torch.models.llama.serve import LlamaServer
    from pydynet_tpu_torch.ops import gemv_quant as gq

    bf16 = torch.bfloat16
    total = PROMPT.shape[1] + BIG_NEW
    rates = {"int8": [], "int4": []}
    serve_rates = []
    requests = big_requests(model, BIG_TIME_REQUESTS)
    for _ in range(BIG_REPEATS):  # the formats in turns
        for quant, r in rates.items():
            start = time.perf_counter()
            n = sum(1 for _ in model.generate(PROMPT, total, dtype=bf16,
                                              quant=quant))
            torch.cuda.synchronize()
            r.append(n / (time.perf_counter() - start))
        start = time.perf_counter()
        srv, done = serve(model, requests, dtype=bf16, quant="int4",
                          **BIG_SERVE)
        serve_rates.append(sum(len(x.tokens) for x in done)
                           / (time.perf_counter() - start))
    n_tok = sum(len(x.tokens) for x in done)
    for quant, r in rates.items():
        print(f"[chip_smoke] {card}: 7B generate {quant} B=1 {BIG_NEW}-token "
              f"request, tok/s of {BIG_REPEATS} runs: "
              f"{', '.join(f'{x:.2f}' for x in r)}; median "
              f"{float(np.median(r)):.2f} ({1e3 / float(np.median(r)):.2f} "
              f"ms/token)")
    # time to the first token of a TTFT_PROMPT-token prompt on the scan
    # lane: its prefill runs the 4 x 32 layer products through K7's
    # prefill kernel (M = TTFT_PROMPT rows > MAX_DECODE_ROWS), the head
    # through K5 (the last row)
    prompt = np.random.default_rng(2).integers(1, model.vocab_size,
                                               (1, TTFT_PROMPT))
    ttft = {"int8": [], "int4": []}

    def first_token(quant):
        gen = model.generate(prompt, TTFT_PROMPT + 1, dtype=bf16,
                             quant=quant)
        tok = next(gen)
        gen.close()
        return tok

    for quant in ttft:  # warm-up
        first_token(quant)
    L = model.n_layers
    for _ in range(BIG_REPEATS):  # the formats in turns
        for quant, r in ttft.items():
            torch.cuda.synchronize()
            zero_qmm_counters()
            start = time.perf_counter()
            first_token(quant)
            torch.cuda.synchronize()
            r.append(time.perf_counter() - start)
            ran = qmm_counters()
            if ran["qmatmul_stacked"] != 4 * L or ran["qmatmul"] != 1 \
                    or ran["qmatmul_prefill"] != 4 * L:
                raise AssertionError(f"7B {TTFT_PROMPT}-token prefill "
                                     f"{quant}: launches {ran}")
    for quant, r in ttft.items():
        print(f"[chip_smoke] {card}: 7B scan lane {quant}, "
              f"{TTFT_PROMPT}-token prompt: ms to the first token of "
              f"{BIG_REPEATS} runs {', '.join(f'{x * 1e3:.2f}' for x in r)}; "
              f"median {float(np.median(r)) * 1e3:.2f} ({4 * L} stacked "
              f"products of {TTFT_PROMPT} rows through the prefill kernel, "
              f"the head through the decode kernel)")
    print(f"[chip_smoke] {card}: 7B serve int4 B=4, {BIG_TIME_REQUESTS} "
          f"requests, {n_tok} tokens, {srv.dispatched_steps} steps, generated "
          f"tok/s of {BIG_REPEATS} runs: "
          f"{', '.join(f'{x:.2f}' for x in serve_rates)}; median "
          f"{float(np.median(serve_rates)):.2f}")

    out = {}
    L = model.n_layers
    for quant in ("int8", "int4"):
        q4 = quant == "int4"
        W = model._weights_xq(bf16, quant)
        for name in QMM_NAMES:
            stacked = name != "head"
            wq = W[name + "_xq"]
            ws = W[name + "_xs"]
            K, N = wq.shape[-2] * (2 if q4 else 1), wq.shape[-1]
            spec = (BIG_SPEC_ROWS, BIG_SPEC_WAVE) if quant == "int8" else ()
            for M in (1, 4, 256) + spec:
                x = random_rows(M, K, bf16, M)
                if stacked:
                    ids = W["layer_ids"]
                    kern = lambda i: gq.qmatmul(x, wq[i], ws[i], q4=q4)
                    stack = lambda i: gq.qmatmul_stacked(x, wq, ws, ids[i],
                                                         q4=q4)
                    plain = lambda: gq.qmatmul_ref(x, wq[0], ws[0], q4=q4)
                    n = L
                else:
                    kern = lambda i: gq.qmatmul(x, wq, ws, q4=q4)
                    stack = None
                    plain = lambda: gq.qmatmul_ref(x, wq, ws, q4=q4)
                    n = 1
                w1 = wq[0] if stacked else wq
                b_ms, b_by = qmm_bound(x, w1, M, N)
                reps = max(3, 32 // n)
                p1 = time_step(plain, 2)
                k1 = time_graph(kern, n, reps)
                s1 = time_graph(stack, n, reps) if stack else None
                call = time_rotating(kern, reps, n)
                k2 = time_graph(kern, n, reps)
                s2 = time_graph(stack, n, reps) if stack else None
                p2 = time_step(plain, 2)
                lib, libs = None, ""
                if M > 16 and not q4:  # torch._int_mm takes M > 16
                    # the weights as the port stores them, (K, N) row-major,
                    # and a column-major copy made here, outside the timing:
                    # cuBLASLt's int8 tensor-core products want that layout
                    xq = gq.quantize_rows(x)[0]
                    wt = wq.transpose(-1, -2).contiguous()
                    row = time_graph(lambda i: torch._int_mm(
                        xq, wq[i] if stacked else wq), n, reps)
                    col = time_graph(lambda i: torch._int_mm(
                        xq, (wt[i] if stacked else wt).t()), n, reps)
                    del wt
                    lib = min(row, col)
                    libs = (f"{row * 1e3:.1f} us row-major, "
                            f"{col * 1e3:.1f} us column-major (faster: "
                            f"{'row' if row <= col else 'column'}-major)")
                kms, pms = min(k1, k2), min(p1, p2)
                sms = min(s1, s2) if stack else None
                gbs = nbytes(w1) / (kms * 1e-3) / 1e9
                print(f"[chip_smoke] {card}: {quant} {name} ({K}, {N}) M={M}: "
                      f"qmatmul {kms * 1e3:.1f} us on the device ({gbs:.0f} "
                      f"GB/s of weights; {call * 1e3:.1f} us a call with the "
                      f"host's enqueue)"
                      + (f", stacked {sms * 1e3:.1f} us" if stack else "")
                      + f", bound {b_ms * 1e3:.1f} us ({b_by}; the call "
                      f"at {100 * b_ms / kms:.1f} % of it), plain "
                      f"{pms * 1e3:.1f} us, torch._int_mm "
                      + (libs or "none"))
                out[quant, name, M] = (kms, sms, pms, b_ms, b_by, lib)
    D = model.embed_dim
    for quant in ("int8", "int4"):  # K11's counterpart: the probes' shape
        kms = out[quant, "wgu", 1][0]
        w_bytes = nbytes(model._weights_xq(bf16, quant)["wgu_xq"][0])
        print(f"[chip_smoke] {card}: {quant} weight stream of wgu "
              f"({D}, {2 * model.ffn_dim}), M=1: "
              f"{w_bytes / (kms * 1e-3) / 1e9:.0f} GB/s")
    for M, key in ((1, "quantize_rows"),
                   (BIG_SPEC_ROWS, "quantize_rows spec")):
        x = random_rows(M, D, bf16, 0)
        q_ms = time_graph(lambda i: gq.quantize_rows(x), 100)
        q_plain = time_step(lambda: gq.quantize_rows_ref(x), 50)
        q_bound = bound(nbytes(x) + M * (D + 4), 3 * M * D, bf16)
        print(f"[chip_smoke] {card}: quantize_rows ({M}, {D}) bf16: kernel "
              f"{q_ms * 1e3:.1f} us, plain {q_plain * 1e3:.1f} us, bound "
              f"{q_bound[0] * 1e3:.3f} us")
        out[key] = (q_ms, q_plain) + q_bound
    return out


def bn_inputs(N, C, dtype, seed=0, device="cuda", pdtype=torch.float32):
    """Seeded O(1) K8 inputs: x (N, C) normal in ``dtype``, gamma in
    [0.5, 1.5] and beta normal / 2, (1, C) in ``pdtype``."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((N, C), generator=g, device=device).to(dtype)
    gamma = torch.rand((1, C), generator=g, device=device) + 0.5
    beta = torch.randn((1, C), generator=g, device=device) / 2
    return x, gamma.to(pdtype), beta.to(pdtype)


def bn_seam_shapes(itemsize):
    """The (N, C) batches that cut K8 at its seams (``ops/batchnorm.py``'s
    ``bn_plan``) for x of ``itemsize`` bytes: the first split of a strip
    into two slabs (2 MIN_SLAB_ROWS - 1 and + 1 rows, the last slab one row
    short or long), one slab short and long by a row at (1024, 1024), the
    largest N a cluster holds in shared memory and the next one past it
    (one strip), and C one column either side of the strip width."""
    from pydynet_tpu_torch.ops import batchnorm as bn

    W = bn.STRIP_BYTES // itemsize
    cut = 2 * bn.MIN_SLAB_ROWS
    plan = bn.bn_plan(1024, 1024, itemsize)
    full = plan["cluster"] * plan["rows"]
    held = bn.MAX_CLUSTER * (bn.SLAB_BYTES // bn.STRIP_BYTES)
    return ((cut - 1, 1024), (cut + 1, 1024), (full - 1, 1024),
            (full + 1, 1024), (held, W), (held + 1, W), (1000, W - 1),
            (1000, W + 1), (40, W + 1))


def bn_vs_plain(N, C, dtype, seed=0, pdtype=torch.float32):
    """K8 against its plain version on the same inputs, and the gradients
    through the autograd op against autograd through the plain forward,
    gamma and beta in ``pdtype``. Raises beyond the stated tolerances;
    returns {output: max error}."""
    from pydynet_tpu_torch.ops import batchnorm as bn

    x, gamma, beta = bn_inputs(N, C, dtype, seed, pdtype=pdtype)
    got = bn.batch_norm_train(x, gamma, beta)
    want = bn.batch_norm_train_ref(x, gamma, beta)
    xs = [t.detach().clone().requires_grad_() for t in (x, gamma, beta)]
    ws = [t.detach().clone().requires_grad_() for t in (x, gamma, beta)]
    dout = torch.randn(x.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(seed + 1)).to(dtype)
    grads = torch.autograd.grad(bn.batch_norm_train(*xs)[0], xs, dout)
    plain = torch.autograd.grad(bn.batch_norm_train_ref(*ws)[0], ws, dout)
    torch.cuda.synchronize()
    errs = {}
    bf16 = dtype == torch.bfloat16
    for name, a, b in zip(("out", "mean", "var"), got, want):
        err = (a.float() - b.float()).abs()
        tol = BN_ATOL[name]
        if bf16:
            tol = tol + BF16_ULP * b.float().abs() if name == "out" \
                else BN_BF16_STATS_ATOL
        if a.shape != b.shape or a.dtype != b.dtype \
                or not bool((err <= tol).all()):
            raise AssertionError(f"batch_norm_train ({N}, {C}) {dtype} "
                                 f"{name}: max error {float(err.max())} "
                                 f"beyond tolerance")
        errs[name] = float(err.max())
    for name, a, b in zip(("dx", "dgamma", "dbeta"), grads, plain):
        err = float((a.float() - b.float()).abs().max())
        big = float(b.float().abs().max())
        tol = BN_GRAD_RTOL * big + (BF16_ULP * big if bf16 else 0.0)
        if err > tol:
            raise AssertionError(f"batch_norm_train ({N}, {C}) {dtype} "
                                 f"{name}: error {err} > {tol}")
        errs[name] = err
    return errs


def bn_same_bits(N, C, dtype, seed=0):
    """Whether two K8 runs on the same inputs give the same bits of out,
    mean and var."""
    from pydynet_tpu_torch.ops import batchnorm as bn

    x, gamma, beta = bn_inputs(N, C, dtype, seed)
    a, b = (bn.batch_norm_train(x, gamma, beta) for _ in range(2))
    return all(torch.equal(u, v) for u, v in zip(a, b))


def bn_plan_on_card(N, C, itemsize):
    """``bn_plan`` as the CUDA source computes it."""
    import ctypes

    from pydynet_tpu_torch.ops import _build

    out = (ctypes.c_int * 5)()
    if _build.load().pdt_batch_norm_plan(N, C, itemsize, out) != 0:
        raise ValueError(f"pdt_batch_norm_plan({N}, {C}, {itemsize})")
    return dict(zip(("width", "strips", "cluster", "rows", "cached"), out))


def check_batchnorm():
    """Phase 3d: K8 against plain at BN_SHAPES in float32 and bfloat16, at
    its seams (bn_seam_shapes) in the four type pairs, two runs' bits equal,
    ops/batchnorm.py's bn_plan equal to the CUDA source's, and a float64
    CUDA input raising. Returns the largest float32 error."""
    from pydynet_tpu_torch.ops import batchnorm as bn

    worst = 0.0
    for dname, dtype in BN_DTYPES.items():
        for N, C in BN_SHAPES:
            e = bn_vs_plain(N, C, dtype)
            print(f"[chip_smoke] batch_norm_train {dname} ({N}, {C}): max "
                  f"error " + ", ".join(f"{k} {v:.3g}" for k, v in e.items()))
            if dtype == torch.float32:
                worst = max(worst, e["out"], e["mean"], e["var"])
    for dtype, pdtype in BN_TYPE_PAIRS:
        size = torch.finfo(dtype).bits // 8
        for N, C in bn_seam_shapes(size):
            e = bn_vs_plain(N, C, dtype, pdtype=pdtype)
            plan = bn.bn_plan(N, C, size)
            print(f"[chip_smoke] batch_norm_train seam x {dtype} gamma "
                  f"{pdtype} ({N}, {C}), plan {plan}: max error " +
                  ", ".join(f"{k} {v:.3g}" for k, v in e.items()))
            if dtype == torch.float32:
                worst = max(worst, e["out"], e["mean"], e["var"])
    for dtype in BN_DTYPES.values():
        size = torch.finfo(dtype).bits // 8
        shapes = BN_SHAPES + bn_seam_shapes(size)
        for N, C in shapes:
            want = {k: v for k, v in bn.bn_plan(N, C, size).items()
                    if k != "held_all"}
            if bn_plan_on_card(N, C, size) != want:
                raise AssertionError(f"bn_plan({N}, {C}, {size}) differs "
                                     f"from the CUDA source's")
        same = [(N, C) for N, C in ((8192, 1024),) + shapes[-5:]
                if bn_same_bits(N, C, dtype, 11)]
        print(f"[chip_smoke] batch_norm_train {dtype}: bn_plan equal to the "
              f"CUDA source's at {len(shapes)} shapes; two runs' bits equal "
              f"at {same}")
        if len(same) != 6:
            raise AssertionError(f"batch_norm_train {dtype}: two runs differ")
    x, gamma, beta = bn_inputs(8, 16, torch.float64)
    try:
        bn.batch_norm_train(x, gamma.double(), beta.double())
    except ValueError as e:
        print(f"[chip_smoke] float64 on the card raises: {e}")
    else:
        raise AssertionError("batch_norm_train took a float64 CUDA tensor")
    return worst


def dbn_first_step(device, seed=0):
    """DNN_BN from ``seed`` on ``device`` after one Adam step (lr 5e-5) on
    the trainer's first 40 faces; returns (net, loss)."""
    from pydynet_tpu_torch import manual_seed
    from pydynet_tpu_torch.examples import dropout_bn as dbn
    from pydynet_tpu_torch.nn import CrossEntropyLoss
    from pydynet_tpu_torch.optim import Adam

    manual_seed(seed)
    net = dbn.DNN_BN().to(device)
    opt = Adam(net.parameters(), lr=DBN_LR)
    X, y = dbn.load_faces()
    bx, by = (torch.from_numpy(a[:40]).to(device) for a in (X, y))
    loss = dbn.train_step([net], [opt], CrossEntropyLoss(), bx, by)[0]
    return net, float(loss)


def check_dbn_step_vs_cpu():
    """DNN_BN's first step on the card (two K8 launches) against the same
    step on the CPU: loss, gradients, weights and running statistics.
    Returns the largest (gradient, weight, statistic) differences.

    fc1.bias and fc2.bias feed a BatchNorm, which takes away any constant
    shift of its input: their gradients are zero up to rounding on either
    device, and Adam's first step moves each by up to lr in a direction
    that rounding alone decides. They are held to that (their gradients
    within 1e-4 of the largest gradient of their layer's weight, their
    values within 2 lr of the CPU's), every other parameter to
    ``check_step_vs_cpu``'s rule."""
    from pydynet_tpu_torch.ops import batchnorm as bn

    before = bn.batch_norm_train.launches
    gpu, gpu_loss = dbn_first_step("cuda")
    if bn.batch_norm_train.launches - before != 2:
        raise AssertionError("DNN_BN's step did not launch K8 twice")
    cpu, cpu_loss = dbn_first_step("cpu")
    if abs(gpu_loss - cpu_loss) > TRAIN_LOSS_RTOL * abs(cpu_loss):
        raise AssertionError(f"DNN_BN step loss {gpu_loss} != CPU "
                             f"{cpu_loss}")
    for fc in (gpu.fc1, gpu.fc2, cpu.fc1, cpu.fc2):
        if float(fc.bias.grad.abs().max()) \
                > 1e-4 * float(fc.weight.grad.abs().max()):
            raise AssertionError("a bias before a BatchNorm got more than "
                                 "rounding noise of gradient")
    for name in ("fc1", "fc2"):
        g, c = getattr(gpu, name).bias, getattr(cpu, name).bias
        if float((g.detach().cpu() - c.detach()).abs().max()) > 2 * DBN_LR:
            raise AssertionError(f"{name}.bias moved more than lr")
    g_err, w_err = check_step_vs_cpu(gpu, cpu, DBN_LR / 10,
                                     skip=("fc1.bias", "fc2.bias"))
    s_err = max(float((a.cpu() - b).abs().max())
                for a, b in zip(gpu.buffers(), cpu.buffers()))
    if s_err > 1e-5:
        raise AssertionError(f"running statistics differ by {s_err}")
    print(f"[chip_smoke] DNN_BN step 1 vs CPU: loss {gpu_loss:.6f} vs "
          f"{cpu_loss:.6f}, max gradient error {g_err:.3g}, max weight "
          f"error {w_err:.3g}, max running-statistic error {s_err:.3g}")
    return g_err, w_err, s_err


def check_nn_training():
    """Phase 4e: the nn-stack trainers. DNN_BN's first step against the
    CPU; the dropout_bn trainer at its published setting through K8 (its
    counter set to 0 just before and read just after); the MNIST ConvNet
    at its defaults; both CLIs once. Returns K8's launches in the main
    run."""
    from pydynet_tpu_torch.examples import dropout_bn as dbn
    from pydynet_tpu_torch.examples import mnist
    from pydynet_tpu_torch.ops import batchnorm as bn

    check_dbn_step_vs_cpu()
    k8 = bn.batch_norm_train
    k8.launches = k8.captured = 0
    (_, history, accs), launches, (eager, captured, replays) = k8_runs(
        lambda: dbn.train(epochs=DBN_EPOCHS))
    print(f"[chip_smoke] dropout_bn {DBN_EPOCHS} epochs through the jit: "
          f"K8 launches {launches} ({eager} eager, then {captured} captured "
          f"in the graph x {replays} replays), mean losses first "
          f"{history[0]} last {history[-1]}, test accuracies {accs}")
    want = 2 * DBN_EPOCHS * DBN_STEPS
    if launches != want or eager != 2:
        raise AssertionError(f"K8 launches {launches}, want {want}")
    if not all(np.isfinite(history[0] + history[-1])) or not all(
            b < a for a, b in zip(history[0], history[-1])):
        raise AssertionError(f"a net's loss did not fall: {history}")
    acc = mnist.main(["--network", "conv", "--synthetic"])
    print(f"[chip_smoke] MNIST ConvNet 20 epochs: test accuracy {acc}")
    if not acc > MNIST_MIN_ACC:
        raise AssertionError(f"MNIST ConvNet accuracy {acc} <= "
                             f"{MNIST_MIN_ACC}")
    accs, cli_launches, _ = k8_runs(lambda: dbn.cli(["--epochs", "2"]))
    acc = mnist.main(["--network", "mlp", "--synthetic", "--epochs", "2"])
    print(f"[chip_smoke] CLIs: dropout_bn accuracies {accs}, K8 launches "
          f"{cli_launches}; MNIST MLP accuracy {acc}")
    if cli_launches != 2 * 2 * DBN_STEPS or not 0 < acc <= 1:
        raise AssertionError("the CLIs did not train through K8")
    return launches


def bn_bound(x):
    """K8's bound: x read once and out written once, gamma and beta read,
    mean and var written; about 8 float32 operations an element."""
    C = x.shape[1]
    return bound(2 * nbytes(x) + 4 * 4 * C, 8 * x.numel(), torch.float32)


def dbn_step_runner(seed=0):
    """The dropout_bn train step of the three nets on the card, on the
    first batch: a callable for timing and profiling."""
    from pydynet_tpu_torch import manual_seed
    from pydynet_tpu_torch.examples import dropout_bn as dbn
    from pydynet_tpu_torch.nn import CrossEntropyLoss
    from pydynet_tpu_torch.optim import Adam

    manual_seed(seed)
    nets = [dbn.DNN().cuda(), dbn.DNN_dropout().cuda(), dbn.DNN_BN().cuda()]
    optims = [Adam(n.parameters(), lr=DBN_LR) for n in nets]
    X, y = dbn.load_faces()
    bx, by = (torch.from_numpy(a[:40]).cuda() for a in (X, y))
    loss_fn = CrossEntropyLoss()
    return lambda: dbn.train_step(nets, optims, loss_fn, bx, by)


def mnist_runner(seed=42):
    """The MNIST ConvNet on the card with its Adam and the synthetic
    training set there: a callable that runs one epoch through the jit and
    waits."""
    from pydynet_tpu_torch import manual_seed
    from pydynet_tpu_torch.examples import mnist
    from pydynet_tpu_torch.optim import Adam

    manual_seed(seed)
    net = mnist.ConvNet().cuda()
    opt = Adam(net.parameters(), lr=1e-4)
    (X, y), _ = mnist.synthetic_mnist()
    Xd = torch.from_numpy(X.astype(np.float32)).cuda()
    yd = torch.from_numpy(y).cuda()

    jtrain = mnist.train_jit(net, opt)

    def epoch():
        perm = torch.from_numpy(np.random.permutation(len(X))).cuda()
        loss, steps = mnist.train_epoch(net, opt, Xd[perm], yd[perm], 256,
                                        jtrain)
        float(loss)
        return steps, len(X)

    return epoch


def time_nn_training(card):
    """Phase 5's nn part: K8 at BN_TIME_SHAPES in float32 against its plain
    version, its bound and ``F.batch_norm``, and in bfloat16 against its
    bound and ``F.batch_norm``; the MNIST ConvNet's epochs through the jit.
    Returns {(N, C): (ms, plain_ms, bound_ms, bound_by, library_ms)}."""
    import torch.nn.functional as tF
    from pydynet_tpu_torch.ops import batchnorm as bn

    out = {}
    with torch.no_grad():
        for N, C in BN_TIME_SHAPES:
            x, gamma, beta = bn_inputs(N, C, torch.float32, 3)
            g, b = gamma.reshape(-1), beta.reshape(-1)
            kern = lambda i: bn.batch_norm_train(x, gamma, beta)
            ref = lambda i: bn.batch_norm_train_ref(x, gamma, beta)
            lib = lambda i: tF.batch_norm(x, None, None, g, b, training=True,
                                          eps=1e-6)
            # device time: CUDA-graph replays of 20 calls, in turns
            plain, kernel, library = (time_graph(ref, 20), time_graph(kern, 20),
                                      time_graph(lib, 20))
            kernel2, plain2 = time_graph(kern, 20), time_graph(ref, 20)
            call = time_step(lambda: kern(0), 200)  # with the host's enqueue
            out[N, C] = (min(kernel, kernel2), min(plain, plain2)) \
                + bn_bound(x) + (library,)
            print(f"[chip_smoke] {card}: batch_norm_train f32 ({N}, {C}): "
                  f"kernel {out[N, C][0] * 1e3:.2f} us on the device "
                  f"({call * 1e3:.2f} us a call with the host's enqueue), "
                  f"plain {out[N, C][1] * 1e3:.2f} us, bound "
                  f"{out[N, C][2] * 1e3:.3f} us ({out[N, C][3]}), "
                  f"F.batch_norm {library * 1e3:.2f} us")
            xb = x.to(torch.bfloat16)
            kern = lambda i: bn.batch_norm_train(xb, gamma, beta)
            lib = lambda i: tF.batch_norm(xb, None, None, g, b,
                                          training=True, eps=1e-6)
            kernel, library = time_graph(kern, 20), time_graph(lib, 20)
            print(f"[chip_smoke] {card}: batch_norm_train bf16 ({N}, {C}): "
                  f"kernel {kernel * 1e3:.2f} us on the device, bound "
                  f"{bn_bound(xb)[0] * 1e3:.3f} us, F.batch_norm "
                  f"{library * 1e3:.2f} us")
    epoch = mnist_runner()
    epoch()  # warm-up
    times = []
    for _ in range(5):
        start = time.perf_counter()
        steps, samples = epoch()
        times.append(time.perf_counter() - start)
    t = float(np.median(times))
    print(f"[chip_smoke] {card}: MNIST ConvNet train epoch through the jit "
          f"({steps} steps of 256) s of 5 epochs: {', '.join(f'{x:.4f}' for x in times)}; "
          f"median {steps / t:.1f} steps/s, {samples / t:.0f} samples/s")
    return out


def profile_nn(card):
    """Phase 6's nn part: the dropout_bn step's largest kernels and the
    device's busy share over 20 steps."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    step, n = dbn_step_runner(), 20
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    by_kernel(prof, n, f"dropout_bn step on {card}", top=15)
    busy = busy_share(prof, wall)
    print(f"[chip_smoke] profile dropout_bn step: {n} steps in {wall:.3f} s, "
          f"{len(kernel_events(prof)) // n} kernels a step, device busy "
          f"{busy:.3f} s = {100 * busy / wall:.1f} %, idle "
          f"{100 - 100 * busy / wall:.1f} %")



# ---------------- phase 4j: the jit, the RNNs and their trainers ------------
def jit_case(name, steps=JIT_STEPS, seed=0):
    """One of phase 4j's steps on the card, built from ``seed``: ``(fn,
    state, args)``, ``args`` the argument tuples of ``steps`` calls."""
    from pydynet_tpu_torch import nn, optim
    from pydynet_tpu_torch.examples import dropout_bn as dbn
    from pydynet_tpu_torch.examples import ts_prediction as tsp
    from pydynet_tpu_torch.nn import functional as F

    rng = np.random.default_rng(seed)

    def rand(*shape, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) + shift).astype(
            np.float32)).cuda()

    def sgd_or_adam(net, sgd):
        return (optim.SGD(net.parameters(), lr=0.01, momentum=0.0,
                          nesterov=False) if sgd
                else optim.Adam(net.parameters(), lr=1e-2))

    if name == "gd":
        w = torch.tensor(5.0).cuda().requires_grad_()

        def step(lr):
            w.grad = None
            loss = (w - 2.0) ** 2
            loss.backward()
            with torch.no_grad():
                w.sub_(lr * w.grad)
            return loss

        return step, [w], [(0.1,)] * steps
    if name in ("bn-sgd", "adam", "adam-dropout", "accum"):
        mid = {"bn-sgd": [nn.BatchNorm1d(32)],
               "adam-dropout": [nn.Dropout(0.5)]}.get(name, [])
        net = torch.nn.Sequential(nn.Linear(6, 32), *mid, nn.Tanh(),
                                  nn.Linear(32, 2)).cuda()
        opt = sgd_or_adam(net, name in ("bn-sgd", "accum"))
        if name == "accum":  # 4 microbatches, each loss scaled by 1/4
            def step(xs, ys):
                opt.zero_grad()
                for i in range(4):
                    loss = F.mse_loss(net(xs[i]), ys[i]) / 4
                    loss.backward()
                opt.step()
                return loss

            return step, (net, opt), [(rand(4, 6, 6), rand(4, 6, 2))
                                      for _ in range(steps)]

        def step(x, y):
            opt.zero_grad()
            loss = F.mse_loss(net(x), y)
            loss.backward()
            opt.step()
            return loss

        return step, (net, opt), [(rand(16, 6, shift=3.0), rand(16, 2))
                                  for _ in range(steps)]
    if name == "lstm":
        lstm, head = nn.LSTM(2, 8).cuda(), nn.Linear(8, 1).cuda()
        opt = optim.Adam(list(lstm.parameters()) + list(head.parameters()),
                         lr=1e-2)

        def step(x, y):
            opt.zero_grad()
            _, (hn, _) = lstm(x)
            loss = F.mse_loss(head(hn[0]), y)
            loss.backward()
            opt.step()
            return loss

        return step, (lstm, head, opt), [(rand(8, 4, 2), rand(4, 1))
                                         for _ in range(steps)]
    if name == "dropout-mask":
        x = torch.ones(4096).cuda()
        return (lambda: F.dropout(x, 0.5)), (), [()] * steps
    if name == "ts_prediction":
        model = tsp.RNN().cuda()
        opt = optim.Adam(model.parameters(), lr=0.01)
        crit = nn.MSELoss()
        X, _, Y, _ = (t.cuda() for t in tsp.data())
        return (lambda bx, by: tsp.train_step(model, opt, crit, bx, by),
                (model, opt), [(X, Y)] * steps)
    if name == "dropout_bn":
        nets = [dbn.DNN().cuda(), dbn.DNN_dropout().cuda(),
                dbn.DNN_BN().cuda()]
        optims = [optim.Adam(n.parameters(), lr=DBN_LR) for n in nets]
        loss_fn = nn.CrossEntropyLoss()
        X, y = dbn.load_faces()
        order = rng.permutation(320)
        rows = [order[(40 * i) % 320:(40 * i) % 320 + 40]
                for i in range(steps)]
        return (lambda bx, by: dbn.train_step(nets, optims, loss_fn, bx, by),
                (nets, optims), [(torch.from_numpy(X[r]).cuda(),
                                  torch.from_numpy(y[r]).cuda())
                                 for r in rows])
    raise ValueError(f"no jit case {name!r}")


def jit_vs_eager(name, steps=JIT_STEPS, seed=0, counter=None):
    """Case ``name`` for ``steps`` calls eagerly and through ``jit`` (its
    first call eager, a graph from the second), each from ``manual_seed(
    seed)``. Returns ``(err, bit, keys_ok, jit, counts)``: the largest
    difference of an output or a state tensor over its largest element,
    whether all were equal to the bit, whether the threefry keys after each
    call were equal on both routes (and, where the case draws, new at every
    call), the jit, and ``counter``'s (launches, captured) moves on each
    route."""
    from torch.utils import _pytree as pytree
    from pydynet_tpu_torch import default_generator, jit, manual_seed
    from pydynet_tpu_torch.jit import _collect_state

    runs, counts = {}, {}
    for route in ("eager", "graph"):
        manual_seed(seed)
        fn, state, args = jit_case(name, steps, seed)
        j = jit(fn, state=state) if route == "graph" else None
        before = counter and (counter.launches, counter.captured)
        outs, keys = [], []
        for a in args:
            outs += [t.detach().clone()
                     for t in pytree.tree_leaves((j or fn)(*a))]
            keys.append(default_generator.state.clone())
        torch.cuda.synchronize()
        if counter:
            counts[route] = (counter.launches - before[0],
                             counter.captured - before[1])
        runs[route] = (outs + [t.detach().clone()
                               for _, t, _ in _collect_state(state)], keys, j)
    err, bit = 0.0, True
    for a, b in zip(runs["graph"][0], runs["eager"][0]):
        bit = bit and torch.equal(a, b)
        d = float((a.double() - b.double()).abs().max())
        err = max(err, d / max(float(b.double().abs().max()), 1e-30))
    gk, ek = runs["graph"][1], runs["eager"][1]
    keys_ok = all(torch.equal(a, b) for a, b in zip(gk, ek))
    if name in ("adam-dropout", "dropout-mask", "dropout_bn"):
        keys_ok = keys_ok and all(not torch.equal(a, b)
                                  for a, b in zip(gk, gk[1:]))
    return err, bit, keys_ok, runs["graph"][2], counts


def made_by(module, attr):
    """A context in which every ``module.attr(...)`` call's result is also
    appended to the list it yields (the jits an example builds)."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        made, real = [], getattr(module, attr)
        setattr(module, attr, lambda *a, **k: made.append(real(*a, **k))
                or made[-1])
        try:
            yield made
        finally:
            setattr(module, attr, real)

    return ctx()


def k8_runs(run):
    """Run ``run()`` (a dropout_bn training through its jit) and count K8's
    launches: the wrapper's own (the eager first step) plus the launches
    the graph captured times its replays. Returns (run's result,
    launches, (eager, captured a graph, replays))."""
    from pydynet_tpu_torch.examples import dropout_bn as dbn
    from pydynet_tpu_torch.ops import batchnorm as bn

    k8 = bn.batch_norm_train
    before = (k8.launches, k8.captured)
    with made_by(dbn, "steps") as made:
        out = run()
    jtrain = made[0][0]
    if len(made) != 1 or len(jtrain.graphs) != 1:
        raise AssertionError(f"dropout_bn made {len(made)} jits, "
                             f"{len(jtrain.graphs)} graphs")
    eager, captured = k8.launches - before[0], k8.captured - before[1]
    return out, eager + captured * jtrain.replays, (eager, captured,
                                                    jtrain.replays)


def runs_in_turns(runners, rounds):
    """Seconds of each runner's call, ``rounds`` times in turns; each
    runner is called once first, untimed."""
    times = {name: [] for name in runners}
    for run in runners.values():
        run()
    torch.cuda.synchronize()
    for _ in range(rounds):
        for name, run in runners.items():
            start = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - start)
    return times


def profile_calls(fn, n):
    """(kernels a call, device busy share) of ``n`` calls of ``fn`` under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    return len(kernel_events(prof)) / n, busy_share(prof, wall) / wall


def transformer_first_step(device, X, y, seed=0):
    """The transformer example's net at full width from ``seed`` (built on
    the CPU, copied to ``device``) after one Adam step on its first batch
    of 128; returns (net, loss)."""
    from pydynet_tpu_torch import manual_seed
    from pydynet_tpu_torch.examples import transformer as tf
    from pydynet_tpu_torch.optim import Adam

    manual_seed(seed)
    net, _ = tf.build(int(X.max()) + 1, X.shape[1], TF_LR, "cpu")
    net.to(device)
    opt = Adam([p for p in net.parameters() if p.requires_grad], lr=TF_LR)
    loss = tf.train_step(net, opt, torch.from_numpy(X[:128]).to(device),
                         torch.from_numpy(y[:128]).to(device))
    return net, float(loss.detach())


def check_jit(card):
    """Phase 4j: every jit case's graph route against its eager route
    (K8 inside the bn-sgd and dropout_bn graphs); ts_prediction's 50
    epochs; the transformer at full width, its first step against the
    CPU's and two epochs through ``foreach``; then the timings, eager
    against the jit in turns."""
    from pydynet_tpu_torch.examples import transformer as tf
    from pydynet_tpu_torch.examples import ts_prediction as tsp
    from pydynet_tpu_torch.ops import batchnorm as bn

    k8 = bn.batch_norm_train
    for name in JIT_CASES:
        err, bit, keys_ok, j, counts = jit_vs_eager(name, counter=k8)
        print(f"[chip_smoke] jit {name}: graph vs eager over {JIT_STEPS} "
              f"steps, max relative error {err:.3g}, "
              f"{'bit-equal' if bit else 'not bit-equal'}; "
              f"{len(j.graphs)} graph, {j.replays} replays; threefry keys "
              f"{'equal' if keys_ok else 'DIFFERENT'}; K8 (launches, "
              f"captured) eager {counts['eager']}, graph {counts['graph']}")
        if err > JIT_RTOL or not keys_ok or len(j.graphs) != 1 \
                or j.replays != JIT_STEPS - 1:
            raise AssertionError(f"jit {name}: the graph route differs")
        if name == "dropout-mask" and not bit:
            raise AssertionError("jit: dropout masks differ from eager")
        per = {"bn-sgd": 1, "dropout_bn": 2}.get(name, 0)
        eager, captured = counts["graph"]
        if counts["eager"] != (per * JIT_STEPS, 0) or captured != per \
                or eager + captured * j.replays != per * JIT_STEPS:
            raise AssertionError(f"jit {name}: K8 ran {counts}, want "
                                 f"{per} a step")

    final = tsp.main()
    print(f"[chip_smoke] ts_prediction 50 epochs through the jit: final "
          f"test loss {final:.5f}")
    if not final < TS_MAX_LOSS:
        raise AssertionError(f"ts_prediction test loss {final}")

    X, y = tf.synthetic_cola()
    y = np.where(y == 0, -1.0, 1.0).astype(np.float32)
    gpu, gpu_loss = transformer_first_step("cuda", X, y)
    cpu, cpu_loss = transformer_first_step("cpu", X, y)
    if abs(gpu_loss - cpu_loss) > TRAIN_LOSS_RTOL * abs(cpu_loss):
        raise AssertionError(f"transformer step loss {gpu_loss} != CPU "
                             f"{cpu_loss}")
    # the product before norm2 (the JAX package's LayerNorm, over the
    # leading axes) has a bias whose gradient is rounding noise
    g_err, w_err, small = check_adam_step_vs_cpu(
        gpu, cpu, TF_LR, noise={"layers.0.feed_forward.2.bias":
                                "layers.0.feed_forward.2.weight"})
    print(f"[chip_smoke] transformer (dim 512, B=128) step 1 vs CPU: loss "
          f"{gpu_loss:.6f} vs {cpu_loss:.6f}, max gradient error "
          f"{g_err:.3g}, max weight error {w_err:.3g} where the gradient is "
          f"above 10 eps' ({small} weights below it, each within 2 lr)")
    with made_by(tf, "steps") as made:
        acc = tf.main(["--epochs", str(TF_EPOCHS)])
    jtrain = made[0][0]
    print(f"[chip_smoke] transformer {TF_EPOCHS} epochs through "
          f"jtrain.foreach: test accuracy {acc:.4f}; {len(jtrain.graphs)} "
          f"graphs, {jtrain.replays} replays")
    if not 0 <= acc <= 1 or len(jtrain.graphs) != 2 or jtrain.replays < 20:
        raise AssertionError("the transformer did not train through graphs")
    time_jit(card, X, y)


def time_jit(card, X, y):
    """Phase 4j's timings, each route from one seed, in turns: the
    dropout_bn step (steps/s, kernels a step, busy share), the
    ts_prediction epoch and the transformer epoch (full width, the device
    loop of eager steps against ``foreach``)."""
    from pydynet_tpu_torch import manual_seed
    from pydynet_tpu_torch.examples import transformer as tf
    from pydynet_tpu_torch.examples import ts_prediction as tsp
    from pydynet_tpu_torch.jit import jit
    from pydynet_tpu_torch.nn import MSELoss
    from pydynet_tpu_torch.optim import Adam

    def pair(make):
        """{route: the callable ``make(route)`` builds}, each from seed
        0."""
        out = {}
        for route in ("eager", "jit"):
            manual_seed(0)
            out[route] = make(route)
        return out

    def dbn_step(route):
        fn, state, args = jit_case("dropout_bn", 1)
        call = jit(fn, state=state) if route == "jit" else fn
        return lambda: call(*args[0])

    steps = pair(dbn_step)
    for run in steps.values():  # the jit's eager call and its capture
        run()
        run()
    times = runs_in_turns({k: (lambda f=f: [f() for _ in range(JIT_TIMED)])
                           for k, f in steps.items()}, JIT_ROUNDS)
    for route, f in steps.items():
        kernels, busy = profile_calls(f, 10)
        rates = [JIT_TIMED / t for t in times[route]]
        print(f"[chip_smoke] {card}: dropout_bn train step {route}: steps/s "
              f"of {JIT_ROUNDS} runs of {JIT_TIMED} in turns "
              f"{', '.join(f'{r:.1f}' for r in rates)}; median "
              f"{float(np.median(rates)):.1f}; {kernels:.0f} kernels a step, "
              f"device busy {100 * busy:.1f} %")

    def ts_epoch(route):
        model = tsp.RNN().cuda()
        opt = Adam(model.parameters(), lr=0.01)
        Xtr, Xte, Ytr, Yte = (t.cuda() for t in tsp.data())
        if route == "jit":
            jtrain, jeval = tsp.steps(model, opt)
        else:
            crit = MSELoss()
            jtrain = lambda bx, by: tsp.train_step(model, opt, crit, bx, by)
            jeval = lambda bx, by: tsp.eval_step(model, crit, bx, by)

        def epoch():
            model.train()
            jtrain(Xtr, Ytr)
            model.eval()
            with torch.no_grad():
                jeval(Xte, Yte)

        return lambda: [epoch() for _ in range(TS_TIMED)]

    times = runs_in_turns(pair(ts_epoch), JIT_ROUNDS)
    for route, t in times.items():
        print(f"[chip_smoke] {card}: ts_prediction epoch (one full-batch "
              f"step of 1568 windows and the test loss) {route}: ms of "
              f"{JIT_ROUNDS} runs of {TS_TIMED} in turns "
              f"{', '.join(f'{1e3 * x / TS_TIMED:.3f}' for x in t)}; median "
              f"{1e3 * float(np.median(t)) / TS_TIMED:.3f}")

    Xd = torch.from_numpy(X[:1638]).cuda()
    yd = torch.from_numpy(y[:1638]).cuda()

    def tf_epoch(route):
        net, opt = tf.build(int(X.max()) + 1, X.shape[1], TF_LR, "cuda")
        net.train()
        if route == "jit":
            jtrain = tf.steps(net, opt)[0]
            return lambda: tf.device_epoch(jtrain, Xd, yd, 128)
        eager = _EagerSteps(lambda a, b: tf.train_step(net, opt, a, b))
        return lambda: tf.device_epoch(eager, Xd, yd, 128)

    times = runs_in_turns(pair(tf_epoch), JIT_ROUNDS)
    for route, t in times.items():
        print(f"[chip_smoke] {card}: transformer epoch (dim 512, 1638 "
              f"sentences, 12 batches of 128 and one of 102) "
              f"{'foreach' if route == 'jit' else route}: ms of "
              f"{JIT_ROUNDS} epochs in turns "
              f"{', '.join(f'{1e3 * x:.2f}' for x in t)}; median "
              f"{1e3 * float(np.median(t)):.2f}")


class _EagerSteps:
    """A step with the jit's call and ``foreach``, run eagerly: the
    transformer's epoch loop without the graphs."""

    def __init__(self, step) -> None:
        self.step = step

    def __call__(self, *args):
        return self.step(*args)

    def foreach(self, *args):
        return torch.stack([self.step(*a) for a in zip(*args)])


# ----------------------------- phase 4t: the tape ---------------------------
def tape_op(name, device, dtype, seed=0):
    """One tape op on ``device``: its value and its inputs' gradients of
    ``sum(op(...) * weights)``, as NumPy arrays, from seeded inputs."""
    import pydynet_tpu_torch as pdt

    fn, shapes = TAPE_OPS[name]
    rng = np.random.default_rng(seed)
    dev = pdt.Device(device)
    ts = [pdt.Tensor(rng.standard_normal(s).astype(dtype),
                     requires_grad=True, device=dev) for s in shapes]
    out = fn(pdt, *ts)
    wgt = pdt.Tensor(rng.standard_normal(out.shape).astype(dtype),
                     device=dev)
    (out * wgt).sum().backward()
    return [out.numpy()] + [t.grad.cpu().numpy() for t in ts]


def tape_vs_cpu(name, dtype):
    """The largest error of the op's value and gradients on the card
    against the CPU, relative to each reference's largest magnitude."""
    err = 0.0
    for g, w in zip(tape_op(name, "cuda", dtype), tape_op(name, "cpu", dtype)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"tape {name}: {g.shape} {g.dtype} on the "
                                 f"card, {w.shape} {w.dtype} on the CPU")
        scale = max(float(np.abs(w).max()), 1e-30)
        err = max(err, float(np.abs(g.astype(np.float64) - w).max()) / scale)
    return err


def autograd2d_run(route, steps=TAPE_STEPS):
    """autograd2d's point after each of ``steps`` steps on the card, the
    step through the jit (``route="jit"``) or called directly; returns the
    (steps + 1, 2) trajectory and the jitted step."""
    from pydynet_tpu_torch import Device
    from pydynet_tpu_torch.examples import autograd2d

    w, jstep = autograd2d.build(0.1, Device("cuda"))
    step = jstep if route == "jit" else jstep.__wrapped__
    traj = [w.torch.clone()]
    for _ in range(steps):
        step()
        traj.append(w.torch.clone())
    return torch.stack(traj), jstep


def host_cpu_name():
    """The host CPU's model as ``/proc/cpuinfo`` gives it (its model name,
    else, where it reads "unknown", its vendor, family and model
    numbers), with the cores this process may use."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            info.setdefault(key.strip(), value.strip())
    name = next((info[k] for k in ("model name", "Model")
                 if info.get(k, "unknown") != "unknown"), None)
    name = name or " ".join(f"{k} {info[k]}" for k in (
        "vendor_id", "cpu family", "model", "CPU implementer", "CPU part")
        if k in info) or platform.machine()
    return f"{name}, {len(os.sched_getaffinity(0))} cores"


def numpy_lane_gate(model, truth, margins, tops):
    """``(checked, ok)``: the NumPy lane teacher-forced on ``truth`` (the
    prompt, then each truth token) gives the truth's token at every
    confident step."""
    from pydynet_tpu_torch.models.llama import cpu_decode
    from pydynet_tpu_torch.utils import fidelity

    w = cpu_decode.build_np_weights(model)
    st = cpu_decode._State(model, w["tok"].dtype)
    feed = [int(t) for t in PROMPT[0]] + [int(t) for t in truth[:-1, 0]]
    got = []
    for pos, tok in enumerate(feed):
        logits = cpu_decode._advance(model, w, st, tok, pos,
                                     pos >= PROMPT.shape[1] - 1)
        if logits is not None:
            got.append(int(np.argmax(logits)))
    conf = fidelity._confident(margins[:, 0], tops[:, 0], fidelity.MARGIN,
                               fidelity.REL_MARGIN)
    ok = all(got[i] == truth[i, 0] for i in np.flatnonzero(conf))
    return int(conf.sum()), ok and conf.any()


def check_tape(model, card):
    """Phase 4t: the tape on the card (module docstring)."""
    import pydynet_tpu_torch as pdt
    from pydynet_tpu_torch.examples import autograd1d, autograd2d
    from pydynet_tpu_torch.models.llama.tokenizer import Tokenizer
    from pydynet_tpu_torch.native import NativeVocab
    from pydynet_tpu_torch.utils import fidelity

    before = kernel_launches()
    gpu1, err1 = autograd1d.main(device="cuda")
    cpu1, _ = autograd1d.main(device="cpu")
    e1 = float(np.abs(gpu1 - cpu1).max())
    print(f"[chip_smoke] tape autograd1d on the card: max |auto - manual| "
          f"{err1:.3g}, trajectory vs CPU {e1:.3g}")
    if e1 > TAPE_TOL[np.float64]:
        raise AssertionError(f"autograd1d on the card differs by {e1}")

    jit_traj, jstep = autograd2d_run("jit")
    eager_traj, _ = autograd2d_run("eager")
    cpu2 = autograd2d.main(device="cpu")
    main2 = autograd2d.main(device="cuda")
    bit = torch.equal(jit_traj, eager_traj)
    e2 = float(np.abs(jit_traj.cpu().numpy() - cpu2).max())
    print(f"[chip_smoke] tape autograd2d {TAPE_STEPS} steps through the jit:"
          f" {len(jstep.graphs)} graph, {jstep.replays} replays, "
          f"{'bit-equal' if bit else 'NOT bit-equal'} to eager; vs CPU "
          f"{e2:.3g}; final {jit_traj[-1].tolist()}")
    if not bit or len(jstep.graphs) != 1 \
            or jstep.replays != TAPE_STEPS - 1 or e2 > TAPE_TOL[np.float64] \
            or not np.array_equal(main2, jit_traj.cpu().numpy()):
        raise AssertionError("autograd2d through the jit differs")

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True  # the tape must ignore it
    try:
        worst = {}
        for dtype in TAPE_TOL:
            for name in TAPE_OPS:
                err = tape_vs_cpu(name, dtype)
                worst[np.dtype(dtype).name] = max(
                    worst.get(np.dtype(dtype).name, 0.0), err)
                if err > TAPE_TOL[dtype]:
                    raise AssertionError(f"tape {name} {np.dtype(dtype)} on "
                                         f"the card: error {err}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"[chip_smoke] tape ops: {len(TAPE_OPS)} ops' values and "
          f"gradients vs CPU, worst relative error {worst} (TF32 on "
          "globally)")
    try:
        pdt.Tensor(np.ones(2), device="cuda") + pdt.Tensor(np.ones(2))
    except RuntimeError as e:
        if "different devices" not in str(e):
            raise
    else:
        raise AssertionError("a mixed-device op did not raise")

    rates = {"eager": [], "jit": []}
    for _ in range(TAPE_ROUNDS):
        for route in rates:
            w, jstep = autograd2d.build(0.1, pdt.Device("cuda"))
            step = jstep if route == "jit" else jstep.__wrapped__
            step()
            step()
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(TAPE_TIMED):
                step()
            torch.cuda.synchronize()
            rates[route].append(TAPE_TIMED / (time.perf_counter() - start))
    for route, r in rates.items():
        print(f"[chip_smoke] {card}: autograd2d step {route}, steps/s of "
              f"{TAPE_ROUNDS} runs: {', '.join(f'{x:.1f}' for x in r)}; "
              f"median {float(np.median(r)):.1f}")

    n_new = NUMPY_REQUEST - PROMPT.shape[1]
    truth, margins, tops = fidelity.greedy_truth(model, PROMPT, n_new)
    checked, ok = numpy_lane_gate(model, truth, margins, tops)
    start = time.perf_counter()
    lane = [int(t) for t in model.generate(PROMPT, NUMPY_REQUEST,
                                           fused="numpy")]
    secs = time.perf_counter() - start
    fused = [int(t) for t in model.generate(PROMPT, NUMPY_REQUEST,
                                            fused=True)]
    conf = fidelity._confident(margins[:, 0], tops[:, 0], fidelity.MARGIN,
                               fidelity.REL_MARGIN)
    part = next((i for i in range(n_new) if lane[i] != fused[i]), n_new)
    print(f"[chip_smoke] NumPy lane, {NUMPY_REQUEST}-token stories15M "
          f"request: teacher-forced gate {checked} confident steps "
          f"{'ok' if ok else 'FAILED'}; stream equal to the fused lane's for "
          f"{part} of {n_new} tokens; {len(lane) / secs:.1f} tok/s on the "
          f"host ({host_cpu_name()}), beside {card}")
    if not ok or len(lane) != n_new or (part < n_new and conf[part]):
        raise AssertionError("the NumPy lane differs at a confident step")

    tok = Tokenizer(None)
    if tok._native is None:
        raise AssertionError("the native merge engine did not load")
    tokens = ["<unk>", "<s>", "</s>", "a", "b", "c", "ab", "abc", "bc", "ca"]
    scores = [0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 5.0, 9.0, 6.0, 4.0]
    tok.vocab, tok.scores = tokens, scores
    tok._index = {t: i for i, t in enumerate(tokens)}
    tok._native = NativeVocab.create(tokens, scores)
    texts = ["abc", "cab", "aabbcc", "abcabcabc", "xyz abc", "", "ccabba"]
    native = [tok.encode(t) for t in texts]
    tok._native = None
    if native != [tok.encode(t) for t in texts]:
        raise AssertionError("the native merge differs from the Python one")
    print(f"[chip_smoke] native merge engine loaded, equal to the Python "
          f"merge on {len(texts)} texts")
    after = kernel_launches()
    fused_k1 = after["fused_decode_token"] - before["fused_decode_token"]
    ran = {k: after[k] - before[k] for k in after
           if after[k] != before[k] and k != "fused_decode_token"}
    if ran or fused_k1 != n_new - 1:
        raise AssertionError(f"the tape phase launched port kernels: {ran}, "
                             f"K1 {fused_k1} (the fused-lane comparison's "
                             f"{n_new - 1})")


# ------------------------- phase 4v: CLIP ViT-B/32 -------------------------
def kernel_launches():
    """{wrapper: launches} of every hand-written kernel's wrapper."""
    from pydynet_tpu_torch.ops import batchnorm as bn
    from pydynet_tpu_torch.ops import decode_step as dsk

    out = {name: k.launches for name, k in zip(FLASH_KERNELS,
                                                flash_counters())}
    out.update(qmm_counters())
    for k in (dsk.fused_decode_token, dsk.fused_decode_token_batched):
        out[k.__name__] = k.launches
        out[k.__name__ + "[emit]"] = k.emit_launches
    for k in (dsk.lm_head_argmax, dsk.fused_decode_step,
              bn.batch_norm_train):
        out[k.__name__] = k.launches
    return out


def clip_inputs(batch=1):
    """The CLI's synthetic image (``infer.load_image`` of a missing file) or
    ``batch`` seeded images, (N, 3, 224, 224) on the CPU, and the ids of
    CLIP_LABELS."""
    from pydynet_tpu_torch.models.clip import data, infer

    if batch == 1:
        img = infer.load_image("missing.png")[None]
    else:
        rng = np.random.default_rng(CLIP_SEED)
        img = torch.stack([data.preprocess_array(rng.uniform(
            0, 1, (256, 256, 3))) for _ in range(batch)])
    return img, data.tokenize(CLIP_LABELS.split(","))


def clip_twin(cpu, device, kind=None):
    """A copy of ``cpu`` on ``device`` made trainable for ``kind``:
    "proj" (the CLI's default projections), "lora" (CLIP_LORA, adapters
    drawn from seed 0) or None. Returns (model, (trainable, frozen))."""
    import copy

    from pydynet_tpu_torch import manual_seed

    model = copy.deepcopy(cpu).to(device)
    counts = None
    if kind == "proj":
        counts = model.set_trainable_parameters(CLIP_PROJ)
    elif kind == "lora":
        manual_seed(0)
        counts = model.add_lora(**CLIP_LORA)
    return model, counts


def clip_step_vs_cpu(gpu, cpu, gloss, closs, lr, label):
    """One fine-tune step on the card against the CPU's under the training
    gate (``check_step_vs_cpu`` over the trainable parameters, the loss
    within TRAIN_LOSS_RTOL). Returns the largest (gradient, weight)
    differences."""
    if abs(gloss - closs) > TRAIN_LOSS_RTOL * abs(closs):
        raise AssertionError(f"{label} step loss {gloss} != CPU {closs}")
    g_err, w_err = check_step_vs_cpu(gpu, cpu, lr / 10, skip=[
        n for n, p in gpu.named_parameters() if not p.requires_grad])
    print(f"[chip_smoke] CLIP {label} step vs CPU: loss {gloss:.7f} vs "
          f"{closs:.7f}, max gradient error {g_err:.3g}, max weight error "
          f"{w_err:.3g}")
    return g_err, w_err


def clip_profile(fn, n):
    """(kernels a call, device busy share) of ``n`` calls of ``fn`` under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    return len(kernel_events(prof)) / n, busy_share(prof, wall) / wall


def check_clip(card):
    """Phase 4v (module doc)."""
    import tempfile

    from pydynet_tpu_torch import optim
    from pydynet_tpu_torch.models.clip import CLIP, finetune, infer
    from pydynet_tpu_torch.nn import functional as F
    from pydynet_tpu_torch.utils import checkpoint as ck

    # float32 products stay float32 on this path, whatever ran before
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    before = kernel_launches()
    t0 = time.perf_counter()
    cpu = CLIP(device="cpu", generator=torch.Generator().manual_seed(0))
    gpu, _ = clip_twin(cpu, "cuda")
    n_params = sum(p.numel() for p in cpu.parameters())
    print(f"[chip_smoke] CLIP ViT-B/32: {n_params} parameters, built on the "
          f"CPU and copied to the card in {time.perf_counter() - t0:.1f} s")

    # zero-shot: the synthetic image against the three labels
    img, text = clip_inputs()
    with torch.no_grad():
        pg = F.softmax(gpu.eval()(img, text), axis=-1).cpu()[0]
        pc = F.softmax(cpu.eval()(img, text), axis=-1)[0]
    err = float((pg - pc).abs().max())
    top2 = torch.topk(pc, 2).values
    print(f"[chip_smoke] CLIP zero-shot {CLIP_LABELS!r}: card "
          f"{pg.tolist()}, CPU {pc.tolist()}, max error {err:.3g}, top-2 "
          f"gap {float(top2[0] - top2[1]):.3g}")
    if err > CLIP_PROB_ATOL or int(pg.argmax()) != int(pc.argmax()):
        raise AssertionError("CLIP zero-shot on the card differs from the "
                             "CPU")

    # timings: B=1 zero-shot, a batch of CLIP_BATCH images, the profiler
    timg, ttext = img.cuda(), torch.from_numpy(text).cuda()
    bimg, _ = clip_inputs(CLIP_BATCH)
    bimg = bimg.cuda()

    def zero_shot(x):
        with torch.no_grad():
            return F.softmax(gpu(x, ttext), axis=-1)

    for n, x in ((1, timg), (CLIP_BATCH, bimg)):
        ms = time_step(lambda: zero_shot(x), CLIP_REPEATS)
        kernels, busy = clip_profile(lambda: zero_shot(x), 5)
        print(f"[chip_smoke] {card}: CLIP zero-shot B={n} against 3 labels:"
              f" {ms:.3f} ms a call ({CLIP_REPEATS} back to back, CUDA "
              f"events), {n / ms * 1e3:.1f} images/s; {kernels:.0f} kernels "
              f"a forward, device busy {100 * busy:.1f} %")

    # fine-tuning: the first step against the CPU, then CLIP_STEPS
    tgt = np.array([CLIP_TARGET])
    for kind in ("proj", "lora"):
        g, gcounts = clip_twin(cpu, "cuda", kind)
        c, ccounts = clip_twin(cpu, "cpu", kind)
        if gcounts != ccounts:
            raise AssertionError(f"CLIP {kind} counts {gcounts} {ccounts}")
        gopt, copt = (optim.Adam([p for p in m.parameters()
                                  if p.requires_grad], lr=CLIP_LR)
                      for m in (g, c))
        gloss = g.finetune_step(img, text, tgt, gopt)
        closs = c.finetune_step(img, text, tgt, copt)
        clip_step_vs_cpu(g, c, gloss, closs, CLIP_LR, kind)
        losses = [gloss]
        start = time.perf_counter()
        for _ in range(CLIP_STEPS):
            losses.append(g.finetune_step(timg, ttext, tgt, gopt))
        steps_s = CLIP_STEPS / (time.perf_counter() - start)
        ks, busys = clip_profile(
            lambda: g.finetune_step(timg, ttext, tgt, gopt), 5)
        print(f"[chip_smoke] {card}: CLIP fine-tune {kind} ({gcounts[0]} "
              f"trainable, {gcounts[1]} frozen; Adam lr {CLIP_LR}): loss "
              f"{losses[0]:.6f} -> {losses[-1]:.6f} in {CLIP_STEPS} steps, "
              f"{steps_s:.2f} steps/s; {ks:.0f} kernels a step, device busy "
              f"{100 * busys:.1f} %")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"CLIP {kind} loss did not fall: {losses}")
        if kind == "proj":
            # the checkpoint: written on the card, resumed on the CPU
            with tempfile.TemporaryDirectory() as tmp:
                path = f"{tmp}/clip.npz"
                ck.save_checkpoint(path, g, gopt, step=int(gopt.t) - 1)
                c2, _ = clip_twin(cpu, "cpu", "proj")
                copt2 = optim.Adam([p for p in c2.parameters()
                                    if p.requires_grad], lr=1.0)
                if ck.load_checkpoint(path, c2, copt2) != int(gopt.t) - 1:
                    raise AssertionError("CLIP checkpoint step")
            mine = g.state_dict()
            for name, t in c2.state_dict().items():
                if not torch.equal(t, mine[name].cpu()):
                    raise AssertionError(f"resumed {name} differs")
            if copt2.t != gopt.t or copt2.lr != gopt.lr:
                raise AssertionError("resumed Adam state differs")
            gloss = g.finetune_step(img, text, tgt, gopt)
            closs = c2.finetune_step(img, text, tgt, copt2)
            clip_step_vs_cpu(g, c2, gloss, closs, CLIP_LR,
                             "resumed on the CPU, next")
            del c2
        del g, c

    # the other optimizers: one step each on the card against the CPU
    for name, kw in CLIP_OPTIMIZERS.items():
        g, _ = clip_twin(cpu, "cuda", "proj")
        c, _ = clip_twin(cpu, "cpu", "proj")
        gopt, copt = (getattr(optim, name)(
            [p for p in m.parameters() if p.requires_grad], **kw)
            for m in (g, c))
        gloss = g.finetune_step(img, text, tgt, gopt)
        closs = c.finetune_step(img, text, tgt, copt)
        clip_step_vs_cpu(g, c, gloss, closs, gopt.lr, name)
        del g, c

    # the CLIs, on the card
    infer.main(["--random-init", "--image", "missing.png"])
    with tempfile.TemporaryDirectory() as tmp:
        finetune.main(["--random-init", "--image", "missing.png",
                       "--labels", CLIP_LABELS, "--target",
                       str(CLIP_TARGET), "--steps", "2", "--save",
                       f"{tmp}/ft.npz"])
    after = kernel_launches()
    if after != before:
        raise AssertionError(f"the CLIP path launched a port kernel: "
                             f"{before} -> {after}")
    del gpu, cpu
    torch.cuda.empty_cache()


# ------------------------- the sampled decode path -------------------------
def check_key_stream():
    """Phase 4: the threefry key stream on the card against the CPU: keys,
    splits, fold-ins and bits equal, uniforms equal, Gumbel draws within
    GUMBEL_ATOL (the two devices' float32 log). Returns the largest Gumbel
    difference."""
    from pydynet_tpu_torch import random as prandom

    worst_g = 0.0
    for seed in (0, 7, -3, 2**33 + 5):
        keys = [prandom.PRNGKey(seed, dev) for dev in ("cpu", "cuda")]
        pairs = [(keys[1], keys[0]),
                 (prandom.split(keys[1], 5), prandom.split(keys[0], 5)),
            (prandom.fold_in(keys[1], torch.tensor([0, -7, 2**31 - 1],
                                                   device="cuda")),
             prandom.fold_in(keys[0], torch.tensor([0, -7, 2**31 - 1])))]
        for shape in ((3, 5), (8, 32000)):
            pairs += [(prandom.bits(keys[1], shape),
                       prandom.bits(keys[0], shape)),
                      (prandom.uniform(keys[1], shape),
                       prandom.uniform(keys[0], shape))]
            g = prandom.gumbel(keys[1], shape).cpu()
            worst_g = max(worst_g, max_diff(g, prandom.gumbel(keys[0],
                                                              shape)))
        for card, cpu in pairs:
            if not torch.equal(card.cpu(), cpu):
                raise AssertionError(f"key stream seed {seed}: the card's "
                                     f"{tuple(card.shape)} draw differs "
                                     "from the CPU's")
    print(f"[chip_smoke] key stream on the card: keys, splits, fold-ins, "
          f"bits and uniforms equal to the CPU's; Gumbel within "
          f"{worst_g:.3g}")
    if worst_g > GUMBEL_ATOL:
        raise AssertionError(f"Gumbel draws {worst_g} apart > {GUMBEL_ATOL}")
    return worst_g


def law_check(logits):
    """LAW_DRAWS draws from one fixed (V,) logits row through the sampling
    stage at bench.py's t 0.8, k 50, p 0.9 (the filters once, then Gumbel
    draws with LAW_DRAWS keys) against the filtered softmax: Pearson's
    chi-square, bins expected below 5 draws merged. Returns its p-value."""
    from scipy.stats import chi2
    from pydynet_tpu_torch import random as prandom
    from pydynet_tpu_torch.models.llama.model import filter_logits

    f = filter_logits(logits[None].float(), SAMPLE["temperature"],
                      SAMPLE["top_k"], SAMPLE["top_p"])
    keys = prandom.fold_in(prandom.PRNGKey(LAW_SEED, "cuda"),
                           torch.arange(LAW_DRAWS, device="cuda"))
    draws = torch.cat([prandom.categorical(k, f.expand(len(k), -1))
                       for k in keys.split(1024)])
    counts = torch.bincount(draws, minlength=f.shape[1]).double().cpu()
    expect = torch.softmax(f[0].double(), -1).cpu() * LAW_DRAWS
    if (counts[expect == 0] > 0).any():
        raise AssertionError("law check: a filtered-out token was drawn")
    big = expect >= 5
    obs = torch.cat([counts[big], counts[~big & (expect > 0)].sum()[None]])
    exp = torch.cat([expect[big], expect[~big & (expect > 0)].sum()[None]])
    keep = exp > 0
    stat = float(((obs - exp) ** 2 / exp)[keep].sum())
    dof = int(keep.sum()) - 1
    p = float(chi2.sf(stat, dof))
    print(f"[chip_smoke] law check: {LAW_DRAWS} draws over "
          f"{int((expect > 0).sum())} kept tokens ({dof + 1} bins), "
          f"chi-square {stat:.1f}, p = {p:.3g}")
    if not p > LAW_P_MIN:
        raise AssertionError(f"law check: p = {p} <= {LAW_P_MIN}")
    return p


def check_sampled(model, truth):
    """Phase 4's sampled part: the key stream, bench.py's logits and
    sampled gates (float32, B=1, along the f32 truth), a sampled bf16
    SAMPLED_SHORT-token request through K1's emit mode (its emit launches
    equal the decode steps, the argmax mode unused; the same seed twice the same
    stream; top_k = 1 the greedy stream), the law check, sampled
    ``generate`` at B=8 and with the int8 KV cache at B=1 through K2's emit
    mode. Returns K1's emit launches of the sampled request."""
    from pydynet_tpu_torch.ops import decode_step as dsk
    from pydynet_tpu_torch.utils import fidelity

    k1, k2 = dsk.fused_decode_token, dsk.fused_decode_token_batched
    short = SAMPLED_SHORT - PROMPT.shape[1] - 1
    check_key_stream()
    diff, ok = fidelity.gate_fused_logits(model, PROMPT, truth)
    print(f"[chip_smoke] gate logits-head-f32: {PATH_STEPS - 1} steps, max "
          f"|diff| {diff:.3g}, ok {ok}")
    if not ok:
        raise AssertionError("gate logits-head-f32 failed")
    checked, ok, agree = fidelity.gate_fused_sampled(model, PROMPT, truth)
    print(f"[chip_smoke] gate sampled-t0.8-k50-p0.9: checked {checked} ok "
          f"{ok} agree {agree:.3f}")
    if not (checked > 0 and ok):
        raise AssertionError("gate sampled-t0.8-k50-p0.9 failed")
    kw = dict(dtype=torch.bfloat16, **SAMPLE)
    list(model.generate(PROMPT, PROMPT.shape[1] + 3, seed=1, **kw))
    torch.cuda.synchronize()
    k1.launches = k1.emit_launches = 0
    toks = [int(t[0, 0]) for t in model.generate(PROMPT, SAMPLED_SHORT,
                                                 seed=SAMPLE_SEED, **kw)]
    emit_launches = k1.emit_launches
    print(f"[chip_smoke] generate bf16 sampled (t 0.8, k 50, p 0.9, seed "
          f"{SAMPLE_SEED}): {len(toks)} tokens, {emit_launches} emit "
          f"launches, {k1.launches} argmax-mode launches, "
          f"{len(set(toks))} distinct tokens")
    if emit_launches != short or k1.launches or len(toks) != short + 1 \
            or not all(0 <= x < CFG["vocab_size"] for x in toks):
        raise AssertionError(f"sampled request: {emit_launches} emit "
                             f"launches, {k1.launches} argmax launches, "
                             f"{len(toks)} tokens; want {short} steps")
    again = [int(t[0, 0]) for t in model.generate(PROMPT, SAMPLED_SHORT,
                                                  seed=SAMPLE_SEED, **kw)]
    if again != toks:
        raise AssertionError("the same seed gave another stream")
    greedy = [int(t[0, 0]) for t in model.generate(PROMPT, SAMPLED_SHORT,
                                                   dtype=torch.bfloat16)]
    top1 = [int(t[0, 0]) for t in model.generate(
        PROMPT, SAMPLED_SHORT, dtype=torch.bfloat16, temperature=0.8,
        top_k=1, seed=SAMPLE_SEED)]
    same = next((i for i, (a, b) in enumerate(zip(top1, greedy)) if a != b),
                len(greedy))
    print(f"[chip_smoke] generate bf16 top_k=1: equal to the greedy stream "
          f"for {same} of {len(greedy)} tokens")
    if same != len(greedy):
        raise AssertionError(f"top_k=1 left the greedy stream at {same}")
    lg = fidelity._teacher_forced_logits(model, PROMPT, truth[:2])[0][0]
    law_check(lg)
    for name, ids, extra, k in (("B=8", batch_prompt(8), {}, k2),
                                ("kv8 B=1", PROMPT,
                                 dict(kv_quant="int8"), k2)):
        before = k.emit_launches
        rows = list(model.generate(ids, SAMPLED_SHORT, seed=SAMPLE_SEED,
                                   **kw, **extra))
        launched = k.emit_launches - before
        print(f"[chip_smoke] generate bf16 sampled {name}: {len(rows)} "
              f"rows, {launched} K2 emit launches")
        if launched != short or len(rows) != short + 1 or any(
                r.shape != (ids.shape[0], 1) or r.min() < 0
                or r.max() >= CFG["vocab_size"] for r in rows):
            raise AssertionError(f"sampled generate {name}: {launched} "
                                 f"launches, {len(rows)} rows")
    return emit_launches


def check_sampled_serving(model):
    """Phase 4b's sampled part: a B=8 server at t 0.8, k 50, p 0.9 over the
    24-request mix with per-request overrides (``sampled_requests``, capped
    at SAMPLED_SERVE_NEW new tokens):
    K2's emit launches equal the steps of its sampled chunks and its
    argmax launches the rest; a seeded request admitted first gives the
    same tokens in two different fleets; the CLIs with the sampling flags.
    Returns K2's emit launches of the server run."""
    from pydynet_tpu_torch.models.llama import infer, serve_cli
    from pydynet_tpu_torch.ops import decode_step as dsk

    k1, k2 = dsk.fused_decode_token, dsk.fused_decode_token_batched
    requests = sampled_requests(model, SAMPLED_SERVE_NEW)
    kw = dict(dtype=torch.bfloat16, **SAMPLE, **SERVE)
    serve(model, requests[:2], **kw)  # warm-up
    k2.launches = k2.emit_launches = 0
    srv, done = serve(model, requests, **kw)
    emit_launches = k2.emit_launches
    n_tok = sum(len(r.tokens) for r in done)
    print(f"[chip_smoke] serve bf16 sampled B=8: {len(done)} requests, "
          f"{n_tok} tokens, {srv.dispatched_steps} steps dispatched, "
          f"{srv.sampled_steps} sampled, {emit_launches} K2 emit launches, "
          f"{k2.launches} argmax-mode launches")
    if not all(r.done and r.tokens for r in done) or not all(
            0 <= t < model.vocab_size for r in done for t in r.tokens):
        raise AssertionError("sampled serve: a request did not finish")
    if emit_launches != srv.sampled_steps or emit_launches == 0 \
            or k2.launches != srv.dispatched_steps - srv.sampled_steps:
        raise AssertionError(f"sampled serve: {emit_launches} emit and "
                             f"{k2.launches} argmax launches for "
                             f"{srv.sampled_steps} sampled of "
                             f"{srv.dispatched_steps} steps")
    # 17 tokens: longer than every prompt of the mix, so the target is
    # admitted first, at row 0, and prefilled alone in both fleets
    target = ((PROMPT[0].tolist() * 5)[:17], 64, dict(seed=4242))
    _, a = serve(model, [target] + requests[:7], **kw)
    _, b = serve(model, [target] + [(p, n, dict(temperature=0.0))
                                    for p, n, _ in requests[7:10]], **kw)
    print(f"[chip_smoke] seeded request in two fleets (8 and 4 requests): "
          f"{len(a[0].tokens)} tokens, equal {a[0].tokens == b[0].tokens}")
    if a[0].tokens != b[0].tokens or len(a[0].tokens) != 64:
        raise AssertionError("a seeded request's stream depends on its "
                             "fleet")
    flags = ["--temperature", "0.8", "--top-k", "50", "--top-p", "0.9"]
    for cli, k, extra in ((infer, k1, ["--max-new-tokens", "64"]),
                          (serve_cli, k2, ["--batch-size", "8",
                                           "--max-new-tokens", "64"])):
        before = k.emit_launches
        cli.main(["--random-init", "--device", "cuda", *extra, *flags])
        if k.emit_launches == before:
            raise AssertionError(f"{cli.__name__} with the sampling flags "
                                 "did not run the emit mode")
    return emit_launches


def time_sampling(model, card):
    """Phase 5's sampled part: K1's and K2's (B=8) bf16 step at pos 512 in
    emit mode beside the argmax mode (CUDA events, in turns) and the plain
    logits; the emit head's device time (``torch.profiler``) beside
    ``F.linear(h, head_w, head_b)``; the sampling stage's launches, device
    time and elapsed time a step at B=1 and 8 (``Sampler.draw`` at t 0.8,
    k 50, p 0.9). Returns kernel-line entries for the emit modes."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from pydynet_tpu_torch.models.llama.model import Sampler
    from pydynet_tpu_torch.ops import decode_step as dsk

    out = {}
    w = model._fused_weights(torch.bfloat16, None)
    for B in (1, 8):
        if B == 1:
            ck, cv = random_caches(model, torch.bfloat16, 1)
            args, kw = step_args(model, w, ck, cv, 512, 1234)
            k, ref = dsk.fused_decode_token, dsk.decode_token_logits_ref
        else:
            ck, cv = random_caches(model, torch.bfloat16, 1, B)
            args, kw = batched_args(model, w, ck, cv, 512, range(100, 108))
            k = dsk.fused_decode_token_batched
            ref = dsk.decode_token_batched_logits_ref
        emit = lambda: k(*args, emit_logits=True, **kw)
        greedy = lambda: k(*args, **kw)
        e1, g1, e2, g2 = (time_step(f, 200) for f in (emit, greedy, emit,
                                                      greedy))
        plain = time_step(lambda: ref(*args, **kw), 3 if B > 1 else 20)
        b_ms, b_by = decode_step_bound(w, ck, 512, B, emit=True)
        name = "K1" if B == 1 else "K2 B=8"
        out[name] = (min(e1, e2), plain, b_ms, b_by, None)
        print(f"[chip_smoke] {card}: {name} bf16 step at pos 512: "
              f"emit_logits {min(e1, e2) * 1e3:.1f} us, argmax mode "
              f"{min(g1, g2) * 1e3:.1f} us, plain logits {plain * 1e3:.1f} "
              f"us, bound {b_ms * 1e3:.1f} us ({b_by})")
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                emit()
            torch.cuda.synchronize()
        head = [e for e in kernel_events(prof) if "head" in e.name]
        head_us = sum(e.time_range.elapsed_us() for e in head) / 20
        n_k = len(kernel_events(prof)) // 20
        h = torch.randn(B, model.embed_dim, device="cuda",
                        dtype=torch.bfloat16)
        lin = time_step(lambda: F.linear(h, w["head_w"], w["head_b"]), 200)
        print(f"[chip_smoke] {card}: {name} emit head (final norm, "
              f"{model.embed_dim} -> {model.vocab_size}, f32 logits) "
              f"{head_us:.1f} us device time ({n_k} launches a step); "
              f"F.linear(h, head_w, head_b) {lin * 1e3:.1f} us")
        logits = emit().float()
        s = Sampler(B, model.vocab_size, "cuda", seed=1, **SAMPLE)
        draw = lambda: s.draw(logits)
        elapsed = time_step(draw, 50)
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                draw()
            torch.cuda.synchronize()
        ev = kernel_events(prof)
        dev_us = sum(e.time_range.elapsed_us() for e in ev) / 20
        print(f"[chip_smoke] {card}: sampling stage B={B} (t 0.8, k 50, "
              f"p 0.9): {len(ev) // 20} launches a step, {dev_us:.1f} us "
              f"device time, {elapsed * 1e3:.1f} us elapsed a step")
        del ck, cv
    return out


def check_k1(model, label="", formats=B1_FORMATS, positions=POSITIONS):
    """Phase 3 (and 3n on a grouped-query model, 4h in float16): K1 against
    its plain version in each of ``formats`` at ``positions``, then its
    emit_logits mode. Returns (cache errors, emit errors) by format."""
    max_err, emit_err = {}, {}
    for fmt in formats:
        dtype = FORMATS[fmt][0]
        max_err[fmt] = 0.0
        for pos in positions:
            got, want, confident, err = kernel_vs_plain(model, fmt, pos)
            print(f"[chip_smoke] {label}{fmt} pos {pos}: kernel {got} plain "
                  f"{want} confident {confident} cache err {err:.3g}")
            if err > cache_atol(fmt):
                raise AssertionError(f"{label}{fmt} pos {pos}: cache error "
                                     f"{err} > {cache_atol(fmt)}")
            if got != want and (dtype == torch.float32 or confident):
                raise AssertionError(f"{label}{fmt} pos {pos}: kernel token "
                                     f"{got} != plain {want}")
            max_err[fmt] = max(max_err[fmt], err)
    for fmt in formats:  # the emit_logits mode
        for pos in positions:
            err, scale, same, cerr = emit_vs_plain(model, fmt, pos)
            print(f"[chip_smoke] {label}{fmt} pos {pos} emit_logits: max "
                  f"|logit diff| {err:.3g} of scale {scale:.3g}, argmax "
                  f"= argmax-mode token {same}, cache err {cerr:.3g}")
            if not (emit_ok(fmt, err, scale) and same
                    and cerr <= cache_atol(fmt)):
                raise AssertionError(f"{label}{fmt} pos {pos}: emit_logits "
                                     "differs from plain or argmax mode")
            emit_err[fmt] = max(emit_err.get(fmt, 0.0), err)
    return max_err, emit_err


def check_k2(model, batches, positions, label="", rows_batch=8,
             emit_positions=EMIT_POSITIONS_B, formats=BATCHED_FORMATS):
    """Phase 3b (3n, 3w, 4h): K2 against its plain version in each of
    ``formats`` at ``batches`` x ``positions`` with per-row starts, each row
    of a ``rows_batch``-row step against K1 on that row alone (the int8 KV
    cache's against K2 at B=1), then K2's emit_logits mode at ``batches``
    x ``emit_positions``. Returns (cache errors, emit errors) by format."""
    max_err_b, emit_err_b = {}, {}
    for fmt in formats:
        dtype = fmt_of(fmt)[0]
        errs = []
        for batch in batches:
            for pos in positions:
                got, want, conf, err = batched_vs_plain(model, fmt, batch,
                                                        pos)
                same = got == want
                print(f"[chip_smoke] {label}K2 {fmt} B={batch} pos {pos}: "
                      f"{int(same.sum())}/{batch} tokens equal, "
                      f"{int(conf.sum())} confident, cache err {err}")
                if not cache_ok(fmt, err):
                    raise AssertionError(
                        f"{label}K2 {fmt} B={batch} pos {pos}: cache error "
                        f"{err} beyond its tolerance")
                must = torch.ones_like(conf) if dtype == torch.float32 \
                    else conf
                if not same[must].all():
                    raise AssertionError(
                        f"{label}K2 {fmt} B={batch} pos {pos}: tokens "
                        f"{got.tolist()} != plain {want.tolist()}")
                errs.append(err)
        max_err_b[fmt] = worst(*errs)
        equal, err = batched_rows_vs_one(model, fmt, rows_batch)
        alone = "K2 at B=1" if fmt in KV8_FORMATS else "K1"
        print(f"[chip_smoke] {label}K2 {fmt} B={rows_batch} rows vs {alone}: "
              f"tokens equal {equal}, cache err {err}")
        if not equal or not cache_ok(fmt, err):
            raise AssertionError(f"{label}K2 {fmt}: rows differ from "
                                 f"{alone}")
    for fmt in formats:  # the emit_logits mode
        for batch in batches:
            for pos in emit_positions:
                err, scale, same, cerr = batched_emit_vs_plain(
                    model, fmt, batch, pos)
                print(f"[chip_smoke] {label}K2 {fmt} B={batch} pos {pos} "
                      f"emit_logits: max |logit diff| {err:.3g} of "
                      f"scale {scale:.3g}, argmax = argmax-mode tokens "
                      f"{same}, cache err {cerr}")
                if not (emit_ok(fmt, err, scale) and same
                        and cache_ok(fmt, cerr)):
                    raise AssertionError(
                        f"{label}K2 {fmt} B={batch} pos {pos}: emit_logits "
                        "differs from plain or argmax mode")
                emit_err_b[fmt] = max(emit_err_b.get(fmt, 0.0), err)
    return max_err_b, emit_err_b


def zero_decode_counters():
    """Every K1/K2 launch counter to 0."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    for k in (dsk.fused_decode_token, dsk.fused_decode_token_batched):
        k.launches = k.emit_launches = k.narrow_launches = 0


def kv_bytes(model, width):
    """Bytes of one row's full bf16 K and V caches at ``width``."""
    return 2 * 2 * model.n_layers * model.max_seq_len * width


def check_gqa(gqa):
    """Phase 4g: the grouped-query path (bench.py's GQA_15M) through K1's
    narrow mode. Returns K1's narrow launches on its main path, the
    1024-token bf16 request."""
    from pydynet_tpu_torch.models.llama.model import Llama
    from pydynet_tpu_torch.ops import decode_step as dsk
    from pydynet_tpu_torch.utils import fidelity

    k1 = dsk.fused_decode_token
    steps = REQUEST - PROMPT.shape[1] - 1
    widths = []  # the cache width of every K1 call, through a method spy

    def spy(weights, ck, cv, *args, **kw):
        widths.append(ck.shape[-1])
        return Llama.fused_step(gqa, weights, ck, cv, *args, **kw)

    gqa.fused_step = spy
    for kw in ({}, dict(quant="int8"), dict(seed=SAMPLE_SEED, **SAMPLE)):
        list(gqa.generate(PROMPT, PROMPT.shape[1] + 3, dtype=torch.bfloat16,
                          **kw))  # warm-up
    torch.cuda.synchronize()
    del widths[:]
    zero_decode_counters()
    toks = [int(t[0, 0]) for t in gqa.generate(PROMPT, REQUEST,
                                               dtype=torch.bfloat16)]
    narrow = k1.narrow_launches
    dkv = gqa.n_kv_heads * gqa.head_dim
    print(f"[chip_smoke] GQA generate bf16: {len(toks)} tokens, {k1.launches}"
          f" K1 launches, {narrow} narrow, cache widths {sorted(set(widths))}"
          f", K/V cache {kv_bytes(gqa, dkv) / 1e6:.2f} MB (MHA "
          f"{kv_bytes(gqa, gqa.embed_dim) / 1e6:.2f} MB)")
    if not (narrow == k1.launches == steps == len(toks) - 1
            and widths == [dkv] * steps):
        raise AssertionError(f"GQA generate: {narrow} narrow launches of "
                             f"{k1.launches}, widths {set(widths)}; want "
                             f"{steps} at {dkv}")
    if not all(0 <= x < gqa.vocab_size for x in toks):
        raise AssertionError("GQA generate: token out of range")
    # bench.py's gqa-6q2kv-narrow: every confident step of the f32 stream
    truth, margins, tops = fidelity.greedy_truth(gqa, PROMPT, PATH_STEPS)
    checked, ok, agree = fidelity.gate_fused_argmax(
        gqa, PROMPT, truth, margins, tops, dtype=torch.bfloat16)
    print(f"[chip_smoke] gate gqa-6q2kv-narrow bf16: checked {checked} ok "
          f"{ok} agree {agree:.3f}")
    if not (checked > 0 and ok):
        raise AssertionError("fidelity gate gqa-6q2kv-narrow failed")
    # a sampled request through the narrow emit mode
    short = SAMPLED_SHORT - PROMPT.shape[1] - 1
    zero_decode_counters()
    toks = [int(t[0, 0]) for t in gqa.generate(
        PROMPT, SAMPLED_SHORT, dtype=torch.bfloat16, seed=SAMPLE_SEED,
        **SAMPLE)]
    print(f"[chip_smoke] GQA sampled generate: {len(toks)} tokens, "
          f"{k1.emit_launches} emit launches, {k1.narrow_launches} narrow")
    if not (k1.emit_launches == k1.narrow_launches == short == len(toks) - 1
            and k1.launches == 0):
        raise AssertionError("GQA sampled generate: not one narrow emit "
                             "launch a decode step")
    # int8 layers: the expanded (MHA) layout through K1's qlayers mode
    del widths[:]
    zero_decode_counters()
    toks = [int(t[0, 0]) for t in gqa.generate(
        PROMPT, REQUEST, dtype=torch.bfloat16, quant="int8")]
    print(f"[chip_smoke] GQA generate int8: {len(toks)} tokens, "
          f"{k1.launches} K1 launches, {k1.narrow_launches} narrow, cache "
          f"widths {sorted(set(widths))}")
    if not (k1.launches == steps and k1.narrow_launches == 0
            and widths == [gqa.embed_dim] * steps):
        raise AssertionError("GQA int8: not the expanded layout's K1")
    del gqa.fused_step
    return narrow


def check_wide_fleets(model, gqa, model64):
    """Phase 4w: a B=8 server on the grouped-query model (bf16 and the int8
    KV cache, K2's narrow mode) and its float32 twin against standalone
    float32 generate; a 64-slot stories15M server over 96 requests and a
    B=64 1024-token generate through K2's row groups. Returns (K2's narrow
    launches, K2's launches at B=64)."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    k2 = dsk.fused_decode_token_batched
    requests = serve_requests(gqa)
    for kw in ({}, dict(kv_quant="int8")):  # warm-up
        serve(gqa, requests[:2], dtype=torch.bfloat16, **kw, **SERVE)
    zero_decode_counters()
    for name, kw in (("bf16", {}), ("bf16-kv8", dict(kv_quant="int8"))):
        before = k2.narrow_launches
        srv, done = serve(gqa, requests, dtype=torch.bfloat16, **kw,
                          **SERVE)
        launched = k2.narrow_launches - before
        ck = srv._ck[0] if kw else srv._ck
        print(f"[chip_smoke] GQA serve {name} B=8: {len(done)} requests, "
              f"{sum(len(r.tokens) for r in done)} tokens, "
              f"{srv.dispatched_steps} steps dispatched, {launched} narrow "
              f"K2 launches, caches {tuple(ck.shape)}")
        if not all(r.done and r.tokens for r in done) or not any(
                r.truncated for r in done):
            raise AssertionError(f"GQA serve {name}: a request did not "
                                 "finish, or none reached the cache end")
        if launched != srv.dispatched_steps or ck.shape[-1] != 96:
            raise AssertionError(f"GQA serve {name}: {launched} narrow "
                                 f"launches for {srv.dispatched_steps} steps")
    narrow = k2.narrow_launches
    check_f32_server(gqa, "GQA ")
    wide = dict(SERVE, batch_size=max(WIDE_BATCHES))
    wide_requests = serve_requests(model64, n=WIDE_REQUESTS)
    serve(model64, wide_requests[:2], dtype=torch.bfloat16, **wide)
    zero_decode_counters()
    srv, done = serve(model64, wide_requests, dtype=torch.bfloat16, **wide)
    print(f"[chip_smoke] serve bf16 B={wide['batch_size']}: {len(done)} "
          f"requests, {sum(len(r.tokens) for r in done)} tokens, "
          f"{srv.dispatched_steps} steps dispatched, {k2.launches} K2 "
          f"launches")
    if not all(r.done and r.tokens for r in done) \
            or k2.launches != srv.dispatched_steps:
        raise AssertionError("serve B=64: unfinished requests or launches "
                             "!= dispatched steps")
    if not all(0 <= t < model64.vocab_size for r in done for t in r.tokens):
        raise AssertionError("serve B=64: token out of range")
    steps = REQUEST - PROMPT.shape[1] - 1
    before = k2.launches
    rows = list(model64.generate(batch_prompt(64), REQUEST,
                                 dtype=torch.bfloat16))
    launched = k2.launches - before
    print(f"[chip_smoke] generate bf16 B=64: {len(rows)} rows, {launched} "
          f"K2 launches")
    if launched != steps or any(r.shape != (64, 1) for r in rows):
        raise AssertionError(f"generate B=64: {launched} launches")
    return narrow, k2.launches


def time_gqa_and_wide(model, gqa, model64, card):
    """Phase 5's grouped-query and wide-batch rows: K1 narrow against K1
    MHA (bf16 step at pos 512), K2 narrow B=8 against MHA B=8, K2 B=64
    (bf16), each in turns beside its plain version and bound; then tokens
    per second of the GQA 1024-token request, the GQA B=8 server and the
    64-slot server."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    ms = {}

    def k1_case(m):
        w = m._fused_weights(torch.bfloat16)
        ck, cv = random_caches(m, torch.bfloat16, 1,
                               width=cache_width(m, w))
        args, kw = step_args(m, w, ck, cv, 512, 1234)
        return (lambda: dsk.fused_decode_token(*args, **kw),
                lambda: dsk.fused_decode_token_ref(*args, **kw),
                decode_step_bound(w, ck, 512, 1))

    def k2_case(m, fmt, batch):
        w = m._fused_weights(*fmt_of(fmt))
        ck, cv = batched_caches(m, fmt, 1, batch)
        args, kw = batched_args(m, w, ck, cv, 512, range(100, 100 + batch))
        return (lambda: dsk.fused_decode_token_batched(*args, **kw),
                lambda: dsk.fused_decode_token_batched_ref(*args, **kw),
                decode_step_bound(w, ck, 512, batch))

    groups = {"K1": (("K1 MHA", k1_case(model)), ("K1 narrow", k1_case(gqa))),
              "K2 B=8": (("K2 MHA B=8", k2_case(model, "bf16", 8)),
                         ("K2 narrow B=8", k2_case(gqa, "bf16", 8))),
              "K2 wide": (("K2 B=64", k2_case(model, "bf16",
                                              max(WIDE_BATCHES))),)}
    for cases in groups.values():
        kern = {name: [] for name, _ in cases}
        plain = {name: [] for name, _ in cases}
        for _ in range(2):  # in turns
            for name, (k, ref, _) in cases:
                kern[name].append(time_step(k, 200))
                plain[name].append(time_step(ref, 1 if "B=" in name else 10))
        for name, (_, _, bnd) in cases:
            ms[name] = (min(kern[name]), min(plain[name])) + bnd
            print(f"[chip_smoke] {card}: {name} step at pos 512: kernel "
                  f"{ms[name][0] * 1e3:.1f} us, plain "
                  f"{ms[name][1] * 1e3:.1f} us, bound "
                  f"{ms[name][2] * 1e3:.1f} us ({ms[name][3]})")
    wide = dict(SERVE, batch_size=max(WIDE_BATCHES))
    wide_requests = serve_requests(model64, n=WIDE_REQUESTS)
    runs = {"GQA generate": lambda: sum(1 for _ in gqa.generate(
                PROMPT, REQUEST, dtype=torch.bfloat16)),
            "GQA serve B=8": lambda: sum(len(r.tokens) for r in serve(
                gqa, serve_requests(gqa), dtype=torch.bfloat16,
                **SERVE)[1]),
            "serve B=64": lambda: sum(len(r.tokens) for r in serve(
                model64, wide_requests, dtype=torch.bfloat16, **wide)[1])}
    rates = {name: [] for name in runs}
    for _ in range(REPEATS):  # in turns
        for name, run in runs.items():
            start = time.perf_counter()
            n = run()
            torch.cuda.synchronize()
            rates[name].append(n / (time.perf_counter() - start))
    for name, r in rates.items():
        print(f"[chip_smoke] {card}: {name} tok/s of {REPEATS} runs: "
              f"{', '.join(f'{x:.1f}' for x in r)}; median "
              f"{float(np.median(r)):.1f}")
    return ms


def mesh_requests(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, CFG["vocab_size"], rng.randint(4, 13)).tolist()
            for _ in range(MESH_REQUESTS)]


def mesh_serve(server, prompts, n_new=MESH_NEW):
    rids = [server.submit(p, max_new_tokens=n_new) for p in prompts]
    start = time.perf_counter()
    done = server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    streams = [done[r].tokens for r in rids]
    return streams, sum(len(t) for t in streams) / wall


def check_partings(model, prompts, refs, streams, label, **kw):
    """Each stream equal to its reference up to a parting at a near-tie
    (``parts_at_a_tie``, teacher-forced on the scan lane with ``kw``)."""
    equal = 0
    for p, ref, got in zip(prompts, refs, streams):
        d, ok = parts_at_a_tie(model, p, ref, got, **kw)
        equal += d == len(ref) == len(got)
        if not ok or len(got) != len(ref):
            raise AssertionError(f"{label}: stream for {p} parts from the "
                                 f"reference at step {d} with no near-tie")
    return equal


def check_parallel(model, card):
    """Phase 4m (module docstring)."""
    import contextlib
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from pydynet_tpu_torch import jit, nn as tnn, optim as toptim
    from pydynet_tpu_torch.models.llama import Llama
    from pydynet_tpu_torch.models.llama.serve import LlamaServer
    from pydynet_tpu_torch.parallel import llama_spmd, make_mesh
    from pydynet_tpu_torch.parallel.serve_spmd import SpmdLlamaServer
    from pydynet_tpu_torch.utils import (debug_nans, fidelity, load_sharded,
                                         save_sharded, trace)

    ran = {}

    @contextlib.contextmanager
    def mesh_path():
        """Adds the port-kernel launches made inside to ``ran``: the mesh
        path reaches none (the references it is held against may)."""
        before = kernel_launches()
        yield
        for k, v in kernel_launches().items():
            if v != before[k]:
                ran[k] = ran.get(k, 0) + v - before[k]

    t0 = time.perf_counter()
    d = None
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh({"dp": 1, "tp": 1})
        print(f"[chip_smoke] mesh {mesh} over NCCL "
              f"({time.perf_counter() - t0:.1f} s to start)")

        # serving at stories15M width against the scan-lane server
        prompts = mesh_requests()
        with torch.no_grad():
            with mesh_path():
                srv = SpmdLlamaServer(model, mesh, batch_size=8, chunk=32,
                                      eos_id=-1)
                streams, tok_s = mesh_serve(srv, prompts)
            refs, ref_tok_s = mesh_serve(
                LlamaServer(model, batch_size=8, chunk=32, eos_id=-1,
                            lane="xla", dtype=torch.float32), prompts)
        equal = check_partings(model, prompts, refs, streams, "mesh server")
        print(f"[chip_smoke] {card}: SpmdLlamaServer f32 B=8, "
              f"{MESH_REQUESTS} requests x {MESH_NEW} tokens: {equal} "
              f"streams equal to LlamaServer(lane='xla'), the rest part at "
              f"a near-tie; generated tok/s {tok_s:.1f} (the scan-lane "
              f"server {ref_tok_s:.1f})")

        # weight-only int8 against the float server on round-tripped
        # weights; the int8 KV cache against the scan lane's
        rt = fidelity.dequant_inplace(
            Llama(**CFG, device="cuda",
                  generator=torch.Generator().manual_seed(0)).eval(), "int8")
        p = prompts[:1]
        with torch.no_grad(), mesh_path():
            q8, _ = mesh_serve(SpmdLlamaServer(
                model, mesh, batch_size=8, chunk=32, eos_id=-1,
                quant="int8"), p)
            q8_ref, _ = mesh_serve(SpmdLlamaServer(
                rt, mesh, batch_size=8, chunk=32, eos_id=-1), p)
            kv8, _ = mesh_serve(SpmdLlamaServer(
                model, mesh, batch_size=8, chunk=32, eos_id=-1,
                kv_quant="int8"), p)
        with torch.no_grad():
            kv8_ref = [[int(t[0, 0]) for t in model.generate(
                np.asarray(p), len(p[0]) + MESH_NEW, fused=False,
                kv_quant="int8")]]
        check_partings(rt, p, q8_ref, q8, "mesh int8 weights")
        check_partings(model, p, kv8_ref, kv8, "mesh int8 KV",
                       kv_quant="int8")
        print(f"[chip_smoke] SpmdLlamaServer quant=int8 and kv_quant=int8: "
              f"{MESH_NEW}-token streams equal to their references up to a "
              f"near-tie")
        del rt

        # three train steps at stories15M width, with and without the mesh
        cfg = llama_spmd.config()
        rng = np.random.RandomState(0)
        host = llama_spmd.init_params(rng, cfg)
        tokens = rng.randint(0, cfg["vocab_size"], (MESH_B, MESH_L))
        targets = np.roll(tokens, -1, axis=1)
        losses = {}
        for name, params in (
                ("mesh", llama_spmd.shard_params(host, mesh)),
                ("plain", {k: v.cuda() for k, v in host.items()})):
            step = llama_spmd.make_train_step(mesh if name == "mesh" else
                                              None, cfg, lr=MESH_LR)
            losses[name] = []
            with mesh_path():
                for _ in range(MESH_STEPS):
                    params, loss = step(params, tokens, targets)
                    losses[name].append(float(loss))
        torch.cuda.synchronize()
        print(f"[chip_smoke] llama_spmd train steps (B={MESH_B}, "
              f"L={MESH_L}, lr {MESH_LR}): mesh {losses['mesh']}, no mesh "
              f"{losses['plain']}")
        m, pl = np.array(losses["mesh"]), np.array(losses["plain"])
        if not (np.all(np.diff(m) < 0)
                and np.abs(m - pl).max() <= TRAIN_LOSS_RTOL * pl.max()):
            raise AssertionError(f"mesh train steps: {losses}")

        # jit(mesh=): graph replays against the same step run eagerly
        def mlp(like=None):
            net = tnn.Sequential(tnn.Linear(64, 256), tnn.Tanh(),
                                 tnn.Linear(256, 8)).cuda()
            if like is not None:  # the same weights
                net.load_state_dict(like.state_dict())
            return net, toptim.Adam(net.parameters(), lr=1e-3)

        def make_step(net, opt):
            def step(x, y):
                opt.zero_grad()
                loss = tnn.functional.mse_loss(net(x), y)
                loss.backward()
                opt.step()
                return loss
            return step

        gen = torch.Generator().manual_seed(1)
        xs = torch.randn(MESH_JIT_STEPS, 32, 64, generator=gen).cuda()
        ys = torch.randn(MESH_JIT_STEPS, 32, 8, generator=gen).cuda()
        net_j, opt_j = mlp()
        net_e, opt_e = mlp(net_j)
        js = jit(make_step(net_j, opt_j), state=(net_j, opt_j), mesh=mesh)
        step_e = make_step(net_e, opt_e)
        with mesh_path():
            got = [js(x, y) for x, y in zip(xs, ys)]
        want = [step_e(x, y).detach() for x, y in zip(xs, ys)]
        bit = all(torch.equal(a, b) for a, b in zip(got, want)) and all(
            torch.equal(a.full_tensor(), b)
            for a, b in zip(net_j.parameters(), net_e.parameters()))
        print(f"[chip_smoke] jit(mesh=) dp step: {len(js.graphs)} graph, "
              f"{js.replays} replays, "
              f"{'bit-equal' if bit else 'NOT bit-equal'} to eager over "
              f"{MESH_JIT_STEPS} steps")
        if not (bit and len(js.graphs) == 1
                and js.replays == MESH_JIT_STEPS - 1
                and isinstance(net_j[0].weight, DTensor)):
            raise AssertionError("jit(mesh=): the graph route differs")

        # the sharded checkpoint round trip on the card
        d = tempfile.mkdtemp(dir=os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "build"))
        snap = [t.full_tensor().clone() for t in net_j.parameters()] + \
            [t.full_tensor().clone() for t in opt_j.m + opt_j.v]
        with mesh_path():
            save_sharded(os.path.join(d, "ckpt"), net_j, opt_j, step=7)
        with torch.no_grad():
            for t in list(net_j.parameters()) + opt_j.m + opt_j.v:
                t.add_(1.0)
        with mesh_path():
            step = load_sharded(os.path.join(d, "ckpt"), net_j, opt_j)
        back = [t.full_tensor() for t in net_j.parameters()] + \
            [t.full_tensor() for t in opt_j.m + opt_j.v]
        if step != 7 or not all(torch.equal(a, b)
                                for a, b in zip(snap, back)):
            raise AssertionError("save_sharded/load_sharded round trip")
        print(f"[chip_smoke] save_sharded -> load_sharded on the card: "
              f"{len(snap)} tensors bit for bit, step {step}")

        # debug_nans and the profiler
        try:
            with debug_nans():
                torch.log(torch.tensor([-1.0], device="cuda"))
            raise AssertionError("debug_nans did not trap a NaN")
        except FloatingPointError as e:
            print(f"[chip_smoke] debug_nans: {e}")
        # a window of many kernels: a CPU + CUDA profiler session can drop
        # its first few kernel records once nvcc has run in the process
        a = torch.randn(1024, 1024, device="cuda")
        with trace(os.path.join(d, "trace")) as prof:
            for _ in range(TRACE_PRODUCTS):
                a @ a
            torch.cuda.synchronize()
        kernels = kernel_events(prof)
        print(f"[chip_smoke] profiler.trace: {len(kernels)} CUDA kernel "
              f"records of {TRACE_PRODUCTS} products, e.g. "
              f"{sorted({e.name for e in kernels})[:1]}")
        if not kernels:
            raise AssertionError("profiler.trace listed no CUDA kernel")
        if ran:
            raise AssertionError(f"the mesh path launched port kernels: "
                                 f"{ran}")
        print("[chip_smoke] no port kernel launched on the mesh path "
              "(serving, int8 weights and KV, train steps, jit(mesh=), "
              "the sharded checkpoint)")
    finally:
        dist.destroy_process_group()
        if d is not None:
            shutil.rmtree(d, ignore_errors=True)
    print(f"[chip_smoke] {card}: phase 4m took "
          f"{time.perf_counter() - t0:.1f} s")


# --------------------------- phase 4h: float16 -----------------------------
def f16_vs_plain(model, gqa):
    """Phase 4h's checks: the float16 instances of K1, K2, K3 at the 7B
    prefill's shape, K9 and K10 against their plain versions at the main
    path's shapes (K3/K4's other shapes in phase 4c, K5-K7's in phase 3c).
    Returns {kernel: max error}."""
    f16 = torch.float16
    errs = {}
    k1, _ = check_k1(model, "f16 ", F16_FORMATS, F16_POSITIONS)
    k2, _ = check_k2(model, (F16_BATCH,), F16_BATCH_POSITIONS, "f16 ",
                     emit_positions=(17,), formats=F16_BATCHED)
    check_k1(gqa, "GQA f16 ", ("f16",), (1, 1030))
    check_k2(gqa, (F16_BATCH,), (1030,), "GQA f16 ", emit_positions=(17,),
             formats=("f16", "f16-kv8"))
    errs["decode_token"] = k1["f16"]
    errs["decode_token_batched"] = k2["f16"]
    B, L, H, d = LONG_FLASH_SHAPE
    e = flash_vs_plain(B, L, f16, d=d, heads=H, backward=False)
    print(f"[chip_smoke] flash f16 {LONG_FLASH_SHAPE}: max error "
          + ", ".join(f"{k} {v:.3g}" for k, v in e.items()))
    errs["flash_attention_fwd[prefill]"] = max(e["o"], e["lse"])
    # K9: float16 weights against a float32 h (the CUDA cores, the weights
    # widened) and against a float16 h (the tensor cores), a cross-tile tie
    errs["lm_head_argmax"] = 0.0
    for seed in range(3):
        h, w, b = head_inputs(model, f16, seed)
        for hh in (h, h.to(f16)):
            got, want, short = head_vs_plain(model, None, inputs=(hh, w, b))
            print(f"[chip_smoke] K9 f16 weights, {hh.dtype} h, seed {seed}: "
                  f"kernel {got} plain {want}, logit shortfall {short:.3g}")
            if got != want:
                raise AssertionError(f"K9 f16 {hh.dtype} h: kernel {got} != "
                                     f"plain {want}")
            errs["lm_head_argmax"] = max(errs["lm_head_argmax"], short)
    got, want, _ = head_vs_plain(model, f16, 7, tie=True)
    if got != want or got != HEAD_TIE[0]:
        raise AssertionError(f"K9 f16 tie: kernel {got}, plain {want}, want "
                             f"{HEAD_TIE[0]}")
    errs["fused_decode_step"] = 0.0
    for pos in F16_STEP_POSITIONS:
        h_err, c_err, kept, _ = step_vs_plain(model, f16, pos)
        print(f"[chip_smoke] K10 f16 pos {pos}: h_out err {h_err:.3g}, cache "
              f"err {c_err:.3g}, other rows kept {kept}")
        if h_err > STEP_ATOL[f16] or c_err > CACHE_ATOL[f16] or not kept:
            raise AssertionError(f"K10 f16 pos {pos}: h_out err {h_err}, "
                                 f"cache err {c_err}, kept {kept}")
        errs["fused_decode_step"] = max(errs["fused_decode_step"], h_err)
    return errs


def f16_main_path(model, truth, margins, tops):
    """Phase 4h's main path in float16, each run with the launch counters
    zeroed just before it and read just after: a stories15M request through
    K1, a long prompt's flash prefill (K3), a B=8 server through K2, a
    fine-tune through K3/K4, the scan lane with int8 weights (K5-K7 on
    float16 rows) and the K10 + K9 path. Returns {kernel: launches}."""
    from pydynet_tpu_torch.models.llama import Llama
    from pydynet_tpu_torch.ops import decode_step as dsk
    from pydynet_tpu_torch.optim import SGD
    from pydynet_tpu_torch.utils import fidelity

    f16, V, N = torch.float16, CFG["vocab_size"], CFG["n_layers"]
    launches = {}
    # the B=1 request (K1), gated against the float32 truth
    steps = F16_REQUEST - PROMPT.shape[1] - 1
    list(model.generate(PROMPT, PROMPT.shape[1] + 3, dtype=f16))  # warm-up
    torch.cuda.synchronize()
    zero_decode_counters()
    toks = [int(t[0, 0]) for t in model.generate(PROMPT, F16_REQUEST,
                                                 dtype=f16)]
    launches["decode_token"] = dsk.fused_decode_token.launches
    print(f"[chip_smoke] generate f16: {len(toks)} tokens, "
          f"{launches['decode_token']} K1 launches")
    if launches["decode_token"] != steps or len(toks) != steps + 1 \
            or not all(0 <= x < V for x in toks):
        raise AssertionError(f"f16 generate: {launches}, {len(toks)} tokens;"
                             f" want {steps} steps")
    checked, ok, agree = fidelity.gate_fused_argmax(
        model, PROMPT, truth, margins, tops, dtype=f16)
    print(f"[chip_smoke] gate f16: checked {checked} ok {ok} agree "
          f"{agree:.3f}")
    if not (checked > 0 and ok):
        raise AssertionError("fidelity gate failed for f16")
    # a prompt past FLASH_PREFILL_MIN: its prefill through K3 in float16
    long = np.random.default_rng(11).integers(1, V, (1, F16_LONG_PROMPT))
    list(model.generate(long, F16_LONG_PROMPT + 2, dtype=f16))  # warm-up
    torch.cuda.synchronize()
    for c in flash_counters():
        c.launches = 0
    toks = list(model.generate(long, F16_LONG_PROMPT + LONG_NEW, dtype=f16))
    launches["flash_attention_fwd[prefill]"] = flash_counters()[0].launches
    print(f"[chip_smoke] generate f16, a {F16_LONG_PROMPT}-token prompt: "
          f"{len(toks)} tokens, {launches['flash_attention_fwd[prefill]']} "
          f"K3 launches")
    if launches["flash_attention_fwd[prefill]"] != N:
        raise AssertionError(f"f16 flash prefill: {launches}, want {N}")
    t_l, m_l, tp_l = fidelity.greedy_truth(model, long, LONG_NEW)
    checked, ok, _ = fidelity.gate_fused_argmax(model, long, t_l, m_l, tp_l,
                                                dtype=f16, flash=True)
    print(f"[chip_smoke] gate f16 flash prefill: checked {checked} ok {ok}")
    if not (checked > 0 and ok):
        raise AssertionError("fidelity gate failed for the f16 flash prefill")
    # a B=8 server (K2), each stream against standalone float16 generate
    requests = [(p, min(n, F16_SERVE_NEW))
                for p, n in serve_requests(model, 5, F16_SERVE_REQUESTS)]
    zero_decode_counters()
    srv, done = serve(model, requests, dtype=f16, **SERVE)
    launches["decode_token_batched"] = dsk.fused_decode_token_batched.launches
    print(f"[chip_smoke] serve f16 B=8: {len(requests)} requests, "
          f"{sum(len(r.tokens) for r in done)} tokens, "
          f"{srv.dispatched_steps} steps, {launches['decode_token_batched']} "
          f"K2 launches")
    if launches["decode_token_batched"] != srv.dispatched_steps:
        raise AssertionError("f16 server: K2 launches != dispatched steps")
    for (p, n), req in zip(requests, done):
        alone = [int(t[0, 0]) for t in model.generate(np.array([p]),
                                                      len(p) + n, dtype=f16)]
        d, ok = parts_at_a_tie(model, p, alone, req.tokens, dtype=f16)
        if len(req.tokens) != n or not ok:
            raise AssertionError(f"f16 server stream parts from generate at "
                                 f"{d}, not at a near-tie")
    # a float16 fine-tune (K3/K4): SGD, as Adam's eps is 0 in float16
    tm = Llama(**TRAIN_CFG, device="cuda", dtype=f16,
               generator=torch.Generator().manual_seed(0))
    tm.set_trainable_parameters(TRAIN_PREFIXES)
    opt = SGD([p for p in tm.parameters() if p.requires_grad],
              lr=F16_TRAIN_LR)
    inp, tgt = train_pair()
    for c in flash_counters():
        c.launches = 0
    losses = tm.finetune_steps(inp, tgt, opt, F16_TRAIN_STEPS).tolist()
    for name, c in zip(FLASH_KERNELS, flash_counters()):
        launches[name] = c.launches
    print(f"[chip_smoke] fine-tune f16 stories15M B=1 L={TRAIN_L}, SGD lr "
          f"{F16_TRAIN_LR}: losses {', '.join(f'{x:.4f}' for x in losses)};"
          f" launches {[launches[k] for k in FLASH_KERNELS]}")
    if any(launches[k] != N * F16_TRAIN_STEPS for k in FLASH_KERNELS) or \
            not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError("the f16 fine-tune did not train through the "
                             "kernels")
    del tm, opt
    # the scan lane with int8 weights: K7 (its prefill branch K6) for the
    # layers, K5 for the head, on float16 rows
    prompt = np.random.default_rng(1).integers(1, V, (1, LONG_PROMPT))
    list(model.generate(prompt, LONG_PROMPT + 2, dtype=f16, quant="int8",
                        fused=False))  # warm-up
    torch.cuda.synchronize()
    zero_qmm_counters()
    toks = list(model.generate(prompt, LONG_PROMPT + LONG_NEW, dtype=f16,
                               quant="int8", fused=False))
    ran = qmm_counters()
    launches.update(ran)
    print(f"[chip_smoke] scan lane f16 int8, a {LONG_PROMPT}-token prompt: "
          f"{len(toks)} tokens, launches {ran}")
    if min(ran.values()) < 1:
        raise AssertionError(f"f16 scan lane int8: launches {ran}")
    t_s, m_s, tp_s = fidelity.greedy_truth(model, prompt, LONG_NEW)
    checked, ok, agree = fidelity.gate_scan_argmax(
        model, prompt, t_s, m_s, tp_s, dtype=f16, quant="int8",
        min_agree=INT4_MIN_AGREE)
    print(f"[chip_smoke] gate f16 scan lane int8 (majority): checked "
          f"{checked} ok {ok} agree {agree:.3f}")
    if not ok:
        raise AssertionError("fidelity gate failed for the f16 scan lane")
    launches.update(head_and_step_path(model, truth, margins, tops, f16))
    return launches


def in_turns(fn, a, b):
    """fn(a), fn(b), fn(b), fn(a): for a and for b the results of its
    first call, their first element (the time) the smaller of its two
    calls'. ``fn`` returns a tuple, or a dict of tuples."""
    def keep(r1, r2):
        if isinstance(r1, dict):
            return {k: keep(r1[k], r2[k]) for k in r1}
        return (min(r1[0], r2[0]),) + tuple(r1[1:])

    ra1, rb1, rb2, ra2 = fn(a), fn(b), fn(b), fn(a)
    return keep(ra1, ra2), keep(rb1, rb2)


def time_float16(model, card):
    """Phase 4h's timings: each kernel's float16 instance beside its
    bfloat16 one in turns, with the float16 plain version, bound and
    library call. Returns {kernel: (ms, plain_ms, bound_ms, bound_by,
    library_ms)} for float16, and prints bfloat16's beside it."""
    from pydynet_tpu_torch.ops import decode_step as dsk
    from pydynet_tpu_torch.ops import gemv_quant as gq

    bf16, f16 = torch.bfloat16, torch.float16
    out = {}

    def report(name, tb, tf):
        print(f"[chip_smoke] {card}: {name} in turns: f16 "
              f"{tf[0] * 1e3:.1f} us, bf16 {tb[0] * 1e3:.1f} us")
        out[name] = tf

    tb, tf = in_turns(lambda f: time_k1(model, f, card), "bf16", "f16")
    report("decode_token", tb, tf + (None,))
    tb, tf = in_turns(lambda f: time_k2(model, f, F16_BATCH, card), "bf16",
                      "f16")
    report("decode_token_batched", tb, tf + (None,))
    for B, L, H, d, backward in F16_FLASH:
        with torch.enable_grad():  # the SDPA backward it times beside K4
            tb, tf = in_turns(lambda t: time_flash(B, L, card, t, d, H,
                                                   backward), bf16, f16)
        for name in tf:
            report(name + ("" if backward else "[prefill]"), tb[name],
                   tf[name])

    def head(dtype):
        h, w, b = head_inputs(model, dtype)
        hv = h[0].to(dtype)
        kern = time_graph(lambda i: dsk.lm_head_argmax(h, w, b), 1, 50)
        lib = time_graph(lambda i: torch.argmax(w @ hv + b), 1, 50)
        plain = time_step(lambda: dsk.lm_head_argmax_ref(h, w, b), 20)
        V, D = w.shape
        return (kern, plain) + bound(nbytes(h, w, b) + 4, 2 * V * D, dtype) \
            + (lib,)

    tb, tf = in_turns(head, bf16, f16)
    report("lm_head_argmax", tb, tf)

    def step(dtype):
        args = step_inputs(model, dtype, 512)
        kern = time_graph(lambda i: dsk.fused_decode_step(*args), 1, 20)
        plain = time_step(lambda: dsk.fused_decode_step_ref(*args), 5)
        N, S, D = args[-1].shape
        H, rows, mats = model.n_heads, 513, args[7:14]
        n_bytes = (nbytes(*args[1:16]) + 4 * D
                   + 2 * N * D * args[-1].element_size() * (rows + 1))
        n_ops = N * (2 * sum(m.numel() for m in mats) + 4 * D * D
                     + 2 * rows * D * H + rows * D * (2 * H + 2))
        return (kern, plain) + bound(n_bytes, n_ops, dtype) + (None,)

    tb, tf = in_turns(step, bf16, f16)
    report("fused_decode_step", tb, tf)
    # K5-K7 on float16 and bfloat16 rows at the 7B gate/up shape, int8
    K, N = QMM_SHAPES["7B"][2]
    w, ws = random_qweights(K, N, False, 3, layers=3)
    ids = [torch.tensor(i, dtype=torch.int32, device="cuda")
           for i in range(3)]
    for name, M in (("qmatmul", 1), ("qmatmul_stacked", 1),
                    ("qmatmul_prefill", 256), ("quantize_rows", 1)):
        def qmm(dtype):
            x = random_rows(M, K, dtype, M)
            if name == "quantize_rows":
                kern = time_graph(lambda i: gq.quantize_rows(x), 100)
                plain = time_step(lambda: gq.quantize_rows_ref(x), 50)
                return (kern, plain) + bound(nbytes(x) + M * (K + 4),
                                             3 * M * K, dtype) + (None,)
            if name == "qmatmul_stacked":
                call = lambda i: gq.qmatmul_stacked(x, w, ws, ids[i])
            else:
                call = lambda i: gq.qmatmul(x, w[i], ws[i])
            kern = time_graph(call, 3, 10)
            plain = time_step(lambda: gq.qmatmul_ref(x, w[0], ws[0]), 2)
            lib = None
            if M > 16:  # torch._int_mm on a column-major copy of the weights
                xq = gq.quantize_rows(x)[0]
                wt = w.transpose(-1, -2).contiguous()
                lib = time_graph(lambda i: torch._int_mm(xq, wt[i].t()), 3,
                                 10)
                del wt
            return (kern, plain) + qmm_bound(x, w[0], M, N) + (lib,)

        tb, tf = in_turns(qmm, bf16, f16)
        report(name, tb, tf)
    del w, ws
    return out


def check_float16(model, gqa, truth, margins, tops, card):
    """Phase 4h: float16 through every kernel of its path (K1, K2, K3/K4,
    K5-K7, K9, K10): against the plain versions (K3/K4's other shapes in
    phase 4c, K5-K7 in phase 3c), the main path in float16, the timings
    beside bfloat16's. Returns (errs, launches, ms) by kernel."""
    with torch.no_grad():
        errs = f16_vs_plain(model, gqa)
    launches = f16_main_path(model, truth, margins, tops)
    with torch.no_grad():
        ms = time_float16(model, card)
    return errs, launches, ms


# the kernels line's float16 entries: (kernel, its source, the TPU kernel)
F16_ENTRIES = (
    ("decode_token", "decode_token_batched_f16.cu",
     "pydynet_tpu/ops/decode_step.py", 160),
    ("decode_token_batched", "decode_token_batched_f16.cu",
     "pydynet_tpu/ops/decode_step.py", 509),
    ("flash_attention_fwd", "flash_attention_f16.cu",
     "pydynet_tpu/ops/flash_attention.py", 82),
    ("flash_attention_bwd_dq", "flash_attention_f16.cu",
     "pydynet_tpu/ops/flash_attention.py", 192),
    ("flash_attention_bwd_dkv", "flash_attention_f16.cu",
     "pydynet_tpu/ops/flash_attention.py", 259),
    ("flash_attention_fwd[prefill]", "flash_attention_f16.cu",
     "pydynet_tpu/ops/flash_attention.py", 82),
    ("quantize_rows", "gemv_quant_f16.cu", "pydynet_tpu/ops/gemv_quant.py",
     309),
    ("qmatmul", "gemv_quant_f16.cu", "pydynet_tpu/ops/gemv_quant.py", 172),
    ("qmatmul_prefill", "gemv_quant.cu", "pydynet_tpu/ops/gemv_quant.py",
     136),
    ("qmatmul_stacked", "gemv_quant_f16.cu", "pydynet_tpu/ops/gemv_quant.py",
     416),
    ("lm_head_argmax", "head.cuh", "pydynet_tpu/ops/decode_step.py", 102),
    ("fused_decode_step", "decode_step_f16.cu",
     "pydynet_tpu/ops/decode_step.py", 1575))


def main() -> int:
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA GPU: nothing to check", file=sys.stderr)
        return 1
    from pydynet_tpu_torch.models.llama import Llama
    from pydynet_tpu_torch.models.llama import infer
    from pydynet_tpu_torch.ops import _build
    from pydynet_tpu_torch.ops import decode_step as dsk
    from pydynet_tpu_torch.utils import fidelity

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    t0 = t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda}"
          f" device {kind} count {torch.cuda.device_count()}")
    print(card)
    phase("1 device", t0)

    # 2. build
    t0 = time.perf_counter()
    cached = _build.library_path().exists()
    lib = _build.build()
    _build.load()
    print(f"[chip_smoke] {'found' if cached else 'built'} {lib.name} in "
          f"{time.perf_counter() - t0:.1f} s")
    phase("2 build", t0)

    # 3. K1 against plain at stories15M width
    t0 = time.perf_counter()
    model = Llama(**CFG, device="cuda",
                  generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        max_err, emit_err = check_k1(model)
    phase("3 kernel vs plain", t0)

    # 3b. K2 against plain, and K2 rows against K1 (the int8 KV cache's
    # against K2 on each row alone)
    t0 = time.perf_counter()
    with torch.no_grad():
        max_err_b, emit_err_b = check_k2(model, BATCHES, BATCH_POSITIONS)
    phase("3b batched kernel vs plain", t0)

    # 3n. the narrow mode: K1 and K2 on a grouped-query model (bench.py's
    # GQA_15M) against their plain versions, its int8/int4 layers on the
    # expanded layout
    t0 = time.perf_counter()
    gqa = Llama(**GQA_CFG, device="cuda",
                generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        narrow_err, _ = check_k1(gqa, "GQA ")
        narrow_err_b, _ = check_k2(gqa, BATCHES, BATCH_POSITIONS, "GQA ")
    phase("3n narrow kernels vs plain", t0)

    # 3w. K2 above 32 rows: row groups, every mode, and each row of a B=64
    # step against K1 on that row alone
    t0 = time.perf_counter()
    with torch.no_grad():
        # the plain version takes 0.5-1.6 s a B=64 step: the argmax mode at
        # the clamped position, the emit mode at a short one
        wide_err_b, _ = check_k2(model, WIDE_BATCHES, (1030,),
                                 rows_batch=max(WIDE_BATCHES),
                                 emit_positions=(17,))
    phase("3w batched kernel above 32 rows vs plain", t0)

    # 3c. the quantized matmuls (K5, K6, K7) against plain
    t0 = time.perf_counter()
    qmm_err, qmm_f16_err = check_qmatmul()
    phase("3c quantized matmuls vs plain", t0)

    # 3d. the train-mode BatchNorm (K8) against plain
    t0 = time.perf_counter()
    bn_err = check_batchnorm()
    phase("3d batch norm vs plain", t0)

    # 3e. K9 and K10 against plain, and the path they make together
    t0 = time.perf_counter()
    truth, margins, tops = fidelity.greedy_truth(model, PROMPT, PATH_STEPS)
    with torch.no_grad():
        step_err, step_launches = check_head_and_step(model, truth, margins,
                                                      tops)
    phase("3e head and layers-only step vs plain", t0)

    # 4. the B=1 path
    t0 = time.perf_counter()
    steps = REQUEST - PROMPT.shape[1] - 1
    for quant in B1_QUANTS:  # warm-up: weights, cuBLAS, kernels
        list(model.generate(PROMPT, PROMPT.shape[1] + 3,
                            dtype=torch.bfloat16, quant=quant))
    torch.cuda.synchronize()
    dsk.fused_decode_token.launches = 0
    for quant in B1_QUANTS:
        before = dsk.fused_decode_token.launches
        toks = [int(t[0, 0]) for t in model.generate(
            PROMPT, REQUEST, dtype=torch.bfloat16, quant=quant)]
        launched = dsk.fused_decode_token.launches - before
        name = f"bf16{'-' + quant if quant else ''}"
        print(f"[chip_smoke] generate {name}: {len(toks)} tokens, "
              f"{launched} kernel launches")
        if launched != steps or len(toks) != steps + 1:
            raise AssertionError(f"{name}: {launched} launches, "
                                 f"{len(toks)} tokens; want {steps} steps")
        if not all(0 <= x < CFG["vocab_size"] for x in toks):
            raise AssertionError(f"{name}: token out of range")
    main_launches = dsk.fused_decode_token.launches
    for quant in (None, "int8-head"):
        checked, ok, agree = fidelity.gate_fused_argmax(
            model, PROMPT, truth, margins, tops, dtype=torch.bfloat16,
            quant=quant)
        print(f"[chip_smoke] gate bf16 quant={quant}: checked {checked} "
              f"ok {ok} agree {agree:.3f}")
        if not (checked > 0 and ok):
            raise AssertionError(f"fidelity gate failed for quant={quant}")
    # int8 and int4 layers: the truth of a copy whose weights went through
    # the format and back (bench.py's dequant_truth), so the gate sees the
    # kernel's arithmetic and the activations' quantization, not the weight
    # error; int8 at every confident step, int4 by majority agreement
    for quant, kw in (("int8", {}), ("int4", {"min_agree": INT4_MIN_AGREE})):
        rt = fidelity.dequant_inplace(
            Llama(**CFG, device="cuda",
                  generator=torch.Generator().manual_seed(0)).eval(), quant)
        t_rt, m_rt, top_rt = fidelity.greedy_truth(rt, PROMPT, PATH_STEPS)
        checked, ok, agree = fidelity.gate_fused_argmax(
            rt, PROMPT, t_rt, m_rt, top_rt, dtype=torch.bfloat16,
            quant=quant, **kw)
        print(f"[chip_smoke] gate bf16 quant={quant} (against the {quant} "
              f"round-trip truth{', majority' if kw else ''}): checked "
              f"{checked} ok {ok} agree {agree:.3f}")
        if not (checked > 0 and ok):
            raise AssertionError(f"fidelity gate failed for quant={quant}")
        del rt
    # the int8 KV cache at B=1: the batched kernel, one launch a step
    list(model.generate(PROMPT, PROMPT.shape[1] + 3, dtype=torch.bfloat16,
                        kv_quant="int8"))  # warm-up
    torch.cuda.synchronize()
    dsk.fused_decode_token_batched.launches = 0
    toks = [int(t[0, 0]) for t in model.generate(
        PROMPT, REQUEST, dtype=torch.bfloat16, kv_quant="int8")]
    kv8_launches = dsk.fused_decode_token_batched.launches
    print(f"[chip_smoke] generate bf16-kv8: {len(toks)} tokens, "
          f"{kv8_launches} K2 launches")
    if kv8_launches != steps or len(toks) != steps + 1 \
            or not all(0 <= x < CFG["vocab_size"] for x in toks):
        raise AssertionError(f"bf16-kv8: {kv8_launches} launches, "
                             f"{len(toks)} tokens; want {steps} steps")
    # bench.py's b1-kvint8: majority agreement with the f32 stream
    checked, ok, agree = fidelity.gate_fused_argmax(
        model, PROMPT, truth, margins, tops, dtype=torch.bfloat16,
        kv_quant="int8", min_agree=INT4_MIN_AGREE)
    print(f"[chip_smoke] gate b1-kvint8 bf16 (majority): checked {checked} "
          f"ok {ok} agree {agree:.3f}")
    if not (checked > 0 and ok):
        raise AssertionError("fidelity gate b1-kvint8 failed")
    for extra in ([], ["--quant", "int8"], ["--kv-quant", "int8"]):
        k = (dsk.fused_decode_token_batched if "--kv-quant" in extra
             else dsk.fused_decode_token)
        before = k.launches
        infer.main(["--random-init", "--device", "cuda", "--max-new-tokens",
                    "64", *extra])
        if k.launches == before:
            raise AssertionError(f"infer CLI {extra} did not run the kernel")
    phase("4 main path", t0)

    # 4s. the sampled path: K1's and K2's emit_logits modes
    t0 = time.perf_counter()
    with torch.no_grad():
        emit_launches = check_sampled(model, truth)
    phase("4s sampled path", t0)

    # 4b. the serving path
    t0 = time.perf_counter()
    serve_launches = check_serving(model)
    emit_launches_b = check_sampled_serving(model)
    phase("4b serving path", t0)

    # 4g. the grouped-query path: K1's narrow mode
    t0 = time.perf_counter()
    with torch.no_grad():
        narrow_launches = check_gqa(gqa)
    phase("4g grouped-query path", t0)

    # 4w. the grouped-query fleet (K2's narrow mode) and fleets above 32
    # rows (K2's row groups)
    t0 = time.perf_counter()
    model64 = Llama(**dict(CFG, max_batch_size=max(WIDE_BATCHES)),
                    device="cuda",
                    generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        narrow_launches_b, wide_launches = check_wide_fleets(model, gqa,
                                                             model64)
    phase("4w grouped-query and wide fleets", t0)

    # 4c. the training path
    t0 = time.perf_counter()
    train_launches, flash_err, flash_f16_err = check_training()
    phase("4c training path", t0)

    # 4d. the big-dims path: Llama-2-7B geometry on the scan lane
    t0 = time.perf_counter()
    big, qmm_launches = check_big_dims()
    phase("4d big-dims path", t0)

    # 4l. long-prompt prefill: the dense and the flash (K3) routes
    t0 = time.perf_counter()
    prefill_launches, prefill_err, prefill_ms = check_long_prompt(
        model, big, card)
    phase("4l long-prompt prefill", t0)

    # 4p. the 7B geometry served with int8 KV and int8/int4 weights, a
    # shared system prompt reused by the prefix cache; beam search and
    # speculative decoding on the stories15M scan lane
    t0 = time.perf_counter()
    prefix_launches = check_prefix_cache(big, card)
    check_beam_and_speculative(model, card)
    phase("4p int8 KV, prefix cache, beam and speculative", t0)

    # 4r. the threefry Generator and dropout, a LoRA fine-tune served on the
    # fused lane and speculatively, and the 7B speculative server
    t0 = time.perf_counter()
    lora_launches, lora_err, lora_ms = check_lora_and_speculative(model, big,
                                                                  card)
    phase("4r LoRA fine-tune and speculative serving", t0)

    # 4e. the nn-stack trainers: dropout_bn through K8, the MNIST ConvNet
    t0 = time.perf_counter()
    bn_launches = check_nn_training()
    phase("4e nn training path", t0)

    # 4j. the jit's graphs against eager, the RNN and transformer trainers
    t0 = time.perf_counter()
    check_jit(card)
    phase("4j jit, RNN and transformer trainers", t0)

    # 4v. CLIP ViT-B/32: zero-shot and fine-tuning, the other optimizers,
    # the training-state checkpoint (no port kernel on this path)
    t0 = time.perf_counter()
    check_clip(card)
    phase("4v CLIP, optimizers and checkpoint", t0)

    # 4t. the tape on the card: the autograd examples (autograd2d through
    # the jit's graph), every op's gradients against the CPU, the NumPy
    # decode lane and the native merge engine (no port kernel on this path)
    t0 = time.perf_counter()
    check_tape(model, card)
    phase("4t tape, NumPy lane and native tokenizer", t0)

    # 4m. the parallel package on a one-rank NCCL mesh (no port kernel on
    # this path)
    t0 = time.perf_counter()
    check_parallel(model, card)
    phase("4m parallel package on a one-rank mesh", t0)

    # 4h. float16 through every kernel of its path: against the plain
    # versions, the main path, the timings beside bfloat16's
    t0 = time.perf_counter()
    f16_err, f16_launches, f16_ms = check_float16(model, gqa, truth, margins,
                                                  tops, card)
    f16_err.update(flash_f16_err, **qmm_f16_err)  # phases 4c and 3c
    phase("4h float16 path", t0)

    # 5. timings: kernels vs plain per step at pos 512, then end to end
    t0 = time.perf_counter()
    ms = {}
    with torch.no_grad():
        for fmt in ("bf16", "bf16-int8head", "bf16-int8", "bf16-int4"):
            ms[fmt] = time_k1(model, fmt, card)
        for fmt in K2_TIMED:
            key = "K2 B=8" + ("" if fmt == "bf16" else " " + fmt)
            ms[key] = time_k2(model, fmt, 8, card)
        ms.update(time_head_and_step(model, card))
        emit_ms = time_sampling(model, card)
        ms.update(time_gqa_and_wide(model, gqa, model64, card))
    b1_runs = {f"bf16{'-' + q if q else ''}": dict(quant=q)
               for q in B1_QUANTS}
    b1_runs["bf16-kv8"] = dict(kv_quant="int8")
    b1_runs["bf16-sampled"] = dict(seed=SAMPLE_SEED, **SAMPLE)
    # the sampled request is host-bound at 8-16 ms a token: 256 tokens, in
    # the first turn only (as the sampling server below)
    length = {name: SAMPLED_SHORT if "sampled" in name else REQUEST
              for name in b1_runs}
    tok_s = {name: [] for name in b1_runs}
    for turn in range(REPEATS):  # the formats in turns
        for name, rates in tok_s.items():
            if turn and "sampled" in name:
                continue
            start = time.perf_counter()
            n = sum(1 for _ in model.generate(PROMPT, length[name],
                                              dtype=torch.bfloat16,
                                              **b1_runs[name]))
            torch.cuda.synchronize()
            rates.append(n / (time.perf_counter() - start))
    for name, rates in tok_s.items():
        print(f"[chip_smoke] {card}: generate {name} {length[name]}-token "
              f"request, tok/s of {len(rates)} runs: "
              f"{', '.join(f'{r:.1f}' for r in rates)}; median "
              f"{float(np.median(rates)):.1f}")
    runs = {name: (serve_requests(model), kw)
            for name, kw in SERVE_FORMATS.items()}
    # the sampling server's requests capped at SAMPLED_SERVE_NEW new tokens
    runs["bf16-sampled"] = (sampled_requests(model, SAMPLED_SERVE_NEW),
                            SAMPLE)
    serve_rates = {name: [] for name in runs}
    for turn in range(REPEATS):  # the formats in turns
        for name, rates in serve_rates.items():
            if turn and "sampled" in name:
                continue
            start = time.perf_counter()
            _, done = serve(model, runs[name][0], dtype=torch.bfloat16,
                            **runs[name][1], **SERVE)
            rates.append(sum(len(r.tokens) for r in done)
                         / (time.perf_counter() - start))
    for name, rates in serve_rates.items():
        print(f"[chip_smoke] {card}: serve {name} B=8, {N_REQUESTS} "
              f"requests, generated tok/s of {len(rates)} runs: "
              f"{', '.join(f'{r:.1f}' for r in rates)}; median "
              f"{float(np.median(rates)):.1f}")
    rates = []
    for _ in range(REPEATS):
        start = time.perf_counter()
        n = sum(r.numel() for r in model.generate(batch_prompt(8), REQUEST,
                                                  dtype=torch.bfloat16))
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - start))
    print(f"[chip_smoke] {card}: generate bf16 B=8 {REQUEST}-token request, "
          f"tok/s of {REPEATS} runs: {', '.join(f'{r:.1f}' for r in rates)}; median "
          f"{float(np.median(rates)):.1f}")
    ms.update(time_training(card))
    big_ms = time_big_dims(big, card)
    bn_ms = time_nn_training(card)
    phase("5 timings", t0)

    if "--profile" in sys.argv[1:]:
        t0 = time.perf_counter()
        profile(model, card)
        profile_big(big)
        profile_prefix(big)
        profile_nn(card)
        phase("6 profile", t0)

    def entry(name, source, replaces, launches, err, t):
        return {"name": name, "route": "cuda",
                "source": f"pydynet_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": t[0], "plain_ms": t[1],
                "bound_ms": t[2], "bound_by": t[3], "library_ms": t[4]}

    print(f"[chip_smoke] all phases: {time.perf_counter() - t_start:.1f} s")
    gq_file = "pydynet_tpu/ops/gemv_quant.py"
    wgu1, wgu256 = big_ms["int8", "wgu", 1], big_ms["int8", "wgu", 256]
    # phase 4r's 7B speculative server: a verify's layer products and head
    # at BIG_SPEC_ROWS, an admission wave's layer products at BIG_SPEC_WAVE
    wgu_spec = big_ms["int8", "wgu", BIG_SPEC_ROWS]
    head_spec = big_ms["int8", "head", BIG_SPEC_ROWS]
    wgu_wave = big_ms["int8", "wgu", BIG_SPEC_WAVE]
    print(json.dumps({"kernels": [
        entry("decode_token", "decode_token.cu",
              "pydynet_tpu/ops/decode_step.py:160", main_launches,
              max_err["f32"], ms["bf16"] + (None,)),
        entry("lm_head_argmax", "head.cuh",
              "pydynet_tpu/ops/decode_step.py:102",
              step_launches["lm_head_argmax"], step_err["lm_head_argmax"],
              ms["K9 bf16"]),
        entry("fused_decode_step", "decode_step.cu",
              "pydynet_tpu/ops/decode_step.py:1575",
              step_launches["fused_decode_step"],
              step_err["fused_decode_step"], ms["K10 bf16"]),
        entry("decode_token[emit_logits]", "decode_token.cu",
              "pydynet_tpu/ops/decode_step.py:487", emit_launches,
              emit_err["f32"], emit_ms["K1"]),
        entry("decode_token_batched", "decode_token_batched.cu",
              "pydynet_tpu/ops/decode_step.py:509", serve_launches,
              max_err_b["f32"], ms["K2 B=8"] + (None,)),
        entry("decode_token_batched[emit_logits]", "decode_token_batched.cu",
              "pydynet_tpu/ops/decode_step.py:1010", emit_launches_b,
              emit_err_b["f32"], emit_ms["K2 B=8"]),
        entry("decode_token[narrow]", "decode_token.cu",
              "pydynet_tpu/ops/decode_step.py:201", narrow_launches,
              narrow_err["f32"], ms["K1 narrow"] + (None,)),
        entry("decode_token_batched[narrow]", "decode_token_batched.cu",
              "pydynet_tpu/ops/decode_step.py:560", narrow_launches_b,
              narrow_err_b["f32"], ms["K2 narrow B=8"] + (None,)),
        entry("decode_token_batched[B=64]", "decode_token_batched.cu",
              "pydynet_tpu/ops/decode_step.py:1027", wide_launches,
              wide_err_b["f32"], ms["K2 B=64"] + (None,))] + [
        entry(name, "flash_attention.cu",
              f"pydynet_tpu/ops/flash_attention.py:{line}",
              train_launches[name], flash_err[name], ms[name, 1])
        for name, line in zip(FLASH_KERNELS, (82, 192, 259))] + [
        entry("flash_attention_fwd[prefill]", "flash_attention.cu",
              "pydynet_tpu/ops/flash_attention.py:82", prefill_launches,
              prefill_err, prefill_ms)] + [
        entry("quantize_rows", "gemv_quant.cu", f"{gq_file}:309",
              qmm_launches["quantize_rows"], qmm_err["quantize_rows"],
              big_ms["quantize_rows"] + (None,)),
        entry("qmatmul", "gemv_quant.cu", f"{gq_file}:172",
              qmm_launches["qmatmul"], qmm_err["qmatmul"],
              (wgu1[0], wgu1[2], wgu1[3], wgu1[4], None)),
        entry("qmatmul_prefill", "gemv_quant.cu", f"{gq_file}:136",
              qmm_launches["qmatmul_prefill"], qmm_err["qmatmul_prefill"],
              (wgu256[0], wgu256[2], wgu256[3], wgu256[4], wgu256[5])),
        entry("qmatmul_stacked", "gemv_quant.cu", f"{gq_file}:416",
              qmm_launches["qmatmul_stacked"], qmm_err["qmatmul_stacked"],
              (wgu1[1], wgu1[2], wgu1[3], wgu1[4], None)),
        entry("qmatmul_stacked[kv8-prefix-serve]", "gemv_quant.cu",
              f"{gq_file}:416", prefix_launches["qmatmul_stacked"],
              qmm_err["qmatmul_stacked"],
              (wgu1[1], wgu1[2], wgu1[3], wgu1[4], None)),
        entry("qmatmul[kv8-prefix-serve]", "gemv_quant.cu",
              f"{gq_file}:172", prefix_launches["qmatmul"],
              qmm_err["qmatmul"],
              (wgu1[0], wgu1[2], wgu1[3], wgu1[4], None)),
        entry("qmatmul_prefill[kv8-prefix-serve]", "gemv_quant.cu",
              f"{gq_file}:136", prefix_launches["qmatmul_prefill"],
              qmm_err["qmatmul_prefill"],
              (wgu256[0], wgu256[2], wgu256[3], wgu256[4], wgu256[5])),
        entry("quantize_rows[kv8-prefix-serve]", "gemv_quant.cu",
              f"{gq_file}:309", prefix_launches["quantize_rows"],
              qmm_err["quantize_rows"], big_ms["quantize_rows"] + (None,)),
        entry("flash_attention_fwd[kv8-prefix-serve]", "flash_attention.cu",
              "pydynet_tpu/ops/flash_attention.py:82",
              prefix_launches["flash_attention_fwd"], prefill_err,
              prefill_ms),
        entry("batch_norm_train", "batchnorm.cu",
              "pydynet_tpu/ops/batchnorm.py:28", bn_launches, bn_err,
              bn_ms[40, 512]),
        entry("decode_token[lora]", "decode_token.cu",
              "pydynet_tpu/ops/decode_step.py:160",
              lora_launches["decode_token"], lora_err["decode_token"],
              lora_ms["decode_token"]),
        entry("decode_token_batched[lora]", "decode_token_batched.cu",
              "pydynet_tpu/ops/decode_step.py:509",
              lora_launches["decode_token_batched"],
              lora_err["decode_token_batched"],
              lora_ms["decode_token_batched"])] + [
        entry(f"{name}[lora]", "flash_attention.cu",
              f"pydynet_tpu/ops/flash_attention.py:{line}",
              lora_launches[name], lora_err[name], lora_ms[name])
        for name, line in zip(FLASH_KERNELS, (82, 192, 259))] + [
        entry("qmatmul_stacked[spec-7b]", "gemv_quant.cu", f"{gq_file}:416",
              lora_launches["qmatmul_stacked"], qmm_err["qmatmul_stacked"],
              (wgu_spec[1],) + wgu_spec[2:]),
        entry("qmatmul[spec-7b]", "gemv_quant.cu", f"{gq_file}:172",
              lora_launches["qmatmul"], qmm_err["qmatmul"],
              (head_spec[0],) + head_spec[2:]),
        entry("qmatmul_prefill[spec-7b]", "gemv_quant.cu", f"{gq_file}:136",
              lora_launches["qmatmul_prefill"], qmm_err["qmatmul_prefill"],
              (wgu_wave[1],) + wgu_wave[2:]),
        entry("quantize_rows[spec-7b]", "gemv_quant.cu", f"{gq_file}:309",
              lora_launches["quantize_rows"], qmm_err["quantize_rows"],
              big_ms["quantize_rows spec"] + (None,))] + [
        entry(f"{name}[f16]", source, f"{file}:{line}", f16_launches[name],
              f16_err[name], f16_ms[name])
        for name, source, file, line in F16_ENTRIES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
