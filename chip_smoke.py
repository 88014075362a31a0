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
   way at B = 4 and 32, positions 1, 17, 255, 1023 and 1030, with per-row
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
3w. K2 above 32 rows (its row groups): phase 3b's checks at B = 33, 48 and
   64 in every format, the argmax mode at position 1030 and the emit mode
   at 17, and each row of a B = 64 step against K1 on that row alone;
3c. the quantized-matmul kernels against their plain versions, bit for
   bit: the activation quantization, the decode kernel (K5) at every M in
   1..32 and the prefill kernel (K6) at M in {33, 256, 1000} rows, float32
   and bfloat16 rows, int8 and int4 weights, at stories15M's and
   Llama-2-7B's (K, N); at each of those decode cases the stacked kernel
   (K7) with a device layer index, eagerly and captured in a CUDA graph
   replayed at another layer and at indices past either end (clamped) on
   new rows; and K7 over 32 layers at the first, a middle and the last
   layer and at two indices outside them;
3d. the train-mode BatchNorm kernel (K8) against its plain version at
   (N, C) from (1, 7) to (8192, 1024) in float32 and bfloat16, its
   gradients through the autograd op against the plain forward's, and a
   float64 CUDA input raising;
3e. the greedy head alone (K9) against its plain version at stories15M's
   head (D 288, V 32000) in float32 and bfloat16, with a forced tie between
   two rows in different vocab tiles (the lower must win); the layers-only
   step (K10) against its plain version at stories15M width (6 layers,
   S 1024) in float32 and bfloat16 with the pair-swap and head-mask
   matrices at positions 0, 511, 1023 and 1030 (which must act as 1023),
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
   bfloat16 1024-token request (t 0.8, k 50, p 0.9) through K1's emit mode
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
   p 0.9) over the 24 requests, every odd one seeded and every fourth
   greedy, whose K2 emit launches must equal the steps of its sampled
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
   (B, L, 6, 48), B in {1, 8}, L in {1, 7, 64, 1000, 1024}, in float32 and
   bfloat16; a full-parameter fine-tune of the stories15M model at B = 1,
   L = 1024 over ``TRAIN_STEPS`` Adam steps through ``finetune_steps``
   (each kernel's launch counter must equal 6 layers x the steps, and the
   loss must fall), whose first step is held against the same step on the
   CPU; and the ``finetune`` CLI once;
4d. the big-dims path: a Llama-2-7B-geometry model (32 layers, bf16,
   seeded random weights) generating a 64-token request with ``quant="int8"``
   and ``"int4"``, routed by ``fused=None`` to the scan lane, with the
   quantized-matmul launch counters equal to the counts the code implies
   (4 x 32 stacked launches and one head launch a forward, each the
   product's only launch; a prefill's 8 bucketed rows are quantized by
   ``quantize_rows`` first, 4 x 32 launches more); the int8 stream
   teacher-forced against the bf16 scan lane at confident steps; a B=4
   ``LlamaServer(quant="int4")`` that routes itself to the scan lane and
   serves 8 requests (launches counted the same way), every served stream
   teacher-forced through standalone B=1 ``generate``'s forward and equal
   to it at every confident step; the int4 lane against the truth of
   ``dequant_inplace`` weights by majority agreement; the stories15M scan
   lane with a 40-token prompt (its prefill through K6) against the same
   lane on the CPU; and the ``serve_cli`` once with ``--lane xla --quant
   int8``;
4e. the nn-stack trainers: DNN_BN's first step on the card (through K8)
   against the same step on the CPU; the ``dropout_bn`` trainer at its
   published setting, 20 epochs of 8 steps (K8's counter must equal
   2 x 160 and every net's mean loss must fall); the MNIST ConvNet at its
   defaults (test accuracy above 0.5); and both CLIs once;
5. timings: tokens per second of the 1024-token request in each format
   (bfloat16, int8-head, int8, int4, and the int8 KV cache through K2),
   timed ``REPEATS`` times in turns, K1's (also with int8 and int4 layers)
   and K2's (at B = 8 and 32, bfloat16, int8 and int4 layers, the int8 KV
   cache) time per step beside their plain versions' and their bounds,
   K9's beside its bound and ``torch.argmax(head_w @ h + b)``, K10's beside
   its bound and its plain version's, the serving run's generated tokens per second in each of
   4b's formats (``REPEATS`` times, in turns) and the B = 8 request's; the
   sampled request's (256 tokens) and the sampling server's (its requests
   capped at 256 new tokens) tokens per second beside the greedy bf16 ones
   (in the same turns); K1's and K2's (B = 8) emit
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
   quantized matmul at the 7B shapes (M = 1, 4 and 256) beside its plain
   version, ``torch._int_mm`` (int8, M > 16) on the weights as stored,
   row-major, and on a column-major copy, and its bound; each kernel's
   bound (bytes over 3.35 TB/s or operations over the peak for its type;
   K3's and K4's float32 products at float32 accuracy on the tensor cores,
   a third of the TF32 peak) and, for K3/K4, ``F.scaled_dot_product_attention``'s
   forward and backward; K8's time at (40, 512), (40, 128), (1024, 1024) and
   (8192, 1024) beside its plain version, its bound and ``F.batch_norm``,
   the dropout_bn train step in steps/s and the MNIST ConvNet's epochs in
   steps/s and samples/s; K1 narrow against K1 MHA (bf16, pos 512), K2
   narrow B = 8 against MHA B = 8, K2 at B = 64 against B = 32 (bf16 and
   int8 layers), each in turns beside its plain version and bound, and the
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
   share; for the dropout_bn train step its largest kernels and the busy
   share.

The last two lines of standard output are a JSON object describing the
kernels and then ``{"ok": true, "device": {...}}``.
"""
import json
import subprocess
import sys
import time
import types

import numpy as np
import torch

CFG = dict(vocab_size=32000, embed_dim=288, n_heads=6, ffn_dim=768,
           max_seq_len=1024, max_batch_size=32, n_layers=6)  # stories15M
POSITIONS = (0, 1, 17, 255, 1023, 1030)
BATCH_POSITIONS = (1, 17, 255, 1023, 1030)
BATCHES = (4, 32)  # K2 against its plain version
WIDE_BATCHES = (33, 48, 64)  # K2 above one group of 32 rows
WIDE_REQUESTS = 96  # the 64-slot server's requests (SERVE's mix)
# bench.py's GQA_15M: stories15M with 2 KV heads (head_dim 48, Dkv 96)
GQA_CFG = dict(CFG, n_kv_heads=2)
FORMATS = {"f32": (torch.float32, None), "bf16": (torch.bfloat16, None),
           "bf16-int8head": (torch.bfloat16, "int8-head"),
           "f32-int8": (torch.float32, "int8"),
           "bf16-int8": (torch.bfloat16, "int8"),
           "bf16-int4": (torch.bfloat16, "int4")}
# K2's int8 KV cache (float weights only): its formats' weight types
KV8_FORMATS = {"f32-kv8": torch.float32, "bf16-kv8": torch.bfloat16}
BATCHED_FORMATS = ("f32", "bf16", "bf16-int8head", "bf16-int8", "bf16-int4",
                   "f32-kv8", "bf16-kv8")  # what K2 takes
# int8 KV caches, kernel vs plain: both quantize the same new K/V rows, whose
# float32 values differ by summation order (and, in bf16, by a matmul input
# rounded to a neighbouring bf16 value), so an entry may land one step apart.
# A query element or cache entry one step apart moves a score by about 1/127
# of one element's share, and the layers after it carry that on (as for
# QUANT_CACHE_ATOL), so a row's scale (its amax / 127) may move by ~1e-4 of
# itself (1.7e-4 seen at f32, B=32); one bf16 ulp, 2**-7, bounds that and
# keeps a row's entries within one step of each other
KV8_SCALE_RTOL = {torch.float32: 2.0**-7, torch.bfloat16: 2.0**-7}
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
# neighbouring bf16 value (one ulp at |x| < 8 is at most 2**-5)
CACHE_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-5}
# int8/int4 layers: an activation whose x * 127 / amax lies within float32
# summation noise of a half-integer rounds to the other integer in one of
# the two; that moves its matmul's outputs by up to max |w| * amax / 127 and
# the layers after it carry the change on through the residual, so a
# cache row may move by several such steps; bf16's bound holds that
QUANT_CACHE_ATOL = 2.0**-5
# the sampled path (bench.py's sampled-t0.8-k50-p0.9 gate's parameters)
SAMPLE = dict(temperature=0.8, top_k=50, top_p=0.9)
SAMPLE_SEED = 7
SAMPLED_SHORT = 256  # total length of phase 4s's other sampled streams: the
# sampling stage costs about 8 ms a token (PERF.md), so only the main
# request runs 1024 tokens
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
STEP_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-5}
STEP_POSITIONS = (0, 511, 1023, 1030)  # 1030 >= S acts as S - 1
HEAD_TIE = (100, 20000)  # vocab rows in different head tiles
PATH_STEPS = 64  # truth tokens of the K10 + K9 path and the gates
B1_QUANTS = (None, "int8-head", "int8", "int4")  # phase 4's requests
K2_TIMED = ("bf16", "bf16-int8", "bf16-int4", "bf16-kv8")  # phase 5
PROMPT = np.array([[1, 243, 532, 991]])
REQUEST = 1024  # total length of the main-path request
REPEATS = 5  # timed requests (or serving runs) per format in phase 5
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
FLASH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# flash kernels vs their plain versions, both float32 arithmetic on the same
# inputs: they differ in summation order (and the forward's online softmax
# against a two-pass one), so outputs of O(1) get the JAX package's own
# tolerances for its kernels against the composite: 2e-5 for o and lse,
# 5e-4 for the gradients; a bfloat16 output may also round to the
# neighbouring bfloat16 value, one ulp, at most 2**-7 of its magnitude
FLASH_ATOL = {"o": 2e-5, "lse": 2e-5, "dq": 5e-4, "dk": 5e-4, "dv": 5e-4}
BF16_ULP = 2.0**-7
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
# Llama-2-7B geometry (scripts/bench_7b_full.py:48), all 32 layers, bf16
LLAMA2_7B = dict(vocab_size=32000, embed_dim=4096, n_heads=32, ffn_dim=11008,
                 max_seq_len=1024, max_batch_size=1, n_layers=32)
# (K, N) of every quantized matmul: fused qkv, wo, fused gate/up, down, head
QMM_SHAPES = {"stories15M": ((288, 864), (288, 288), (288, 1536), (768, 288),
                             (288, 32000)),
              "7B": ((4096, 12288), (4096, 4096), (4096, 22016),
                     (11008, 4096), (4096, 32000))}
QMM_NAMES = ("wqkv", "wo", "wgu", "down", "head")
# every decode row count (1..32: the fused route up to 4 rows, then the
# int8 rows in tiles of 8, partial ones among them) and prefill rows
# (M > 32) in tiles of 64, full and partial
QMM_ROWS = tuple(range(1, 33)) + (33, 256, 1000)
BIG_NEW = 64  # tokens of the 7B request (prefill token included)
BIG_SERVE = dict(batch_size=4, chunk=32, eos_id=-1)
BIG_REQUESTS, BIG_MAX_NEW = 8, (48, 64, 24, 40)
BIG_TIME_REQUESTS = 16  # the timed server: four admission waves
BIG_REPEATS = 3
LONG_PROMPT = 40  # a stories15M scan-lane prompt past 32 rows: the K6 path
TTFT_PROMPT = 512  # the 7B prompt whose time to the first token is timed
INT4_MIN_AGREE = 0.75  # bench.py's majority floor for the lossy formats
QMM_KERNELS = ("quantize_rows", "qmatmul", "qmatmul_prefill",
               "qmatmul_stacked")
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
# the dropout_bn trainer at its published setting (examples/pydynet/
# dropout_bn.py:128): 320 training faces at batch 40 are 8 steps an epoch,
# each with two BatchNorm1d layers in train mode, so 2 K8 launches a step
DBN_EPOCHS, DBN_STEPS, DBN_LR = 20, 8, 5e-5
MNIST_MIN_ACC = 0.5  # chance is 0.1; tests/test_utils_examples.py:128
# the least time of a function: bytes over the memory rate, or operations
# over the card's peak for their type (NVIDIA's H100 SXM data sheet, dense)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.float32: 67e12, torch.bfloat16: 989e12,
              torch.int8: 1979e12,
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
    version's: float32 EMIT_RTOL[f32] of the logit scale, bfloat16 and the
    quantized formats EMIT_RTOL[other]."""
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


def head_vs_plain(model, dtype, seed=0, tie=False):
    """K9 and its plain version on the same inputs. Returns (kernel token,
    plain token, the plain logit the kernel's token falls short of the
    plain maximum by)."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    h, w, b = head_inputs(model, dtype, seed, tie)
    got = int(dsk.lm_head_argmax(h, w, b)[0, 0])
    want = int(dsk.lm_head_argmax_ref(h, w, b)[0, 0])
    logits = w.float() @ h[0] + b.float()
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
    # the path: counters zeroed just before it, read just after
    w = model._fused_weights(torch.float32)
    dev, D, L = model.device, model.embed_dim, PROMPT.shape[1]
    rot = dsk.rope_pair_swap_matrix(D).to(dev)
    hmask = dsk.head_mask_matrix(D, model.n_heads).to(dev)
    ck, cv = model._flat_caches(*model._empty_caches(1, torch.float32), w)
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
    print(f"[chip_smoke] K10 + K9 path: {len(feed)} steps, launches "
          f"{launches}, {ok}/{int(conf.sum())} confident steps equal the "
          f"f32 truth")
    if any(n != len(feed) for n in launches.values()):
        raise AssertionError(f"K10 + K9 path launches {launches}, want "
                             f"{len(feed)} each")
    if not conf.any() or ok != int(conf.sum()):
        raise AssertionError("K10 + K9 path differs from the truth at a "
                             "confident step")
    return err, launches


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
        for fmt, (dtype, quant) in FORMATS.items():
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


def flash_vs_plain(B, L, dtype, seed=0, d=48, heads=CFG["n_heads"]):
    """K3 and both K4 kernels against their plain versions on the same
    inputs (the backward ones given the kernel forward's o and lse). Raises
    beyond ``FLASH_ATOL``; returns {output: max |kernel - plain|}."""
    from pydynet_tpu_torch.ops import flash_attention as fa

    q, k, v, do = flash_inputs(B, L, dtype, seed, d, heads)
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v)
    dd = fa.attention_dd(o, do)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, dd)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, dd)
    plain = dict(zip(("o", "lse"), fa.flash_attention_fwd_ref(q, k, v,
                                                              scale)))
    plain["dq"] = fa.flash_attention_bwd_dq_ref(q, k, v, do, lse, dd, scale)
    plain["dk"], plain["dv"] = fa.flash_attention_bwd_dkv_ref(
        q, k, v, do, lse, dd, scale)
    torch.cuda.synchronize()
    errs = {}
    for name, got in dict(o=o, lse=lse, dq=dq, dk=dk, dv=dv).items():
        want = plain[name].float()
        err = (got.float() - want).abs()
        tol = FLASH_ATOL[name] + (BF16_ULP * want.abs()
                                  if got.dtype == torch.bfloat16 else 0.0)
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


def check_training():
    """Phase 4c: K3/K4 against plain, the fine-tune through them, the CLI.
    Returns ({kernel: launches in the main run}, {kernel: max f32 error})."""
    from pydynet_tpu_torch.models.llama import finetune

    errs = {name: 0.0 for name in FLASH_KERNELS}
    for dname, dtype in FLASH_DTYPES.items():
        for B in FLASH_BATCHES:
            for L in FLASH_LENGTHS:
                e = flash_vs_plain(B, L, dtype)
                print(f"[chip_smoke] flash {dname} B={B} L={L}: max error "
                      + ", ".join(f"{k} {v:.3g}" for k, v in e.items()))
                if dtype == torch.float32:
                    for name, keys in zip(FLASH_KERNELS,
                                          (("o", "lse"), ("dq",),
                                           ("dk", "dv"))):
                        errs[name] = max([errs[name]] + [e[x] for x in keys])

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
    return launches, errs


def time_training(card):
    """Phase 5's training part: K3 and K4 against plain, then the step."""
    from pydynet_tpu_torch.ops import flash_attention as fa

    ms = {}
    scale = 48 ** -0.5
    for B in (1, 8):
        q, k, v, do = flash_inputs(B, TRAIN_L, torch.float32, 1)
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
        lib = sdpa_ms(q, k, v, do)
        for name, (kern, ref) in pairs.items():
            plain, kernel = time_step(ref, 10), time_step(kern, 50)
            kernel2, plain2 = time_step(kern, 50), time_step(ref, 10)
            b_ms, b_by = flash_bound(q, FLASH_PRODUCTS[name], True)
            ms[name, B] = (min(kernel, kernel2), min(plain, plain2), b_ms,
                           b_by, lib[name != "flash_attention_fwd"])
            way = "forward" if name == "flash_attention_fwd" else "backward"
            print(f"[chip_smoke] {card}: {name} f32 ({B}, {TRAIN_L}, 6, 48):"
                  f" kernel {ms[name, B][0] * 1e3:.1f} us, plain "
                  f"{ms[name, B][1] * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us"
                  f" ({b_by}), F.scaled_dot_product_attention {way} "
                  f"{ms[name, B][4] * 1e3:.1f} us")
        del q, k, v, do, o, lse, dd
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
    from pydynet_tpu_torch.ops import gemv_quant as gq

    return {"quantize_rows": gq.quantize_rows.launches,
            "qmatmul": gq.qmatmul.launches,
            "qmatmul_prefill": gq.qmatmul.prefill_launches,
            "qmatmul_stacked": gq.qmatmul_stacked.launches}


def zero_qmm_counters():
    from pydynet_tpu_torch.ops import gemv_quant as gq

    gq.quantize_rows.launches = gq.qmatmul.launches = 0
    gq.qmatmul.prefill_launches = gq.qmatmul_stacked.launches = 0


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
    bit for bit. Returns {kernel: max |kernel - plain|}."""
    from pydynet_tpu_torch.ops import gemv_quant as gq

    errs = {name: 0.0 for name in QMM_KERNELS}
    counts = {}

    def same(name, got, want, what):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {what}: max error "
                                 f"{max_diff(got, want)}")
        errs[name] = max(errs[name], max_diff(got, want))

    def replayed(x, w, ws, q4, what):
        """The stacked call at a device index, eager at layer 0, then
        captured in a CUDA graph and replayed at the last layer and at an
        index past either end (clamped), each time on new rows."""
        idx = torch.zeros((), dtype=torch.int32, device=w.device)
        L = w.shape[0]
        same("qmatmul_stacked", gq.qmatmul_stacked(x, w, ws, idx, q4=q4),
             gq.qmatmul_ref(x, w[0], ws[0], q4=q4), f"{what} index 0")
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
                 f"{what} replayed at index {index}")

    for where, shapes in QMM_SHAPES.items():
        for K, N in shapes:
            for q4 in (False, True):
                w, ws = random_qweights(K, N, q4, K + N + q4, layers=3)
                for M in QMM_ROWS:
                    for dtype in (torch.float32, torch.bfloat16):
                        what = f"{where} ({K}, {N}) q4={q4} M={M} {dtype}"
                        x = random_rows(M, K, dtype, M + K)
                        xq, sx = gq.quantize_rows(x)
                        rxq, rsx = gq.quantize_rows_ref(x)
                        torch.cuda.synchronize()
                        if not (torch.equal(xq, rxq) and torch.equal(sx, rsx)):
                            raise AssertionError(
                                f"quantize_rows M={M} K={K} {dtype} differs "
                                f"from plain")
                        decode = M <= gq.MAX_DECODE_ROWS
                        same("qmatmul" if decode else "qmatmul_prefill",
                             gq.qmatmul(x, w[1], ws[1], q4=q4),
                             gq.qmatmul_ref(x, w[1], ws[1], q4=q4), what)
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
                     f"index {index} of {L} q4={q4} M={M}")
        del w, ws
    print(f"[chip_smoke] quantized matmuls equal their plain versions bit "
          f"for bit: {counts} (shape, format, M, type) cases, int8 and int4; "
          f"at every M <= {gq.MAX_DECODE_ROWS} the stacked call at a device "
          f"index eagerly and replayed from a CUDA graph at other layers and "
          f"clamped indices; over {L} layers at indices "
          f"{[i for i, _ in layers]} (the last two clamped)")
    return errs


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
                  generator=torch.Generator().manual_seed(0)).eval()
    torch.cuda.synchronize()
    print(f"[chip_smoke] built Llama-2-7B geometry ({model.n_layers} "
          f"layers, bf16, seeded random) in {time.perf_counter() - t0:.1f} s, "
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
    want = {"quantize_rows": 2 * 4 * L,  # the prefill kernel's rows only
            "qmatmul": 2 * ((4 * L + 1) * (n_new - 1) + 1),
            "qmatmul_prefill": 2 * 4 * L, "qmatmul_stacked": 0}
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
                    or ran["qmatmul_prefill"] != 0:
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
            for M in (1, 4, 256):
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
    x = random_rows(1, D, bf16, 0)
    q_ms = time_graph(lambda i: gq.quantize_rows(x), 100)
    q_plain = time_step(lambda: gq.quantize_rows_ref(x), 50)
    q_bound = bound(nbytes(x) + D + 4, 3 * D, bf16)
    print(f"[chip_smoke] {card}: quantize_rows (1, {D}) bf16: kernel "
          f"{q_ms * 1e3:.1f} us, plain {q_plain * 1e3:.1f} us, bound "
          f"{q_bound[0] * 1e3:.3f} us")
    out["quantize_rows"] = (q_ms, q_plain) + q_bound
    return out


def bn_inputs(N, C, dtype, seed=0, device="cuda"):
    """Seeded O(1) K8 inputs: x (N, C) normal in ``dtype``, gamma in
    [0.5, 1.5] and beta normal / 2, (1, C) float32."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((N, C), generator=g, device=device).to(dtype)
    gamma = torch.rand((1, C), generator=g, device=device) + 0.5
    beta = torch.randn((1, C), generator=g, device=device) / 2
    return x, gamma, beta


def bn_vs_plain(N, C, dtype, seed=0):
    """K8 against its plain version on the same inputs, and the gradients
    through the autograd op against autograd through the plain forward.
    Raises beyond the stated tolerances; returns {output: max error}."""
    from pydynet_tpu_torch.ops import batchnorm as bn

    x, gamma, beta = bn_inputs(N, C, dtype, seed)
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


def check_batchnorm():
    """Phase 3d: K8 against plain at BN_SHAPES in float32 and bfloat16, and
    a float64 CUDA input raising. Returns the largest float32 error."""
    from pydynet_tpu_torch.ops import batchnorm as bn

    worst = 0.0
    for dname, dtype in FLASH_DTYPES.items():
        for N, C in BN_SHAPES:
            e = bn_vs_plain(N, C, dtype)
            print(f"[chip_smoke] batch_norm_train {dname} ({N}, {C}): max "
                  f"error " + ", ".join(f"{k} {v:.3g}" for k, v in e.items()))
            if dtype == torch.float32:
                worst = max(worst, e["out"], e["mean"], e["var"])
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
    k8.launches = 0
    _, history, accs = dbn.train(epochs=DBN_EPOCHS)
    launches = k8.launches
    print(f"[chip_smoke] dropout_bn {DBN_EPOCHS} epochs: K8 launches "
          f"{launches}, mean losses first {history[0]} last {history[-1]}, "
          f"test accuracies {accs}")
    want = 2 * DBN_EPOCHS * DBN_STEPS
    if launches != want:
        raise AssertionError(f"K8 launches {launches}, want {want}")
    if not all(np.isfinite(history[0] + history[-1])) or not all(
            b < a for a, b in zip(history[0], history[-1])):
        raise AssertionError(f"a net's loss did not fall: {history}")
    acc = mnist.main(["--network", "conv", "--synthetic"])
    print(f"[chip_smoke] MNIST ConvNet 20 epochs: test accuracy {acc}")
    if not acc > MNIST_MIN_ACC:
        raise AssertionError(f"MNIST ConvNet accuracy {acc} <= "
                             f"{MNIST_MIN_ACC}")
    before = k8.launches
    accs = dbn.cli(["--epochs", "2"])
    acc = mnist.main(["--network", "mlp", "--synthetic", "--epochs", "2"])
    print(f"[chip_smoke] CLIs: dropout_bn accuracies {accs}, K8 launches "
          f"{k8.launches - before}; MNIST MLP accuracy {acc}")
    if k8.launches - before != 2 * 2 * DBN_STEPS or not 0 < acc <= 1:
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
    training set there: a callable that runs one epoch and waits."""
    from pydynet_tpu_torch import manual_seed
    from pydynet_tpu_torch.examples import mnist
    from pydynet_tpu_torch.optim import Adam

    manual_seed(seed)
    net = mnist.ConvNet().cuda()
    opt = Adam(net.parameters(), lr=1e-4)
    (X, y), _ = mnist.synthetic_mnist()
    Xd = torch.from_numpy(X.astype(np.float32)).cuda()
    yd = torch.from_numpy(y).cuda()

    def epoch():
        perm = torch.from_numpy(np.random.permutation(len(X))).cuda()
        loss, steps = mnist.train_epoch(net, opt, Xd[perm], yd[perm], 256)
        float(loss)
        return steps, len(X)

    return epoch


def time_nn_training(card):
    """Phase 5's nn part: K8 at BN_TIME_SHAPES in float32 against its plain
    version, its bound and ``F.batch_norm``; the dropout_bn step and the
    MNIST ConvNet's epochs. Returns {(N, C): (ms, plain_ms, bound_ms,
    bound_by, library_ms)}."""
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
    step = dbn_step_runner()
    for _ in range(3):  # warm-up
        step()
    rates = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(50):
            step()
        torch.cuda.synchronize()
        rates.append(50 / (time.perf_counter() - start))
    print(f"[chip_smoke] {card}: dropout_bn train step (three nets, batch "
          f"40) steps/s of {REPEATS} runs of 50: "
          f"{', '.join(f'{r:.1f}' for r in rates)}; median "
          f"{float(np.median(rates)):.1f}")
    epoch = mnist_runner()
    epoch()  # warm-up
    times = []
    for _ in range(5):
        start = time.perf_counter()
        steps, samples = epoch()
        times.append(time.perf_counter() - start)
    t = float(np.median(times))
    print(f"[chip_smoke] {card}: MNIST ConvNet train epoch ({steps} steps of "
          f"256) s of 5 epochs: {', '.join(f'{x:.4f}' for x in times)}; "
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
    1024-token request through K1's emit mode (its emit launches equal the
    decode steps, the argmax mode unused; the same seed twice the same
    stream; top_k = 1 the greedy stream), the law check, sampled
    ``generate`` at B=8 and with the int8 KV cache at B=1 through K2's emit
    mode. Returns K1's emit launches of the sampled request."""
    from pydynet_tpu_torch.ops import decode_step as dsk
    from pydynet_tpu_torch.utils import fidelity

    k1, k2 = dsk.fused_decode_token, dsk.fused_decode_token_batched
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
    steps = REQUEST - PROMPT.shape[1] - 1
    kw = dict(dtype=torch.bfloat16, **SAMPLE)
    list(model.generate(PROMPT, PROMPT.shape[1] + 3, seed=1, **kw))
    torch.cuda.synchronize()
    k1.launches = k1.emit_launches = 0
    toks = [int(t[0, 0]) for t in model.generate(PROMPT, REQUEST,
                                                 seed=SAMPLE_SEED, **kw)]
    emit_launches = k1.emit_launches
    print(f"[chip_smoke] generate bf16 sampled (t 0.8, k 50, p 0.9, seed "
          f"{SAMPLE_SEED}): {len(toks)} tokens, {emit_launches} emit "
          f"launches, {k1.launches} argmax-mode launches, "
          f"{len(set(toks))} distinct tokens")
    if emit_launches != steps or k1.launches or len(toks) != steps + 1 \
            or not all(0 <= x < CFG["vocab_size"] for x in toks):
        raise AssertionError(f"sampled request: {emit_launches} emit "
                             f"launches, {k1.launches} argmax launches, "
                             f"{len(toks)} tokens; want {steps} steps")
    again = [int(t[0, 0]) for t in model.generate(PROMPT, REQUEST,
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
        short = SAMPLED_SHORT - PROMPT.shape[1] - 1
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
    24-request mix with per-request overrides (``sampled_requests``):
    K2's emit launches equal the steps of its sampled chunks and its
    argmax launches the rest; a seeded request admitted first gives the
    same tokens in two different fleets; the CLIs with the sampling flags.
    Returns K2's emit launches of the server run."""
    from pydynet_tpu_torch.models.llama import infer, serve_cli
    from pydynet_tpu_torch.ops import decode_step as dsk

    k1, k2 = dsk.fused_decode_token, dsk.fused_decode_token_batched
    requests = sampled_requests(model)
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
    target = ((PROMPT[0].tolist() * 5)[:17], 200, dict(seed=4242))
    _, a = serve(model, [target] + requests[:7], **kw)
    _, b = serve(model, [target] + [(p, n, dict(temperature=0.0))
                                    for p, n, _ in requests[7:10]], **kw)
    print(f"[chip_smoke] seeded request in two fleets (8 and 4 requests): "
          f"{len(a[0].tokens)} tokens, equal {a[0].tokens == b[0].tokens}")
    if a[0].tokens != b[0].tokens or len(a[0].tokens) != 200:
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


def check_k1(model, label=""):
    """Phase 3 (and 3n on a grouped-query model): K1 against its plain
    version in every format at POSITIONS, then its emit_logits mode.
    Returns (cache errors, emit errors) by format."""
    max_err, emit_err = {}, {}
    for fmt, (dtype, _) in FORMATS.items():
        max_err[fmt] = 0.0
        for pos in POSITIONS:
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
    for fmt in FORMATS:  # the emit_logits mode
        for pos in POSITIONS:
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
             emit_positions=EMIT_POSITIONS_B):
    """Phase 3b (3n, 3w): K2 against its plain version in every format at
    ``batches`` x ``positions`` with per-row starts, each row of a
    ``rows_batch``-row step against K1 on that row alone (the int8 KV
    cache's against K2 at B=1), then K2's emit_logits mode at ``batches``
    x ``emit_positions``. Returns (cache errors, emit errors) by format."""
    max_err_b, emit_err_b = {}, {}
    for fmt in BATCHED_FORMATS:
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
    for fmt in BATCHED_FORMATS:  # the emit_logits mode
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
    against B=32 (bf16, int8 layers), each in turns beside its plain
    version and bound; then tokens per second of the GQA 1024-token
    request, the GQA B=8 server and the 64-slot server."""
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
              "K2 wide": tuple((f"K2 B={b}" + ("" if f == "bf16" else " int8"),
                                k2_case(model, f, b))
                               for f in ("bf16", "bf16-int8")
                               for b in (32, max(WIDE_BATCHES)))}
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
    for _ in range(3):  # in turns
        for name, run in runs.items():
            start = time.perf_counter()
            n = run()
            torch.cuda.synchronize()
            rates[name].append(n / (time.perf_counter() - start))
    for name, r in rates.items():
        print(f"[chip_smoke] {card}: {name} tok/s of 3 runs: "
              f"{', '.join(f'{x:.1f}' for x in r)}; median "
              f"{float(np.median(r)):.1f}")
    return ms


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
    qmm_err = check_qmatmul()
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
    train_launches, flash_err = check_training()
    phase("4c training path", t0)

    # 4d. the big-dims path: Llama-2-7B geometry on the scan lane
    t0 = time.perf_counter()
    big, qmm_launches = check_big_dims()
    phase("4d big-dims path", t0)

    # 4e. the nn-stack trainers: dropout_bn through K8, the MNIST ConvNet
    t0 = time.perf_counter()
    bn_launches = check_nn_training()
    phase("4e nn training path", t0)

    # 5. timings: kernels vs plain per step at pos 512, then end to end
    t0 = time.perf_counter()
    ms = {}
    with torch.no_grad():
        for fmt in ("bf16", "bf16-int8head", "bf16-int8", "bf16-int4"):
            dtype, quant = FORMATS[fmt]
            w = model._fused_weights(dtype, quant)
            ck, cv = random_caches(model, dtype, 1)
            args, kw = step_args(model, w, ck, cv, 512, 1234)
            plain = time_step(lambda: dsk.fused_decode_token_ref(*args, **kw),
                              20)
            kernel = time_step(lambda: dsk.fused_decode_token(*args, **kw),
                               200)
            plain2 = time_step(lambda: dsk.fused_decode_token_ref(*args, **kw),
                               20)
            kernel2 = time_step(lambda: dsk.fused_decode_token(*args, **kw),
                                200)
            ms[fmt] = (min(kernel, kernel2), min(plain, plain2)) \
                + decode_step_bound(w, ck, 512, 1)
            print(f"[chip_smoke] {card}: {fmt} step at pos 512: kernel "
                  f"{ms[fmt][0] * 1e3:.1f} us, plain {ms[fmt][1] * 1e3:.1f} "
                  f"us, bound {ms[fmt][2] * 1e3:.1f} us ({ms[fmt][3]})")
        for fmt in K2_TIMED:
            w = model._fused_weights(*fmt_of(fmt))
            for batch in (8, 32):
                ck, cv = batched_caches(model, fmt, 1, batch)
                args, kw = batched_args(model, w, ck, cv, 512,
                                        range(100, 100 + batch))
                kern = lambda: dsk.fused_decode_token_batched(*args, **kw)
                ref = lambda: dsk.fused_decode_token_batched_ref(*args, **kw)
                plain, kernel = time_step(ref, 3), time_step(kern, 200)
                plain2, kernel2 = time_step(ref, 3), time_step(kern, 200)
                key = "K2 B=%d" % batch + ("" if fmt == "bf16" else " " + fmt)
                ms[key] = (min(kernel, kernel2), min(plain, plain2)) \
                    + decode_step_bound(w, ck, 512, batch)
                print(f"[chip_smoke] {card}: K2 {fmt} B={batch} step at pos "
                      f"512: kernel {ms[key][0] * 1e3:.1f} us, plain "
                      f"{ms[key][1] * 1e3:.1f} us, bound "
                      f"{ms[key][2] * 1e3:.1f} us ({ms[key][3]})")
                del ck, cv
        ms.update(time_head_and_step(model, card))
        emit_ms = time_sampling(model, card)
        ms.update(time_gqa_and_wide(model, gqa, model64, card))
    b1_runs = {f"bf16{'-' + q if q else ''}": dict(quant=q)
               for q in B1_QUANTS}
    b1_runs["bf16-kv8"] = dict(kv_quant="int8")
    b1_runs["bf16-sampled"] = dict(seed=SAMPLE_SEED, **SAMPLE)
    # the sampled request is host-bound at about 10 ms a token: 256 tokens
    length = {name: SAMPLED_SHORT if "sampled" in name else REQUEST
              for name in b1_runs}
    tok_s = {name: [] for name in b1_runs}
    for _ in range(REPEATS):  # the formats in turns
        for name, rates in tok_s.items():
            start = time.perf_counter()
            n = sum(1 for _ in model.generate(PROMPT, length[name],
                                              dtype=torch.bfloat16,
                                              **b1_runs[name]))
            torch.cuda.synchronize()
            rates.append(n / (time.perf_counter() - start))
    for name, rates in tok_s.items():
        print(f"[chip_smoke] {card}: generate {name} {length[name]}-token "
              f"request, tok/s of {REPEATS} runs: "
              f"{', '.join(f'{r:.1f}' for r in rates)}; median "
              f"{float(np.median(rates)):.1f}")
    runs = {name: (serve_requests(model), kw)
            for name, kw in SERVE_FORMATS.items()}
    # the sampling server's requests capped at SAMPLED_SHORT new tokens
    runs["bf16-sampled"] = (sampled_requests(model, SAMPLED_SHORT), SAMPLE)
    serve_rates = {name: [] for name in runs}
    for _ in range(REPEATS):  # the formats in turns
        for name, rates in serve_rates.items():
            start = time.perf_counter()
            _, done = serve(model, runs[name][0], dtype=torch.bfloat16,
                            **runs[name][1], **SERVE)
            rates.append(sum(len(r.tokens) for r in done)
                         / (time.perf_counter() - start))
    for name, rates in serve_rates.items():
        print(f"[chip_smoke] {card}: serve {name} B=8, {N_REQUESTS} "
              f"requests, generated tok/s of {REPEATS} runs: "
              f"{', '.join(f'{r:.1f}' for r in rates)}; median "
              f"{float(np.median(rates)):.1f}")
    rates = []
    for _ in range(3):
        start = time.perf_counter()
        n = sum(r.numel() for r in model.generate(batch_prompt(8), REQUEST,
                                                  dtype=torch.bfloat16))
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - start))
    print(f"[chip_smoke] {card}: generate bf16 B=8 {REQUEST}-token request, "
          f"tok/s of 3 runs: {', '.join(f'{r:.1f}' for r in rates)}; median "
          f"{float(np.median(rates)):.1f}")
    ms.update(time_training(card))
    big_ms = time_big_dims(big, card)
    bn_ms = time_nn_training(card)
    phase("5 timings", t0)

    if "--profile" in sys.argv[1:]:
        t0 = time.perf_counter()
        profile(model, card)
        profile_big(big)
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
    print(json.dumps({"kernels": [
        entry("decode_token", "decode_token.cu",
              "pydynet_tpu/ops/decode_step.py:160", main_launches,
              max_err["f32"], ms["bf16"] + (None,)),
        entry("lm_head_argmax", "decode_token.cu",
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
        entry("batch_norm_train", "batchnorm.cu",
              "pydynet_tpu/ops/batchnorm.py:28", bn_launches, bn_err,
              bn_ms[40, 512])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
