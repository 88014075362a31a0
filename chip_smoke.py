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
   stories15M width with seeded random weights, in float32, bfloat16 and
   bfloat16 with the int8 head, at positions 0, 1, 17, 255, 1023 and 1030
   (the last one exercises the clamp to S - 1);
3b. the batched decode-step kernel (K2) against its plain version the same
   way at B = 4 and 32, positions 1, 17, 255, 1023 and 1030, with per-row
   ``starts`` (one row starting at pos), and each K2 row at B = 8 against
   K1 on that row alone;
4. the B=1 path: ``Llama.generate`` of a 1024-token request in bfloat16,
   with and without ``quant="int8-head"``, through K1 (its launch counter
   must equal the decode steps), the confident-step argmax gate against a
   float32 truth stream, and the ``infer`` CLI once;
4b. the serving path: ``LlamaServer`` (B = 8, bfloat16, with and without
   the int8 head) serving 24 requests with slot recycling, shifted
   admissions and truncation at the cache end, through K2 (its launch
   counter must equal the steps the server dispatched); a float32 server
   whose streams equal standalone float32 ``generate`` (K1) up to the first
   near-tie; the batched argmax gates at B = 4 and 32; ``generate`` of a
   1024-token request at B = 8 through K2; and the ``serve_cli`` once;
4c. the training path: the flash-attention forward (K3) and its dq and
   dk/dv backward kernels (K4) against their plain versions at
   (B, L, 6, 48), B in {1, 8}, L in {1, 7, 64, 1000, 1024}, in float32 and
   bfloat16; a full-parameter fine-tune of the stories15M model at B = 1,
   L = 1024 over ``TRAIN_STEPS`` Adam steps through ``finetune_steps``
   (each kernel's launch counter must equal 6 layers x the steps, and the
   loss must fall), whose first step is held against the same step on the
   CPU; and the ``finetune`` CLI once;
5. timings: tokens per second of the 1024-token request in each format,
   timed ``REPEATS`` times in turns, K1's and K2's time per step beside
   their plain versions', the serving run's generated tokens per second
   (``REPEATS`` times, the formats in turns) and the B = 8 request's; K3's
   and K4's times beside their plain versions' at (1, 1024, 6, 48) and
   (8, 1024, 6, 48), and the training step's time and training tokens per
   second at B = 1 and 8, L = 1024 (``REPEATS`` steps in turns); all with
   the card's name and power limit;
6. only with ``--profile``: for K1 the step by CUDA events and the host's
   enqueue time per call at positions 0, 512 and 1023, and for K1 and K2
   the device time of each kernel of the chain from ``torch.profiler``;
   the device's busy share of a 1024-token request and of a serving run
   under the profiler; for the training step at B = 1 and 8 the device time
   of its largest kernels and the device's busy share.

The last two lines of standard output are a JSON object describing the
kernels and then ``{"ok": true, "device": {...}}``.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

CFG = dict(vocab_size=32000, embed_dim=288, n_heads=6, ffn_dim=768,
           max_seq_len=1024, max_batch_size=32, n_layers=6)  # stories15M
POSITIONS = (0, 1, 17, 255, 1023, 1030)
BATCH_POSITIONS = (1, 17, 255, 1023, 1030)
BATCHES = (4, 32)  # K2 against its plain version
FORMATS = {"f32": (torch.float32, None), "bf16": (torch.bfloat16, None),
           "bf16-int8head": (torch.bfloat16, "int8-head")}
# cache tolerance, kernel vs plain: f32 differs only in summation order
# (values are O(1), so 1e-4 is ~1000 f32 ulps); bf16 rows may round to a
# neighbouring bf16 value (one ulp at |x| < 8 is at most 2**-5)
CACHE_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-5}
PROMPT = np.array([[1, 243, 532, 991]])
REQUEST = 1024  # total length of the main-path request
REPEATS = 5  # timed requests (or serving runs) per format in phase 5
SERVE = dict(batch_size=8, chunk=128, eos_id=-1)  # the phase-4b server
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


def phase(name, t0):
    print(f"[chip_smoke] phase {name}: ok ({time.perf_counter() - t0:.1f} s)",
          flush=True)


def i32(values, dev):
    return torch.tensor(values, dtype=torch.int32, device=dev)


def step_args(model, weights, ck, cv, pos, tok):
    from pydynet_tpu_torch.models.llama.model import decode_weight_args

    dev = model.device
    return ((i32([pos], dev), i32([tok], dev),
             *decode_weight_args(weights), ck, cv),
            dict(n_heads=model.n_heads, head_s=weights.get("head_s")))


def batched_args(model, weights, ck, cv, pos, toks, starts=None):
    from pydynet_tpu_torch.models.llama.model import decode_weight_args

    dev = model.device
    return ((i32([pos], dev), i32(list(toks), dev),
             *decode_weight_args(weights), ck, cv),
            dict(n_heads=model.n_heads, head_s=weights.get("head_s"),
                 starts=None if starts is None else i32(list(starts), dev)))


def random_caches(model, dtype, seed, batch=None):
    """Seeded random caches: (N, S, D), or (N, B, S, D) for ``batch``."""
    g = torch.Generator(device=model.device).manual_seed(seed)
    shape = (model.n_layers, model.max_seq_len, model.embed_dim)
    if batch is not None:
        shape = (model.n_layers, batch) + shape[1:]
    return [torch.randn(shape, generator=g, device=model.device)
            .mul_(0.5).to(dtype) for _ in range(2)]


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
    ck, cv = random_caches(model, dtype, seed)
    args, kw = step_args(model, w, ck, cv, pos, tok)
    rck, rcv = ck.clone(), cv.clone()
    got = int(dsk.fused_decode_token(*args, **kw)[0])
    rargs = args[:-2] + (rck, rcv)
    logits = dsk.decode_token_logits_ref(*rargs, **kw)
    want = int(torch.argmax(logits))
    torch.cuda.synchronize()
    err = max(max_diff(ck, rck), max_diff(cv, rcv))
    return got, want, bool(confident_rows(logits)), err


def batched_vs_plain(model, fmt, batch, pos, seed=0):
    """One batched step of ``batch`` rows through K2 and through its plain
    version on the same inputs, rows starting at seeded ``starts`` in
    [0, min(pos, S - 1)] (row 0 at pos itself). Returns (kernel tokens,
    plain tokens, confident rows, max |cache difference|)."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    dtype, quant = FORMATS[fmt]
    w = model._fused_weights(dtype, quant)
    ck, cv = random_caches(model, dtype, seed, batch)
    rng = np.random.default_rng(seed)
    p = min(pos, model.max_seq_len - 1)
    starts = rng.integers(0, p + 1, size=batch)
    starts[0] = p
    toks = rng.integers(0, model.vocab_size, size=batch)
    args, kw = batched_args(model, w, ck, cv, pos, toks, starts)
    rck, rcv = ck.clone(), cv.clone()
    got = dsk.fused_decode_token_batched(*args, **kw).cpu()
    logits = dsk.decode_token_batched_logits_ref(*args[:-2], rck, rcv, **kw)
    torch.cuda.synchronize()
    err = max(max_diff(ck, rck), max_diff(cv, rcv))
    return got, logits.argmax(-1).cpu().int(), confident_rows(logits), err


def batched_rows_vs_k1(model, fmt, batch=8, pos=512, seed=5):
    """K2 over ``batch`` rows starting at 0 against K1 on each row alone.
    Returns (tokens equal, max |cache difference|)."""
    from pydynet_tpu_torch.ops import decode_step as dsk

    dtype, quant = FORMATS[fmt]
    w = model._fused_weights(dtype, quant)
    ck, cv = random_caches(model, dtype, seed, batch)
    toks = np.random.default_rng(seed).integers(0, model.vocab_size,
                                                size=batch)
    rows_k = [ck[:, b].clone() for b in range(batch)]
    rows_v = [cv[:, b].clone() for b in range(batch)]
    args, kw = batched_args(model, w, ck, cv, pos, toks)
    got = dsk.fused_decode_token_batched(*args, **kw).tolist()
    one = []
    for b in range(batch):
        a1, k1 = step_args(model, w, rows_k[b], rows_v[b], pos, int(toks[b]))
        one.append(int(dsk.fused_decode_token(*a1, **k1)[0]))
    err = max(max(max_diff(ck[:, b], rows_k[b]), max_diff(cv[:, b],
                                                          rows_v[b]))
              for b in range(batch))
    return got == one, err


def serve_requests(model, seed=0):
    """Seeded (prompt, max_new_tokens) requests: prompt lengths in
    [2, 16], max_new_tokens cycling over MAX_NEW."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, model.vocab_size,
                          size=int(rng.integers(2, 17))).tolist(),
             MAX_NEW[i % len(MAX_NEW)]) for i in range(N_REQUESTS)]


def serve(model, requests, **kw):
    """One server run over ``requests``; returns (server, requests done)."""
    from pydynet_tpu_torch.models.llama.serve import LlamaServer

    srv = LlamaServer(model, **kw)
    rids = [srv.submit(p, max_new_tokens=n) for p, n in requests]
    done = srv.run()
    torch.cuda.synchronize()
    return srv, [done[r] for r in rids]


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


def check_serving(model):
    """Phase 4b: the serving path through K2. Returns K2's launches."""
    from pydynet_tpu_torch.models.llama import serve_cli
    from pydynet_tpu_torch.ops import decode_step as dsk
    from pydynet_tpu_torch.utils import fidelity

    k2 = dsk.fused_decode_token_batched
    requests = serve_requests(model)
    serve(model, requests[:2], dtype=torch.bfloat16, **SERVE)  # warm-up
    k2.launches = 0
    for quant in (None, "int8-head"):
        before = k2.launches
        start = time.perf_counter()
        srv, done = serve(model, requests, dtype=torch.bfloat16,
                          quant=quant, **SERVE)
        wall = time.perf_counter() - start
        launched = k2.launches - before
        n_tok = sum(len(r.tokens) for r in done)
        name = f"bf16{'-' + quant if quant else ''}"
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

    # f32 server against standalone f32 generate (K1) on each prompt
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
    print(f"[chip_smoke] f32 server B=4 vs standalone f32 generate: "
          f"{compared} tokens equal up to each stream's first near-tie")
    if compared < 100:
        raise AssertionError(f"only {compared} f32 tokens compared")

    # the batched argmax gates (bench.py's batched-b4, -b32, -b4-int8head)
    for batch, quants in ((4, (None, "int8-head")), (32, (None,))):
        prompt = batch_prompt(batch)
        truth, margins, tops = fidelity.greedy_truth(model, prompt, 64)
        for quant in quants:
            checked, ok, agree = fidelity.gate_fused_argmax(
                model, prompt, truth, margins, tops, dtype=torch.bfloat16,
                quant=quant)
            print(f"[chip_smoke] gate B={batch} bf16 quant={quant}: checked "
                  f"{checked} ok {ok} agree {agree:.3f}")
            if not (checked > 0 and ok):
                raise AssertionError(f"batched gate failed: B={batch}, "
                                     f"quant={quant}")

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

    before = k2.launches
    serve_cli.main(["--random-init", "--device", "cuda", "--batch-size", "8",
                    "--max-new-tokens", "64"])
    if k2.launches == before:
        raise AssertionError("serve CLI did not run the batched kernel")
    return serve_launches


FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")


def flash_counters():
    from pydynet_tpu_torch.ops import flash_attention as fa

    return [getattr(fa, name) for name in FLASH_KERNELS]


def flash_inputs(B, L, dtype, seed=0):
    """Seeded q, k, v and dO, (B, L, 6, 48) on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((B, L, CFG["n_heads"], 48), generator=g,
                        device="cuda").to(dtype) for _ in range(4)]


def flash_vs_plain(B, L, dtype, seed=0):
    """K3 and both K4 kernels against their plain versions on the same
    inputs (the backward ones given the kernel forward's o and lse). Raises
    beyond ``FLASH_ATOL``; returns {output: max |kernel - plain|}."""
    from pydynet_tpu_torch.ops import flash_attention as fa

    q, k, v, do = flash_inputs(B, L, dtype, seed)
    scale = 48 ** -0.5
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
            raise AssertionError(f"flash {name} B={B} L={L} {dtype}: max "
                                 f"error {float(err.max())} beyond "
                                 f"tolerance")
        errs[name] = float(err.max())
    return errs


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


def check_step_vs_cpu(gpu, cpu):
    """A model after one step on the card against the same step on the CPU:
    loss, gradients and weights within the stated tolerances. Returns the
    largest (gradient, weight) differences."""
    g_err = w_err = 0.0
    theirs = dict(cpu.named_parameters())
    for name, p in gpu.named_parameters():
        c = theirs[name]
        dg = float((p.grad.cpu() - c.grad).abs().max())
        dw = float((p.detach().cpu() - c.detach()).abs().max())
        if dg > TRAIN_GRAD_RTOL * float(c.grad.abs().max()) + 1e-12 \
                or dw > TRAIN_W_ATOL:
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
        for name, (kern, ref) in pairs.items():
            plain, kernel = time_step(ref, 10), time_step(kern, 50)
            kernel2, plain2 = time_step(kern, 50), time_step(ref, 10)
            ms[name, B] = (min(kernel, kernel2), min(plain, plain2))
            print(f"[chip_smoke] {card}: {name} f32 ({B}, {TRAIN_L}, 6, 48):"
                  f" kernel {ms[name, B][0] * 1e3:.1f} us, plain "
                  f"{ms[name, B][1] * 1e3:.1f} us")
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
    t0 = time.perf_counter()
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
    max_err = {}
    with torch.no_grad():
        for fmt, (dtype, _) in FORMATS.items():
            max_err[fmt] = 0.0
            for pos in POSITIONS:
                got, want, confident, err = kernel_vs_plain(model, fmt, pos)
                print(f"[chip_smoke] {fmt} pos {pos}: kernel {got} plain "
                      f"{want} confident {confident} cache err {err:.3g}")
                if err > CACHE_ATOL[dtype]:
                    raise AssertionError(f"{fmt} pos {pos}: cache error "
                                         f"{err} > {CACHE_ATOL[dtype]}")
                if got != want and (dtype == torch.float32 or confident):
                    raise AssertionError(f"{fmt} pos {pos}: kernel token "
                                         f"{got} != plain {want}")
                max_err[fmt] = max(max_err[fmt], err)
    phase("3 kernel vs plain", t0)

    # 3b. K2 against plain, and K2 rows against K1
    t0 = time.perf_counter()
    max_err_b = {}
    with torch.no_grad():
        for fmt, (dtype, _) in FORMATS.items():
            max_err_b[fmt] = 0.0
            for batch in BATCHES:
                for pos in BATCH_POSITIONS:
                    got, want, conf, err = batched_vs_plain(model, fmt,
                                                            batch, pos)
                    same = got == want
                    print(f"[chip_smoke] K2 {fmt} B={batch} pos {pos}: "
                          f"{int(same.sum())}/{batch} tokens equal, "
                          f"{int(conf.sum())} confident, cache err "
                          f"{err:.3g}")
                    if err > CACHE_ATOL[dtype]:
                        raise AssertionError(
                            f"K2 {fmt} B={batch} pos {pos}: cache error "
                            f"{err} > {CACHE_ATOL[dtype]}")
                    must = torch.ones_like(conf) if dtype == torch.float32 \
                        else conf
                    if not same[must].all():
                        raise AssertionError(
                            f"K2 {fmt} B={batch} pos {pos}: tokens "
                            f"{got.tolist()} != plain {want.tolist()}")
                    max_err_b[fmt] = max(max_err_b[fmt], err)
            equal, err = batched_rows_vs_k1(model, fmt)
            print(f"[chip_smoke] K2 {fmt} B=8 rows vs K1: tokens equal "
                  f"{equal}, cache err {err:.3g}")
            if not equal or err > CACHE_ATOL[dtype]:
                raise AssertionError(f"K2 {fmt}: rows differ from K1")
    phase("3b batched kernel vs plain", t0)

    # 4. the B=1 path
    t0 = time.perf_counter()
    steps = REQUEST - PROMPT.shape[1] - 1
    for quant in (None, "int8-head"):  # warm-up: weights, cuBLAS, kernels
        list(model.generate(PROMPT, PROMPT.shape[1] + 3,
                            dtype=torch.bfloat16, quant=quant))
    torch.cuda.synchronize()
    dsk.fused_decode_token.launches = 0
    for quant in (None, "int8-head"):
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
    truth, margins, tops = fidelity.greedy_truth(model, PROMPT, 64)
    for quant in (None, "int8-head"):
        checked, ok, agree = fidelity.gate_fused_argmax(
            model, PROMPT, truth, margins, tops, dtype=torch.bfloat16,
            quant=quant)
        print(f"[chip_smoke] gate bf16 quant={quant}: checked {checked} "
              f"ok {ok} agree {agree:.3f}")
        if not (checked > 0 and ok):
            raise AssertionError(f"fidelity gate failed for quant={quant}")
    before = dsk.fused_decode_token.launches
    infer.main(["--random-init", "--device", "cuda", "--max-new-tokens",
                "64"])
    if dsk.fused_decode_token.launches == before:
        raise AssertionError("infer CLI did not run the kernel")
    phase("4 main path", t0)

    # 4b. the serving path
    t0 = time.perf_counter()
    serve_launches = check_serving(model)
    phase("4b serving path", t0)

    # 4c. the training path
    t0 = time.perf_counter()
    train_launches, flash_err = check_training()
    phase("4c training path", t0)

    # 5. timings: kernels vs plain per step at pos 512, then end to end
    t0 = time.perf_counter()
    ms = {}
    with torch.no_grad():
        for fmt in ("bf16", "bf16-int8head"):
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
            ms[fmt] = (min(kernel, kernel2), min(plain, plain2))
            print(f"[chip_smoke] {card}: {fmt} step at pos 512: kernel "
                  f"{ms[fmt][0] * 1e3:.1f} us, plain {ms[fmt][1] * 1e3:.1f} "
                  f"us")
        w = model._fused_weights(torch.bfloat16, None)
        for batch in (8, 32):
            ck, cv = random_caches(model, torch.bfloat16, 1, batch)
            args, kw = batched_args(model, w, ck, cv, 512,
                                    range(100, 100 + batch))
            kern = lambda: dsk.fused_decode_token_batched(*args, **kw)
            ref = lambda: dsk.fused_decode_token_batched_ref(*args, **kw)
            plain, kernel = time_step(ref, 3), time_step(kern, 200)
            plain2, kernel2 = time_step(ref, 3), time_step(kern, 200)
            ms[f"K2 B={batch}"] = (min(kernel, kernel2), min(plain, plain2))
            print(f"[chip_smoke] {card}: K2 bf16 B={batch} step at pos 512: "
                  f"kernel {ms[f'K2 B={batch}'][0] * 1e3:.1f} us, plain "
                  f"{ms[f'K2 B={batch}'][1] * 1e3:.1f} us")
            del ck, cv
    tok_s = {None: [], "int8-head": []}
    for _ in range(REPEATS):  # the formats in turns
        for quant, rates in tok_s.items():
            start = time.perf_counter()
            n = sum(1 for _ in model.generate(PROMPT, REQUEST,
                                              dtype=torch.bfloat16,
                                              quant=quant))
            torch.cuda.synchronize()
            rates.append(n / (time.perf_counter() - start))
    for quant, rates in tok_s.items():
        name = f"bf16{'-' + quant if quant else ''}"
        print(f"[chip_smoke] {card}: generate {name} {REQUEST}-token "
              f"request, tok/s of {REPEATS} runs: "
              f"{', '.join(f'{r:.1f}' for r in rates)}; median "
              f"{float(np.median(rates)):.1f}")
    requests = serve_requests(model)
    serve_rates = {None: [], "int8-head": []}
    for _ in range(REPEATS):  # the formats in turns
        for quant, rates in serve_rates.items():
            start = time.perf_counter()
            _, done = serve(model, requests, dtype=torch.bfloat16,
                            quant=quant, **SERVE)
            rates.append(sum(len(r.tokens) for r in done)
                         / (time.perf_counter() - start))
    for quant, rates in serve_rates.items():
        name = f"bf16{'-' + quant if quant else ''}"
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
    phase("5 timings", t0)

    if "--profile" in sys.argv[1:]:
        t0 = time.perf_counter()
        profile(model, card)
        phase("6 profile", t0)

    print(json.dumps({"kernels": [
        {"name": "decode_token", "route": "cuda",
         "source": "pydynet_tpu_torch/csrc/decode_token.cu",
         "replaces": "pydynet_tpu/ops/decode_step.py:160",
         "launches": main_launches, "max_abs_err": max_err["f32"],
         "ms": ms["bf16"][0], "plain_ms": ms["bf16"][1]},
        {"name": "decode_token_batched", "route": "cuda",
         "source": "pydynet_tpu_torch/csrc/decode_token_batched.cu",
         "replaces": "pydynet_tpu/ops/decode_step.py:509",
         "launches": serve_launches, "max_abs_err": max_err_b["f32"],
         "ms": ms["K2 B=8"][0], "plain_ms": ms["K2 B=8"][1]}] + [
        {"name": name, "route": "cuda",
         "source": "pydynet_tpu_torch/csrc/flash_attention.cu",
         "replaces": f"pydynet_tpu/ops/flash_attention.py:{line}",
         "launches": train_launches[name], "max_abs_err": flash_err[name],
         "ms": ms[name, 1][0], "plain_ms": ms[name, 1][1]}
        for name, line in zip(FLASH_KERNELS, (82, 192, 259))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
