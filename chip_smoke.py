#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Run from the repository root on a machine with one CUDA GPU, nvcc and
PyTorch built for CUDA. Phases, each printed as it ends; any failure ends
the run with a nonzero exit and no result line:

1. the device, and ``nvidia-smi``'s name and power limit;
2. build the CUDA kernels from ``pydynet_tpu_torch/csrc`` (timed; says
   whether the library for these sources was already built);
3. the decode-step kernel against its plain PyTorch version at stories15M
   width with seeded random weights, in float32, bfloat16 and bfloat16 with
   the int8 head, at positions 0, 1, 17, 255, 1023 and 1030 (the last one
   exercises the clamp to S - 1);
4. the main path: ``Llama.generate`` of a 1024-token request in bfloat16,
   with and without ``quant="int8-head"``, through the kernel (its launch
   counter must equal the decode steps), the confident-step argmax gate
   against a float32 truth stream, and the ``infer`` CLI once;
5. timings: tokens per second of the 1024-token request in each format,
   timed ``REPEATS`` times in turns, and the kernel's time per step beside
   the plain version's, with the card's name and power limit;
6. only with ``--profile``: the step by CUDA events and the host's enqueue
   time per call at positions 0, 512 and 1023, the device time of each
   kernel of the chain from ``torch.profiler``, and the device's busy share
   of a 1024-token request under the profiler.

The last two lines of standard output are a JSON object describing the
kernel and then ``{"ok": true, "device": {...}}``.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

CFG = dict(vocab_size=32000, embed_dim=288, n_heads=6, ffn_dim=768,
           max_seq_len=1024, max_batch_size=1, n_layers=6)  # stories15M
POSITIONS = (0, 1, 17, 255, 1023, 1030)
FORMATS = {"f32": (torch.float32, None), "bf16": (torch.bfloat16, None),
           "bf16-int8head": (torch.bfloat16, "int8-head")}
# cache tolerance, kernel vs plain: f32 differs only in summation order
# (values are O(1), so 1e-4 is ~1000 f32 ulps); bf16 rows may round to a
# neighbouring bf16 value (one ulp at |x| < 8 is at most 2**-5)
CACHE_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-5}
PROMPT = np.array([[1, 243, 532, 991]])
REQUEST = 1024  # total length of the main-path request
REPEATS = 5  # timed requests per format in phase 5


def phase(name, t0):
    print(f"[chip_smoke] phase {name}: ok ({time.perf_counter() - t0:.1f} s)",
          flush=True)


def step_args(model, weights, ck, cv, pos, tok):
    dev = model.device
    qhead = "head_s" in weights
    return ((torch.tensor([pos], dtype=torch.int32, device=dev),
             torch.tensor([tok], dtype=torch.int32, device=dev),
             weights["tok"], weights["cosD"], weights["sinD"],
             weights["norm"], weights["wq"], weights["wk"], weights["wv"],
             weights["wo"], weights["gate_w"], weights["up_w"],
             weights["down"], weights["in_norm"], weights["post_norm"],
             weights["head_wq"] if qhead else weights["head_w"],
             weights["head_b"], ck, cv),
            dict(n_heads=model.n_heads, head_s=weights.get("head_s")))


def random_caches(model, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    shape = (model.n_layers, model.max_seq_len, model.embed_dim)
    return [torch.randn(shape, generator=g).mul_(0.5).to(model.device, dtype)
            for _ in range(2)]


def kernel_vs_plain(model, fmt, pos, tok=1234, seed=0):
    """One decode step through the kernel and through the plain version on
    the same inputs. Returns (kernel token, plain token, plain logits,
    max |cache difference|)."""
    from pydynet_tpu_torch.ops import decode_step as dsk
    from pydynet_tpu_torch.utils.fidelity import REL_MARGIN, MARGIN

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
    err = max(float((ck.float() - rck.float()).abs().max()),
              float((cv.float() - rcv.float()).abs().max()))
    srt = torch.sort(logits).values
    top, margin = float(srt[-1]), float(srt[-1] - srt[-2])
    confident = margin > MARGIN + REL_MARGIN * abs(top)
    return got, want, confident, err


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


def profile(model, card):
    """Phase 6: where a decode step's time goes on the card."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from pydynet_tpu_torch.ops import decode_step as dsk

    print(f"[chip_smoke] profile on {card}")
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
            n = 50
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    dsk.fused_decode_token(*args, **kw)
                torch.cuda.synchronize()
            by_name = {}
            for e in kernel_events(prof):
                t, c = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
            total = sum(t for t, _ in by_name.values()) / n
            print(f"[chip_smoke] profile {fmt} pos 512, device time by "
                  f"kernel over {n} steps:")
            for name, (t, c) in sorted(by_name.items(),
                                       key=lambda kv: -kv[1][0]):
                print(f"[chip_smoke]   {t / n:8.2f} us/step "
                      f"{100 * t / n / total:5.1f} % x{c // n}  {name[:70]}")
            print(f"[chip_smoke]   device total {total:.1f} us/step")
        for quant in (None, "int8-head"):
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                start = time.perf_counter()
                n = sum(1 for _ in model.generate(PROMPT, REQUEST,
                                                  dtype=torch.bfloat16,
                                                  quant=quant))
                torch.cuda.synchronize()
                wall = time.perf_counter() - start
            spans = sorted((e.time_range.start, e.time_range.end)
                           for e in kernel_events(prof))
            busy, end = 0.0, float("-inf")
            for a, b in spans:  # length of the union of kernel intervals
                busy += max(0.0, b - max(a, end))
                end = max(end, b)
            busy /= 1e6
            print(f"[chip_smoke] profile generate bf16 quant={quant} under "
                  f"the profiler: {n} tokens in {wall:.3f} s, device busy "
                  f"{busy:.3f} s = {100 * busy / wall:.1f} %, idle "
                  f"{100 - 100 * busy / wall:.1f} %")


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

    # 3. kernel against plain at stories15M width
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

    # 4. main path
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

    # 5. timings, kernel vs plain per step at pos 512 (bf16, main format)
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
    phase("5 timings", t0)

    if "--profile" in sys.argv[1:]:
        t0 = time.perf_counter()
        profile(model, card)
        phase("6 profile", t0)

    print(json.dumps({"kernels": [{
        "name": "decode_token", "route": "cuda",
        "source": "pydynet_tpu_torch/csrc/decode_token.cu",
        "replaces": "pydynet_tpu/ops/decode_step.py:160",
        "launches": main_launches, "max_abs_err": max_err["f32"],
        "ms": ms["bf16"][0], "plain_ms": ms["bf16"][1]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
