"""Time the port's redesigned kernels on the card, for this checkout or
another one, and compare two checkouts in turns on one card.

    python3 kernel_times.py                      # this checkout
    python3 kernel_times.py --tree DIR           # the checkout at DIR
    python3 kernel_times.py --compare DIR        # DIR, this, this, DIR
    python3 kernel_times.py --compare DIR --request  # and the 7B request
    python3 kernel_times.py --compare DIR --only k8,k10  # some groups

Each run imports ``pydynet_tpu_torch`` from its checkout (which builds its
own kernels into its ``build/``) and times, with the card's name and power
limit in one JSON line of microseconds:

* K6: ``qmatmul`` on (4096, 22016) Llama-2-7B gate/up weights at M = 256
  rows by CUDA-graph replay (int8 and int4);
* K5/K7: the whole decode call at Llama-2-7B's five shapes (fused qkv, wo,
  fused gate/up, down: ``qmatmul_stacked`` over 32 stacked layers with a
  device index; the head: ``qmatmul`` over 4 copies), int8 and int4, M = 1
  and 4 bfloat16 rows, by CUDA-graph replay of a pass over the layers (so
  each call finds its weights cold in L2), with each shape's byte bound
  and, as a yardstick of the read rate the card reaches, a PyTorch
  reduction (``max``) over the same weight bytes as int32; where the
  checkout has routes to pick (``gemv_quant._ROUTES``), also, at every
  shape and M = 1 to 32, each route on the same rows: the decode kernel
  with its fused row quantization, with ``quantize_rows`` first, and
  ``quantize_rows`` with the prefill kernel (K6);
* K3 and K4: the flash forward and the two backward wrappers on float32
  (B, 1024, 6, 48) at B = 1 and 8 by CUDA events, beside
  ``F.scaled_dot_product_attention(is_causal=True)``'s forward;
* K1's and K2's steps at stories15M width, pos 512, seeded random weights
  and caches: K1 in bf16, int8 and int4 (layers and head) and f16, K2 in
  bf16 at B = 8, 32 and 64 and in int8, int4, the int8 KV cache and f16
  at B = 8, and
  the bf16 emit_logits mode of K1 and of K2 at B = 8 and 64. For each, the
  step by CUDA events, the device time of each stage by ``torch.profiler``
  kernel name (q/k/v, attention, wo, gate/up, down, head, argmax; before
  the layer stages moved to the tensor cores the wo kernel, `attn_out`,
  also merged the attention partials) over 20 steps, and the kernels a
  step;
* ``F.linear(h, head_w, head_b)`` and ``torch.argmax(F.linear(...), -1)``
  on the bf16 head at B = 1, 8 and 32, the head stage's yardsticks;
* K9 (``lm_head_argmax``) at stories15M's head (D 288, V 32000), a
  float32 h against float32 and bfloat16 weights (``chip_smoke.
  head_inputs``, the pairs chip_smoke.py times) and a bfloat16 h against
  bfloat16 weights: a call by CUDA-graph replay of 20 calls, each kernel's
  device time by ``torch.profiler`` name (head, argmax), the kernels a call,
  and ``torch.argmax(head_w @ h + b)`` timed the same way;
* K10 (``fused_decode_step``) at stories15M width, pos 512, in bf16 and
  f32 on ``chip_smoke.step_inputs``: the step by CUDA events and by
  CUDA-graph replay, each stage's device time by ``torch.profiler`` kernel
  name over 20 steps (q/k/v, attention, wo, gate/up, down, final norm;
  for a checkout whose step has them, rope, scores, softmax and p @ V),
  and the kernels a step;
* K8 (``batch_norm_train``) at ``chip_smoke.BN_TIME_SHAPES`` in f32 and
  bf16 (gamma and beta f32): a call by CUDA-graph replay of 20 calls,
  beside ``F.batch_norm(training=True)`` timed the same way and the byte
  bound (x read once, out written once);
* the dropout_bn train step (``dbn``): steps/s of 5 runs of 50 steps and
  the kernels a step (the dropout masks' draws among them).

With ``--request``, also a Llama-2-7B-geometry model (32 layers, bf16,
seeded random weights) on the scan lane: the B=1 request of 64 tokens from
a 4-token prompt in int8 and int4, the formats in turns, ms a token (the
request's wall time over its tokens) of 5 runs each: median, least and
most. It is host-bound, so it moves with the launches a token.

``--compare`` runs the two checkouts in separate processes, in the order
DIR, this, this, DIR, and prints each time side by side. Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()


def graph_us(fn, replays=20):
    """Device us of ``fn()`` captured once in a CUDA graph and replayed."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return events_us(graph.replay, replays)


def events_us(fn, n=50):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n * 1e3


# the --request timing: Llama-2-7B's geometry, a prompt, the tokens a
# request makes (the prefill's among them) and the timed runs a format
LLAMA2_7B = dict(vocab_size=32000, embed_dim=4096, n_heads=32, ffn_dim=11008,
                 max_seq_len=1024, max_batch_size=1, n_layers=32)
REQUEST_PROMPT = [[1, 243, 532, 991]]
REQUEST_NEW, REQUEST_RUNS = 64, 5


def request_times() -> dict:
    """The 7B request's ms a token on the scan lane (module doc)."""
    import numpy as np
    import torch
    from pydynet_tpu_torch.models.llama import Llama

    bf16 = torch.bfloat16
    model = Llama(**LLAMA2_7B, dtype=bf16, device="cuda",
                  generator=torch.Generator().manual_seed(0)).eval()
    prompt = np.array(REQUEST_PROMPT)
    total = prompt.shape[1] + REQUEST_NEW
    ms = {"int8": [], "int4": []}
    with torch.no_grad():
        for quant in ms:  # warm-up: the weight snapshots
            list(model.generate(prompt, prompt.shape[1] + 2, dtype=bf16,
                                quant=quant))
        for _ in range(REQUEST_RUNS):
            for quant, runs in ms.items():
                torch.cuda.synchronize()
                start = time.perf_counter()
                n = sum(1 for _ in model.generate(prompt, total, dtype=bf16,
                                                  quant=quant))
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - start) / n * 1e3)
    out = {}
    for quant, runs in ms.items():
        key = f"7B request {quant} ms a token"
        out[key + " median"] = float(np.median(runs))
        out[key + " least"], out[key + " most"] = min(runs), max(runs)
    del model
    torch.cuda.empty_cache()
    return out


GROUPS = ("k6", "flash", "qmm", "decode", "k9", "k10", "k8",
          "dbn")  # --only's


def measure(tree: Path, request: bool = False, only=GROUPS) -> dict:
    """The kernels of the checkout at ``tree``, timed on the card: the
    groups in ``only`` (K6; K3/K4; K5/K7; K1/K2 and the head's yardsticks;
    K9; K10; K8; the dropout_bn step)."""
    sys.path.insert(0, str(tree))
    import torch
    import torch.nn.functional as F
    from pydynet_tpu_torch.ops import _build
    from pydynet_tpu_torch.ops import flash_attention as fa
    from pydynet_tpu_torch.ops import gemv_quant as gq

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times.py needs a CUDA GPU")
    if Path(_build.__file__).resolve().parents[2] != tree.resolve():
        raise SystemExit(f"imported the port from {_build.__file__}, not "
                         f"from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    out = {"tree": str(tree), "card": card()}
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn((256, 4096), generator=g, device="cuda") * 3).to(
        torch.bfloat16)
    for q4 in (False, True) if "k6" in only else ():
        w = torch.randint(-128, 128, (2048 if q4 else 4096, 22016),
                          generator=g, device="cuda", dtype=torch.int8)
        ws = torch.rand((1, 22016), generator=g, device="cuda") * 1e-3
        out[f"K6 {'int4' if q4 else 'int8'} (4096, 22016) M=256"] = \
            graph_us(lambda: gq.qmatmul(x, w, ws, q4=q4))
        del w, ws
    for B in (1, 8) if "flash" in only else ():
        q, k, v, do = (torch.randn((B, 1024, 6, 48), generator=g,
                                   device="cuda") for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v)
        dd = fa.attention_dd(o, do)
        out[f"K3 f32 ({B}, 1024, 6, 48)"] = events_us(
            lambda: fa.flash_attention_fwd(q, k, v))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        out[f"SDPA forward f32 ({B}, 1024, 6, 48)"] = events_us(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True))
        out[f"K4 dq f32 ({B}, 1024, 6, 48)"] = events_us(
            lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, dd))
        out[f"K4 dk/dv f32 ({B}, 1024, 6, 48)"] = events_us(
            lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, dd))
    for group, times in (("k8", bn_times), ("dbn", dbn_times),
                         ("qmm", qmm_times),
                         ("decode", decode_times), ("k9", head_times),
                         ("k10", step_times)):
        if group in only:
            out.update(times())
    if request:
        out.update(request_times())
    return out


HBM_BYTES_S = 3.35e12  # an H100 SXM's memory rate
# Llama-2-7B's decode products: (name, K, N, stacked)
QMM_7B = (("wqkv", 4096, 12288, True), ("wo", 4096, 4096, True),
          ("wgu", 4096, 22016, True), ("down", 11008, 4096, True),
          ("head", 4096, 32000, False))
LAYERS, HEADS = 32, 4  # stacked layers, head copies cycled


def qmm_times() -> dict:
    """K5/K7's decode calls at Llama-2-7B's shapes (module doc): us a call
    and the byte bound (x, the weights and scales read once, the float32
    result written once), and each route's time where there are routes."""
    import torch
    from pydynet_tpu_torch.ops import gemv_quant as gq

    out = {}
    g = torch.Generator(device="cuda").manual_seed(3)
    routes = getattr(gq, "_ROUTES", ())  # a checkout with routes to pick
    for name, K, N, stacked in QMM_7B:
        for q4 in (False, True):
            fmt = "int4" if q4 else "int8"
            n = LAYERS if stacked else HEADS
            w = torch.randint(-128, 128, (n, K // 2 if q4 else K, N),
                              generator=g, device="cuda", dtype=torch.int8)
            ws = torch.rand((n, 1, N), generator=g, device="cuda") * 1e-3
            ids = torch.arange(n, dtype=torch.int32, device="cuda")
            wi = w.view(torch.int32)
            out[f"K5/K7 {fmt} {name} ({K}, {N}) torch read"] = graph_us(
                lambda: [wi[i].max() for i in range(n)]) / n
            rows = (1, 2, 3, 4, 6, 8, 16, 32) if routes else (1, 4)
            for M in rows:
                x = (torch.randn((M, K), generator=g, device="cuda") * 3).to(
                    torch.bfloat16)
                if stacked:
                    call = lambda i: gq.qmatmul_stacked(x, w, ws, ids[i],
                                                        q4=q4)
                else:
                    call = lambda i: gq.qmatmul(x, w[i], ws[i], q4=q4)
                key = f"K5/K7 {fmt} {name} ({K}, {N}) M={M}"
                if M in (1, 4):
                    out[key] = graph_us(
                        lambda: [call(i) for i in range(n)]) / n
                    out[key + " bound"] = (
                        x.numel() * 2 + w[0].numel() + 4 * N + 4 * M * N) \
                        / HBM_BYTES_S * 1e6
                for route in routes:
                    out[f"{key} {route}"] = graph_us(lambda: [
                        gq._product(x, w, ws, q4, ids[i], n, route)
                        if stacked else
                        gq._product(x, w[i], ws[i], q4, 0, 1, route)
                        for i in range(n)]) / n
            del w, ws
    return out


POS = 512
# (label, K1 format or K2 format, B; None: K1) of the timed decode steps
DECODE_CASES = (("K1 bf16", "bf16", None), ("K1 int8", "bf16-int8", None),
                ("K1 int4", "bf16-int4", None),
                ("K2 bf16 B=8", "bf16", 8), ("K2 bf16 B=32", "bf16", 32),
                ("K2 bf16 B=64", "bf16", 64), ("K2 int8 B=8", "bf16-int8", 8),
                ("K2 int4 B=8", "bf16-int4", 8), ("K2 kv8 B=8", "bf16-kv8", 8),
                ("K1 f16", "f16", None), ("K2 f16 B=8", "f16", 8))
EMIT_CASES = ("K1 bf16", "K2 bf16 B=8", "K2 bf16 B=64")
# a step's stages by kernel name, for these kernels and the CUDA-core ones
# before them (whose wo kernel, attn_out, also merged the attention)
STAGES = (("q/k/v", "qkv"), ("wo", "attn_out"), ("wo", "layer_wo"),
          ("wo", "step_wo"), ("attention", "attention"),
          ("gate/up", "gate_up"), ("down", "down"), ("head", "head"),
          ("argmax", "argmax"), ("final norm", "final_norm"),
          ("rope", "rope"), ("scores", "scores"), ("softmax", "softmax"),
          ("p @ V", "step_pv"))


def stage_of(kernel: str) -> str:
    """The stage of a kernel by its profiler name (the demangled signature,
    argument list dropped)."""
    name = kernel.replace("(anonymous namespace)::", "").split("(")[0]
    return next((stage for stage, key in STAGES if key in name), "other")


def stage_us(step, n=20):
    """Device us a call of ``step`` spends in each stage's kernels, and the
    kernels a call launches, by ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {}
    for e in events:
        stage = stage_of(e.name)
        out[stage] = out.get(stage, 0.0) + e.time_range.elapsed_us() / n
    out["kernels a step"] = len(events) / n
    return out


def decode_times() -> dict:
    """K1's and K2's steps and stages (module doc), and the head's
    yardsticks."""
    import torch
    import torch.nn.functional as F
    from chip_smoke import (CFG, batched_args, batched_caches, fmt_of,
                            random_caches, step_args)
    from pydynet_tpu_torch.models.llama import Llama
    from pydynet_tpu_torch.ops import decode_step as dsk

    model = Llama(**CFG, device="cuda",
                  generator=torch.Generator().manual_seed(0)).eval()
    out = {}
    with torch.no_grad():
        for label, fmt, B in DECODE_CASES:
            w = model._fused_weights(*fmt_of(fmt))
            if B is None:
                ck, cv = random_caches(model, fmt_of(fmt)[0], 1)
                args, kw = step_args(model, w, ck, cv, POS, 1234)
                k = dsk.fused_decode_token
            else:
                ck, cv = batched_caches(model, fmt, 1, B)
                args, kw = batched_args(model, w, ck, cv, POS,
                                        range(100, 100 + B))
                k = dsk.fused_decode_token_batched
            for emit in (False, True) if label in EMIT_CASES else (False,):
                name = label + (" emit" if emit else "")
                step = lambda: k(*args, emit_logits=emit, **kw)
                out[f"{name} step"] = events_us(step, 200)
                for stage, t in stage_us(step).items():
                    out[f"{name} {stage}"] = t
            del ck, cv
        w = model._fused_weights(torch.bfloat16, None)
        g = torch.Generator(device="cuda").manual_seed(1)
        for B in (1, 8, 32):
            h = torch.randn(B, model.embed_dim, generator=g,
                            device="cuda").to(torch.bfloat16)
            lin = lambda: F.linear(h, w["head_w"], w["head_b"])
            out[f"F.linear head bf16 B={B}"] = events_us(lin, 200)
            out[f"argmax(F.linear) head bf16 B={B}"] = events_us(
                lambda: torch.argmax(lin(), -1), 200)
    return out


def head_times() -> dict:
    """K9 at stories15M's head in three (h, w) type pairs (module doc)."""
    import torch
    from chip_smoke import CFG, head_inputs
    from pydynet_tpu_torch.models.llama import Llama
    from pydynet_tpu_torch.ops import decode_step as dsk

    model = Llama(**CFG, device="cuda",
                  generator=torch.Generator().manual_seed(0)).eval()
    out = {}
    with torch.no_grad():
        for name, dtype, hdt in (("f32", torch.float32, torch.float32),
                                 ("bf16", torch.bfloat16, torch.float32),
                                 ("bf16 h bf16", torch.bfloat16,
                                  torch.bfloat16)):
            h, w, b = head_inputs(model, dtype)
            h = h.to(hdt)
            key = f"K9 {name} ({w.shape[0]}, {w.shape[1]})"
            call = lambda: dsk.lm_head_argmax(h, w, b)
            out[key] = graph_us(lambda: [call() for _ in range(20)]) / 20
            for stage, t in stage_us(call).items():
                out[f"{key} {stage}"] = t
            hv = h[0].to(dtype)
            out[key + " torch.argmax(head_w @ h + b)"] = graph_us(
                lambda: [torch.argmax(w @ hv + b) for _ in range(20)]) / 20
    return out


def step_times() -> dict:
    """K10's step and stages in bf16 and f32 (module doc)."""
    import torch
    from chip_smoke import CFG, step_inputs
    from pydynet_tpu_torch.models.llama import Llama
    from pydynet_tpu_torch.ops import decode_step as dsk

    model = Llama(**CFG, device="cuda",
                  generator=torch.Generator().manual_seed(0)).eval()
    out = {}
    with torch.no_grad():
        for name, dtype in (("bf16", torch.bfloat16),
                            ("f32", torch.float32)):
            args = step_inputs(model, dtype, POS)
            step = lambda: dsk.fused_decode_step(*args)
            out[f"K10 {name} step"] = events_us(step, 200)
            out[f"K10 {name} graph"] = graph_us(step)
            for stage, t in stage_us(step).items():
                out[f"K10 {name} {stage}"] = t
    return out


def bn_times() -> dict:
    """K8 beside ``F.batch_norm`` at chip_smoke.BN_TIME_SHAPES (module
    doc), us a call, and its byte bound."""
    import torch
    import torch.nn.functional as F
    from chip_smoke import BN_TIME_SHAPES, bn_inputs
    from pydynet_tpu_torch.ops import batchnorm as bn

    out = {}
    with torch.no_grad():
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            for N, C in BN_TIME_SHAPES:
                x, gamma, beta = bn_inputs(N, C, dtype, 3)
                g, b = gamma.reshape(-1), beta.reshape(-1)
                key = f"K8 {name} ({N}, {C})"
                out[key] = graph_us(lambda: [
                    bn.batch_norm_train(x, gamma, beta)
                    for _ in range(20)]) / 20
                out[key + " F.batch_norm"] = graph_us(lambda: [
                    F.batch_norm(x, None, None, g, b, training=True,
                                 eps=1e-6) for _ in range(20)]) / 20
                out[key + " bound"] = (2 * x.numel() * x.element_size()
                                       + 16 * C) / HBM_BYTES_S * 1e6
    return out


def dbn_times(step=None, runs: int = 5) -> dict:
    """The dropout_bn train step of the three nets (``step``, by default
    ``chip_smoke.dbn_step_runner()`` of the checkout measured): steps/s of
    ``runs`` runs of 50 steps (median, least, most) and the kernels a step
    by ``torch.profiler`` over 10 steps. ``chip_smoke.py``'s phase 5 times
    the step with this function too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if step is None:
        from chip_smoke import dbn_step_runner
        step = dbn_step_runner()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            step()
        torch.cuda.synchronize()
    kernels = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    rates = []
    for _ in range(runs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(50):
            step()
        torch.cuda.synchronize()
        rates.append(50 / (time.perf_counter() - start))
    rates.sort()
    return {"dropout_bn steps/s median": rates[len(rates) // 2],
            "dropout_bn steps/s least": rates[0],
            "dropout_bn steps/s most": rates[-1],
            "dropout_bn kernels a step": kernels / 10}


def compare(other: Path, request: bool = False, only=GROUPS) -> None:
    runs = []
    for tree in (other, HERE, HERE, other):
        proc = subprocess.run([sys.executable, __file__, "--tree",
                               str(tree), "--only", ",".join(only)]
                              + ["--request"] * request,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"{tree}: {proc.stdout}{proc.stderr}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(runs[0]["card"])
    keys = [k for k in runs[1] if k not in ("tree", "card")]
    keys += [k for k in runs[0] if k not in keys + ["tree", "card"]]
    for key in keys:
        t = [f"{r[key]:.1f}" if key in r else "-" for r in runs]
        print(f"{key}: {other} {t[0]} / {t[3]}, this checkout {t[1]} / "
              f"{t[2]}")
    print(json.dumps({"parent": [runs[0], runs[3]],
                      "this": [runs[1], runs[2]]}))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--compare", type=Path)
    ap.add_argument("--request", action="store_true",
                    help="also time the 7B request (module doc)")
    ap.add_argument("--only", default=",".join(GROUPS),
                    help="comma-separated groups to time, of "
                         + ", ".join(GROUPS))
    args = ap.parse_args(argv)
    only = tuple(args.only.split(","))
    if not set(only) <= set(GROUPS):
        ap.error(f"--only: choose from {', '.join(GROUPS)}")
    if args.compare is not None:
        compare(args.compare.resolve(), args.request, only)
    else:
        print(json.dumps(measure(args.tree.resolve(), args.request, only)))


if __name__ == "__main__":
    main()
