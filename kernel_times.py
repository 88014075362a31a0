"""Time the port's redesigned kernels on the card, for this checkout or
another one, and compare two checkouts in turns on one card.

    python3 kernel_times.py                      # this checkout
    python3 kernel_times.py --tree DIR           # the checkout at DIR
    python3 kernel_times.py --compare DIR        # DIR, this, this, DIR

Each run imports ``pydynet_tpu_torch`` from its checkout (which builds its
own kernels into its ``build/``) and times, with the card's name and power
limit in one JSON line of microseconds:

* K6: ``qmatmul`` on (4096, 22016) Llama-2-7B gate/up weights at M = 256
  rows by CUDA-graph replay (int8 and int4);
* K3 and K4: the flash forward and the two backward wrappers on float32
  (B, 1024, 6, 48) at B = 1 and 8 by CUDA events, beside
  ``F.scaled_dot_product_attention(is_causal=True)``'s forward;
* K1's and K2's steps at stories15M width, pos 512, seeded random weights
  and caches: K1 in bf16, int8 and int4 (layers and head), K2 in bf16 at
  B = 8, 32 and 64 and in int8, int4 and the int8 KV cache at B = 8, and
  the bf16 emit_logits mode of K1 and of K2 at B = 8 and 64. For each, the
  step by CUDA events, the device time of each stage by ``torch.profiler``
  kernel name (q/k/v, attention, wo, gate/up, down, head, argmax; before
  the layer stages moved to the tensor cores the wo kernel, `attn_out`,
  also merged the attention partials) over 20 steps, and the kernels a
  step;
* ``F.linear(h, head_w, head_b)`` and ``torch.argmax(F.linear(...), -1)``
  on the bf16 head at B = 1, 8 and 32, the head stage's yardsticks.

``--compare`` runs the two checkouts in separate processes, in the order
DIR, this, this, DIR, and prints each time side by side. Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
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


def measure(tree: Path) -> dict:
    """The kernels of the checkout at ``tree``, timed on the card."""
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
    for q4 in (False, True):
        w = torch.randint(-128, 128, (2048 if q4 else 4096, 22016),
                          generator=g, device="cuda", dtype=torch.int8)
        ws = torch.rand((1, 22016), generator=g, device="cuda") * 1e-3
        out[f"K6 {'int4' if q4 else 'int8'} (4096, 22016) M=256"] = \
            graph_us(lambda: gq.qmatmul(x, w, ws, q4=q4))
        del w, ws
    for B in (1, 8):
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
    out.update(decode_times())
    return out


POS = 512
# (label, K1 format or K2 format, B; None: K1) of the timed decode steps
DECODE_CASES = (("K1 bf16", "bf16", None), ("K1 int8", "bf16-int8", None),
                ("K1 int4", "bf16-int4", None),
                ("K2 bf16 B=8", "bf16", 8), ("K2 bf16 B=32", "bf16", 32),
                ("K2 bf16 B=64", "bf16", 64), ("K2 int8 B=8", "bf16-int8", 8),
                ("K2 int4 B=8", "bf16-int4", 8), ("K2 kv8 B=8", "bf16-kv8", 8))
EMIT_CASES = ("K1 bf16", "K2 bf16 B=8", "K2 bf16 B=64")
# a step's stages by kernel name, for these kernels and the CUDA-core ones
# before them (whose wo kernel, attn_out, also merged the attention)
STAGES = (("q/k/v", "qkv"), ("wo", "attn_out"), ("wo", "layer_wo"),
          ("attention", "attention"), ("gate/up", "gate_up"),
          ("down", "down"), ("head", "head"), ("argmax", "argmax"))


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


def compare(other: Path) -> None:
    runs = []
    for tree in (other, HERE, HERE, other):
        proc = subprocess.run([sys.executable, __file__, "--tree",
                               str(tree)], capture_output=True, text=True)
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
    args = ap.parse_args(argv)
    if args.compare is not None:
        compare(args.compare.resolve())
    else:
        print(json.dumps(measure(args.tree.resolve())))


if __name__ == "__main__":
    main()
