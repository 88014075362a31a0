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
* K2's head stage (the final RMSNorm, the (B, 288) x (288, 32000) head and
  bias, and the argmax tiles or the emitted logits) at stories15M's head,
  B = 8 and 32, bf16 and int8-head, emit and argmax mode: device time of
  the step's kernels named ``head`` by ``torch.profiler``, beside
  ``F.linear(h, head_w, head_b)`` and ``torch.argmax(F.linear(...), -1)``
  on the same bf16 head; K1's head (B = 1) the same way;
* K2's whole bf16 B = 8 step at pos 512, emit and argmax mode, by CUDA
  events.

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


CFG = dict(vocab_size=32000, embed_dim=288, n_heads=6, ffn_dim=768,
           max_seq_len=1024, max_batch_size=1, n_layers=6)  # stories15M
POS = 512


def head_us(step, n=20):
    """Device us a call of ``step`` spends in kernels named ``head``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "head" in e.name) / n


def decode_times() -> dict:
    """K1's and K2's head stages and K2's B = 8 step (module doc)."""
    import torch
    import torch.nn.functional as F
    from pydynet_tpu_torch.models.llama import Llama
    from pydynet_tpu_torch.models.llama.model import (decode_quant_kwargs,
                                                      decode_weight_args)
    from pydynet_tpu_torch.ops import decode_step as dsk

    model = Llama(**CFG, device="cuda",
                  generator=torch.Generator().manual_seed(0)).eval()
    g = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    i32 = lambda xs: torch.tensor(xs, dtype=torch.int32, device="cuda")
    for quant in (None, "int8-head"):
        w = model._fused_weights(torch.bfloat16, quant)
        kw = dict(n_heads=model.n_heads, **decode_quant_kwargs(w))
        fmt = "bf16" if quant is None else "int8-head"
        for B in (1, 8, 32):
            shape = (model.n_layers, model.max_seq_len, model.embed_dim)
            if B > 1:
                shape = shape[:1] + (B,) + shape[1:]
            ck, cv = (torch.randn(shape, generator=g, device="cuda")
                      .mul_(0.5).to(torch.bfloat16) for _ in range(2))
            args = (i32([POS]), i32(list(range(100, 100 + B))),
                    *decode_weight_args(w), ck, cv)
            k = dsk.fused_decode_token if B == 1 else \
                dsk.fused_decode_token_batched
            name = "K1" if B == 1 else f"K2 B={B}"
            for emit in (False, True):
                mode = "emit" if emit else "argmax"
                step = lambda: k(*args, emit_logits=emit, **kw)
                out[f"{name} head {fmt} {mode}"] = head_us(step)
                if B == 8 and quant is None:
                    out[f"K2 B=8 step bf16 {mode}"] = events_us(step, 200)
            del ck, cv
    w = model._fused_weights(torch.bfloat16, None)
    for B in (1, 8, 32):
        h = torch.randn(B, model.embed_dim, generator=g, device="cuda").to(
            torch.bfloat16)
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
    for key in (k for k in runs[0] if k not in ("tree", "card")):
        print(f"{key}: {other} {runs[0][key]:.1f} / {runs[3][key]:.1f} us, "
              f"this checkout {runs[1][key]:.1f} / {runs[2][key]:.1f} us")
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
