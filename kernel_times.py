"""Time K6 (the int8/int4 prefill matmul) and K4 (the flash-attention
backward) of the port on the card, for this checkout or another one, and
compare two checkouts in turns on one card.

    python3 kernel_times.py                      # this checkout
    python3 kernel_times.py --tree DIR           # the checkout at DIR
    python3 kernel_times.py --compare DIR        # DIR, this, this, DIR

Each run imports ``pydynet_tpu_torch`` from its checkout (which builds its
own kernels into its ``build/``), times ``qmatmul`` on (4096, 22016)
Llama-2-7B gate/up weights at M = 256 rows by CUDA-graph replay (int8 and
int4), and the two K4 wrappers on float32 (B, 1024, 6, 48) at B = 1 and 8
by CUDA events, and prints one JSON line of microseconds with the card's
name and power limit. ``--compare`` runs the two checkouts in separate
processes, in the order DIR, this, this, DIR, and prints each kernel's
times side by side. Needs a CUDA GPU.
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
        out[f"K4 dq f32 ({B}, 1024, 6, 48)"] = events_us(
            lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, dd))
        out[f"K4 dk/dv f32 ({B}, 1024, 6, 48)"] = events_us(
            lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, dd))
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
