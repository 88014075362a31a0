"""Continuous-batching serving from the command line (port of
``llm/llama/serve.py``): submit many prompts, decode them in lockstep on the
batched decode kernel (or the scan lane) with slot recycling, and report
aggregate throughput.

    python -m pydynet_tpu_torch.models.llama.serve_cli --random-init \\
        --prompt "There was a boy" --prompt "Once upon a time" \\
        --batch-size 8 --max-new-tokens 256

``--device cuda`` (the default) needs a GPU and raises without one;
``--device cpu`` runs the kernels' plain versions. Without a checkpoint the
stories15M configuration is built with random weights from a fixed seed
(``infer.WEIGHTS_SEED``); ``--n-heads`` and ``--finetuned`` act as in
``infer``. ``--temperature`` above 0 makes the server
sample, with ``--top-k``, ``--top-p`` and the unseeded requests' ``--seed``
(``LlamaServer``); 0 is greedy.
``--prompts-file`` reads one prompt per line; ``--stream`` prints tokens as
chunks are read back; ``--quant int8-head`` stores the lm_head as int8,
``int8``/``int4`` every matmul weight; ``--kv-quant int8`` keeps the fleet's
KV caches as int8 rows with per-row scales (the fused lane; mutually
exclusive with ``--quant``, a ``ValueError``). ``--lane`` picks the decode
engine, ``fused`` (the batched decode kernel) or ``xla`` (the scan lane); by
default it is routed as ``Llama.generate`` routes.
"""
from __future__ import annotations

import argparse
import sys
import time

from ...device import resolve
from .infer import DTYPES, add_model_flags, build_model
from .serve import LlamaServer
from .tokenizer import Tokenizer

DEFAULT_PROMPTS = [
    "There was a boy",
    "Once upon a time",
    "The little red hen",
    "One day a dog",
]


def main(argv=None) -> float:
    parser = argparse.ArgumentParser(
        description="Batch-serve prompts on the continuous-batching decode "
        "server")
    parser.add_argument("--prompt", action="append", default=None,
                        help="repeatable; defaults to a small built-in set")
    parser.add_argument("--prompts-file", type=str, default=None,
                        help="file with one prompt per line (appended to "
                        "any --prompt flags)")
    parser.add_argument("--batch-size", type=int, default=8,
                        help="decode slots (requests in flight)")
    parser.add_argument("--chunk", type=int, default=128,
                        help="decode steps per dispatch")
    parser.add_argument("--max-new-tokens", type=int, default=256)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    add_model_flags(parser)
    parser.add_argument("--tokenizer", type=str,
                        default="llm/llama/data/tokenizer.model.np")
    parser.add_argument("--temperature", type=float, default=0.0,
                        help="0 = greedy; > 0 samples")
    parser.add_argument("--top-k", type=int, default=None)
    parser.add_argument("--top-p", type=float, default=None)
    parser.add_argument("--seed", type=int, default=0,
                        help="the server's sampling seed")
    parser.add_argument("--dtype", choices=list(DTYPES), default="bfloat16")
    parser.add_argument("--quant", choices=["int8-head", "int8", "int4"],
                        default=None)
    parser.add_argument("--kv-quant", choices=["int8"], default=None,
                        help="int8 KV cache on the fused lane (mutually "
                        "exclusive with --quant)")
    parser.add_argument("--lane", choices=["fused", "xla"], default=None,
                        help="decode engine (default: routed as generate "
                        "routes: the fused kernels where they take the "
                        "model and format, else the scan lane)")
    parser.add_argument("--stream", action="store_true",
                        help="print tokens as chunks are read back "
                        "(LlamaServer.stream) instead of completions at the "
                        "end")
    args = parser.parse_args(argv)

    prompts = list(args.prompt or [])
    if args.prompts_file:
        with open(args.prompts_file) as f:
            prompts += [ln.strip() for ln in f if ln.strip()]
    if not prompts:
        prompts = list(DEFAULT_PROMPTS)

    device = resolve(args.device)
    tokenizer = Tokenizer(args.tokenizer)
    model = build_model(args, device).eval()
    srv = LlamaServer(model, batch_size=args.batch_size,
                      dtype=DTYPES[args.dtype], chunk=args.chunk,
                      eos_id=tokenizer.eos_id,
                      temperature=args.temperature, top_k=args.top_k,
                      top_p=args.top_p, seed=args.seed, quant=args.quant,
                      kv_quant=args.kv_quant, lane=args.lane)
    encoded = [tokenizer.encode(p) for p in prompts]
    rids = [srv.submit(ids, max_new_tokens=args.max_new_tokens)
            for ids in encoded]
    start = time.perf_counter()
    if args.stream:
        for rid, toks in srv.stream():
            out = [t for t in toks
                   if t not in (tokenizer.eos_id, tokenizer.bos_id)]
            if out:
                print(f"[{rid}] {tokenizer.decode(out)}", flush=True)
        done = srv._finished
    else:
        done = srv.run()
    elapsed = time.perf_counter() - start

    total = 0
    for rid, prompt, ids in zip(rids, prompts, encoded):
        req = done[rid]
        total += len(ids) + len(req.tokens)
        out = []
        for t in req.tokens:
            if t in (tokenizer.eos_id, tokenizer.bos_id):
                break
            out.append(t)
        flag = " [truncated]" if req.truncated else ""
        print(f"--- [{rid}] {prompt}{tokenizer.decode(out)}{flag}")
        sys.stdout.flush()
    print(f"\nRequests: {len(rids)}, total tokens: {total}, "
          f"elapsed: {elapsed:.2f}s, "
          f"{round(total / elapsed)} tokens/s aggregate")
    return total / elapsed


if __name__ == "__main__":
    main()
