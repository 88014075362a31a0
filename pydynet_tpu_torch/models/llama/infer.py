"""Llama decode from the command line (port of ``llm/llama/infer.py``):

    python -m pydynet_tpu_torch.models.llama.infer --random-init
    python -m pydynet_tpu_torch.models.llama.infer --weights stories15M.npz \
        --tokenizer tokenizer.model.np --dtype bfloat16 --quant int8-head
    python -m pydynet_tpu_torch.models.llama.infer --random-init \
        --kv-quant int8
    python -m pydynet_tpu_torch.models.llama.infer --random-init \
        --temperature 0.8 --top-k 50 --top-p 0.9 --seed 7
    python -m pydynet_tpu_torch.models.llama.infer --random-init --beams 4
    python -m pydynet_tpu_torch.models.llama.infer --random-init \
        --speculative --draft-k 7 --ngram 3

``--device cuda`` (the default) needs a GPU and raises without one;
``--device cpu`` runs the kernels' plain versions. Without a checkpoint the
stories15M configuration is built with random weights from the fixed seed
``WEIGHTS_SEED``; ``--n-heads`` sets a checkpoint's head count where its
shapes leave it ambiguous, and ``--finetuned`` loads a ``finetune --save``
npz over the weights. ``--kv-quant int8`` keeps the KV cache as int8 rows with
scales; on the fused lane it cannot be combined with ``--quant``
(``ValueError``, as in the JAX package's CLI), on the scan lane (a model the
fused kernels do not take) it composes with it. ``--temperature`` above 0
samples, with
``--top-k``, ``--top-p``, ``--repetition-penalty`` and the sampler's
``--seed`` (``Llama.generate``); 0 is greedy. ``--beams W`` (W > 1)
decodes by beam search (``Llama.generate_beam``) and ``--speculative`` by
prompt-lookup speculative decoding (``Llama.generate_speculative``, with
``--draft-k``, ``--ngram`` and the sampling flags), both on the scan lane,
and print the text at the end, as the JAX package's CLI does. On a GPU one
untimed run builds the kernels first, unless ``--no-warmup`` asks to time
that too. Prints the text as it streams and then tokens per second.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ...device import resolve
from .io import infer_config, load_finetuned_parameters, load_model
from .model import Llama
from .tokenizer import Tokenizer

DIM = 288
N_LAYERS = 6
N_HEADS = 6
VOCAB_SIZE = 32000
MAX_SEQ_LEN = 1024
MAX_BATCH = 1
FFN_DIM = 768
WEIGHTS_SEED = 0  # the random weights' seed (``--seed`` seeds the sampler)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model(args, device) -> Llama:
    """The checkpoint's model (its head count from ``--n-heads`` where
    given), else stories15M with random weights; then ``--finetuned``'s
    parameters on top, as the JAX package's CLI loads them."""
    gen = torch.Generator().manual_seed(WEIGHTS_SEED)
    if os.path.exists(args.weights) and not args.random_init:
        cfg = infer_config(args.weights, MAX_SEQ_LEN, MAX_BATCH,
                           n_heads=args.n_heads)
        model = load_model(Llama(device=device, generator=gen, **cfg),
                           args.weights)
    else:
        print(f"[infer] checkpoint {args.weights!r} not used -> random "
              f"weights from seed {WEIGHTS_SEED}")
        model = Llama(VOCAB_SIZE, DIM, N_HEADS, FFN_DIM, MAX_SEQ_LEN,
                      MAX_BATCH, N_LAYERS, device=device, generator=gen)
    if args.finetuned is not None:
        model = load_finetuned_parameters(model, args.finetuned)
    return model


def add_model_flags(parser) -> None:
    """The flags :func:`build_model` reads, shared with ``serve_cli``."""
    parser.add_argument("--weights", type=str,
                        default="llm/llama/data/stories15M.model.npz")
    parser.add_argument("--random-init", action="store_true")
    parser.add_argument("--finetuned", type=str, default=None,
                        help="npz of fine-tuned parameters (``finetune "
                             "--save``) loaded over the weights")
    parser.add_argument("--n-heads", type=int, default=None,
                        help="the checkpoint's head count, where its "
                             "shapes leave it ambiguous")


def main(argv=None) -> float:
    parser = argparse.ArgumentParser(description="Llama decode")
    parser.add_argument("--prompt", type=str, default="There was a boy")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    add_model_flags(parser)
    parser.add_argument("--tokenizer", type=str,
                        default="llm/llama/data/tokenizer.model.np")
    parser.add_argument("--max-new-tokens", type=int, default=1024,
                        help="bound on the total length, prompt included")
    parser.add_argument("--dtype", choices=list(DTYPES), default="float32")
    parser.add_argument("--quant", choices=["int8-head", "int8", "int4"],
                        default=None,
                        help="int8-head: the lm_head as int8; int8/int4: "
                             "every matmul weight (the fused kernel at "
                             "stories15M width)")
    parser.add_argument("--kv-quant", choices=["int8"], default=None,
                        help="int8 KV cache with per-row scales (the "
                             "batched kernel, at B=1 too; with --quant only "
                             "on the scan lane)")
    parser.add_argument("--chunk", type=int, default=None,
                        help="decode steps between reads back to the host")
    parser.add_argument("--temperature", type=float, default=0.0,
                        help="0 = greedy; > 0 samples (the kernel emits "
                             "the logits, the sampling stage draws)")
    parser.add_argument("--top-k", type=int, default=None)
    parser.add_argument("--top-p", type=float, default=None)
    parser.add_argument("--seed", type=int, default=0,
                        help="the sampler's seed")
    parser.add_argument("--repetition-penalty", type=float, default=None,
                        help="HF-style penalty (> 1) on the tokens seen so "
                             "far (sampling only)")
    parser.add_argument("--beams", type=int, default=1,
                        help="> 1: beam-search decoding (prints the best "
                             "sequence at the end)")
    parser.add_argument("--speculative", action="store_true",
                        help="prompt-lookup speculative decoding (the greedy "
                             "stream unchanged; repeated text decodes "
                             "several tokens a dispatch)")
    parser.add_argument("--draft-k", type=int, default=7,
                        help="speculative draft length")
    parser.add_argument("--ngram", type=int, default=3,
                        help="speculative lookup n-gram size")
    parser.add_argument("--no-warmup", action="store_true",
                        help="include the kernels' build and first launches "
                             "in the timed run (default: one untimed "
                             "warm-up generate on a GPU first)")
    args = parser.parse_args(argv)

    device = resolve(args.device)
    tokenizer = Tokenizer(args.tokenizer)
    model = build_model(args, device).eval()
    gen_kwargs = {"dtype": DTYPES[args.dtype], "quant": args.quant,
                  "kv_quant": args.kv_quant}
    if args.chunk:
        gen_kwargs["chunk"] = args.chunk
    if args.temperature > 0:
        gen_kwargs.update(temperature=args.temperature, top_k=args.top_k,
                          top_p=args.top_p, seed=args.seed,
                          repetition_penalty=args.repetition_penalty)
    input_ids = np.array([tokenizer.encode(args.prompt)])
    L = input_ids.shape[1]
    warm = device.type == "cuda" and not args.no_warmup
    if args.beams > 1 or args.speculative:
        return _decode_whole(model, tokenizer, input_ids, args, warm)
    if warm:
        # build the kernels outside the timed run
        for _ in model.generate(input_ids, L + 2, **gen_kwargs):
            pass
    print(f"\n{args.prompt}", end="")
    start = time.perf_counter()
    for token in model.generate(input_ids, args.max_new_tokens,
                                **gen_kwargs):
        L += 1
        tid = int(token[0, 0])
        if tid in (tokenizer.eos_id, tokenizer.bos_id):
            break
        print(tokenizer.decode([tid]), end="")
        sys.stdout.flush()
    elapsed = time.perf_counter() - start
    print(f"\n\nToken count: {L}, elapsed: {elapsed:.2f}s, "
          f"{round(L / elapsed)} tokens/s")
    return L / elapsed


def _decode_whole(model, tokenizer, input_ids, args, warm: bool) -> float:
    """``--beams`` and ``--speculative``: decode the whole request (after one
    untimed run when ``warm``), print its text and the JAX package's CLI's
    summary line; returns tokens per second."""
    L = input_ids.shape[1]
    dtype = DTYPES[args.dtype]
    if args.beams > 1:
        def run():
            return model.generate_beam(input_ids, args.max_new_tokens,
                                       num_beams=args.beams,
                                       eos_id=tokenizer.eos_id, dtype=dtype)
    else:
        def run():
            return model.generate_speculative(
                input_ids, args.max_new_tokens, draft_k=args.draft_k,
                ngram=args.ngram, dtype=dtype,
                temperature=args.temperature or 0.0, top_k=args.top_k,
                top_p=args.top_p, seed=args.seed)
    if warm:
        run()
    print(f"\n{args.prompt}", end="")
    start = time.perf_counter()
    result = run()
    elapsed = time.perf_counter() - start
    if args.beams > 1:
        out, note = result, f"beam={args.beams}"
    else:
        toks, stats = result
        out = []
        for t in toks.tolist():
            if t in (tokenizer.eos_id, tokenizer.bos_id):
                break
            out.append(t)
        note = (f"{stats['tokens_per_dispatch']:.2f} tokens/dispatch, "
                f"{stats['accepted_drafts']} drafts accepted")
    print(tokenizer.decode(out))
    n = L + len(out)
    print(f"\nToken count: {n}, elapsed: {elapsed:.2f}s, "
          f"{round(n / elapsed)} tokens/s ({note})")
    return n / elapsed


if __name__ == "__main__":
    main()
