"""Llama fine-tuning from the command line (port of
``llm/llama/finetune.py``):

    python -m pydynet_tpu_torch.models.llama.finetune --random-init \\
        --text "Once upon a time" --trainable tok_embedding,layers,norm,lm_head
    python -m pydynet_tpu_torch.models.llama.finetune --weights stories15M.npz \\
        --tokenizer tokenizer.model.np --text "..." --steps 30 --lr 1e-4
    python -m pydynet_tpu_torch.models.llama.finetune --random-init \\
        --text "..." --lora 8 --lora-targets Q,K,V,O --lora-dropout 0.05

Full-parameter or prefix-frozen fine-tuning with Adam on one shifted
(input, target) pair of the text, in float32; or, with ``--lora R``, rank-R
LoRA adapters on the Linears named by ``--lora-targets`` (``Llama.add_lora``,
every other parameter frozen; ``--trainable`` is then ignored), their
dropout drawn from the JAX package's threefry stream. ``--device cuda`` (the
default) needs a GPU and raises without one; there attention runs through
the flash-attention kernels. ``--device cpu`` runs their plain versions.
Without a checkpoint the stories15M configuration is built with random
weights from ``--seed``. Prints the loss at step 1, every 5th step and the
last, then saves the trainable parameters, a LoRA run's adapters only (JAX
package layout, so the file loads into both packages).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ...device import resolve
from ...optim import Adam
from .infer import build_model
from .io import save_finetuned_parameters
from .tokenizer import Tokenizer


def build_causal_training_pair(tokenizer: Tokenizer, text: str,
                               max_seq_len: int):
    """The shifted (input, target) pair of ``text``, each (1, L) int64,
    at most ``max_seq_len`` tokens."""
    token_ids = tokenizer.encode(text, add_bos=True, add_eos=True)
    token_ids = token_ids[:max_seq_len + 1]
    if len(token_ids) < 2:
        raise ValueError("Training text is too short after tokenization.")
    input_ids = np.array([token_ids[:-1]], dtype=np.int64)
    target_ids = np.array([token_ids[1:]], dtype=np.int64)
    return input_ids, target_ids


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description="Fine-tune Llama parameters")
    parser.add_argument("--text", type=str, required=True)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--trainable", type=str, default="lm_head",
                        help="Comma-separated parameter name prefixes")
    parser.add_argument("--lora", type=int, default=0, metavar="R",
                        help="Train rank-R LoRA adapters instead of full "
                        "matrices (overrides --trainable)")
    parser.add_argument("--lora-alpha", type=float, default=16.0)
    parser.add_argument("--lora-targets", type=str, default="Q,V",
                        help="Comma-separated Linear attribute names to "
                        "adapt (Q,K,V,O,gate,up,down,lm_head)")
    parser.add_argument("--lora-dropout", type=float, default=0.0)
    parser.add_argument("--save", type=str,
                        default="llm/llama/data/finetuned_params.npz")
    parser.add_argument("--weights", type=str,
                        default="llm/llama/data/stories15M.model.npz")
    parser.add_argument("--tokenizer", type=str,
                        default="llm/llama/data/tokenizer.model.np")
    parser.add_argument("--random-init", action="store_true")
    parser.add_argument("--clip-norm", type=float, default=None,
                        help="global-norm gradient clipping in each step")
    # build_model's other inputs: the JAX package's finetune CLI has no
    # --finetuned or --n-heads
    parser.set_defaults(finetuned=None, n_heads=None)
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights")
    args = parser.parse_args(argv)

    device = resolve(args.device)
    tokenizer = Tokenizer(args.tokenizer)
    model = build_model(args, device)
    if args.lora > 0:
        targets = tuple(t.strip() for t in args.lora_targets.split(",")
                        if t.strip())
        trainable_count, frozen_count = model.add_lora(
            r=args.lora, alpha=args.lora_alpha, targets=targets,
            dropout=args.lora_dropout)
    else:
        prefixes = tuple(p.strip() for p in args.trainable.split(",")
                         if p.strip())
        trainable_count, frozen_count = model.set_trainable_parameters(
            prefixes)
    print(f"Trainable params: {trainable_count}, Frozen params: "
          f"{frozen_count}")

    optimizer = Adam([p for p in model.parameters() if p.requires_grad],
                     lr=args.lr)
    input_ids, target_ids = build_causal_training_pair(
        tokenizer, args.text, model.max_seq_len)

    # print at step 1, every 5th and the last; the steps between two prints
    # run as one finetune_steps call, which reads nothing back
    boundaries = sorted({s for s in range(1, args.steps + 1)
                         if s == 1 or s % 5 == 0 or s == args.steps})
    start = time.perf_counter()
    done, printed = 0, []
    for b in boundaries:
        n = b - done
        losses = model.finetune_steps(input_ids, target_ids, optimizer, n,
                                      clip_norm=args.clip_norm)
        done = b
        printed.append(float(losses[n - 1]))
        print(f"step={done:04d}, loss={printed[-1]:.6f}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - start

    os.makedirs(os.path.dirname(args.save) or ".", exist_ok=True)
    save_finetuned_parameters(model, args.save)
    print(f"Saved finetuned params to {args.save}")
    print(f"Elapsed: {elapsed:.2f}s ({args.steps / elapsed:.2f} steps/s)")
    return printed


if __name__ == "__main__":
    main()
