"""CLIP fine-tuning from the command line (port of
``llm/clip/finetune.py``):

    python -m pydynet_tpu_torch.models.clip.finetune --image picture.png \\
        --labels "a fish,a dog,a cat" --target 2 [--steps 20] [--lr 1e-5] \\
        [--trainable text_encoder.proj,image_encoder.proj] \\
        [--lora R --lora-alpha 16 --lora-targets QKV,O] [--clip-norm C] \\
        [--save ft.npz] [--weights-dir DIR] [--random-init] \\
        [--device cuda|cpu]

The JAX CLI's flags, with ``--device`` in place of ``--no-cuda``. Adam over
the parameters named by ``--trainable`` (prefixes), or rank-R LoRA adapters
on the Linears named by ``--lora-targets`` with everything else frozen; one
``CLIP.finetune_step`` a step on the image against the labels, the right one
``--target``. Prints the trainable and frozen counts (as the JAX package
counts them), the loss at step 1, every 5th step and the last, then saves
the trainable parameters to ``--save`` in the JAX package's layout.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ...device import resolve
from ...optim import Adam
from .data import tokenize
from .infer import build_model, load_image
from .io import save_finetuned_parameters


def parse_labels(labels: str):
    vals = [x.strip() for x in labels.split(",") if x.strip()]
    if len(vals) < 2:
        raise ValueError(
            "Need at least 2 labels for classification fine-tuning.")
    return vals


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description="Fine-tune CLIP parameters")
    parser.add_argument("--image", type=str, required=True)
    parser.add_argument("--labels", type=str, required=True)
    parser.add_argument("--target", type=int, required=True)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--trainable", type=str,
                        default="text_encoder.proj,image_encoder.proj")
    parser.add_argument("--lora", type=int, default=0, metavar="R",
                        help="Train rank-R LoRA adapters instead of full "
                        "matrices (overrides --trainable)")
    parser.add_argument("--lora-alpha", type=float, default=16.0)
    parser.add_argument("--lora-targets", type=str, default="QKV,O",
                        help="Comma-separated Linear attribute names to "
                        "adapt (QKV,O,fc1,fc2,proj)")
    parser.add_argument("--save", type=str,
                        default="llm/clip/data/finetuned_clip_params.npz")
    parser.add_argument("--weights-dir", type=str, default="llm/clip/data")
    parser.add_argument("--random-init", action="store_true")
    parser.add_argument("--clip-norm", type=float, default=None,
                        help="global-norm gradient clipping in each step "
                        "(nn.utils.clip_grad_norm_)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)

    labels = parse_labels(args.labels)
    if not 0 <= args.target < len(labels):
        raise ValueError("target index out of range for labels.")
    device = resolve(args.device)
    image = load_image(args.image)[None]
    text = tokenize(labels)
    target = np.array([args.target], dtype=np.int64)

    model = build_model(args, device, "clip.finetune")
    if args.lora > 0:
        targets = tuple(t.strip() for t in args.lora_targets.split(",")
                        if t.strip())
        trainable_count, frozen_count = model.add_lora(
            r=args.lora, alpha=args.lora_alpha, targets=targets)
    else:
        prefixes = tuple(p.strip() for p in args.trainable.split(",")
                         if p.strip())
        trainable_count, frozen_count = model.set_trainable_parameters(
            prefixes)
    print(f"Trainable params: {trainable_count}, "
          f"Frozen params: {frozen_count}")

    optimizer = Adam([p for p in model.parameters() if p.requires_grad],
                     lr=args.lr)
    losses = []
    for step in range(1, args.steps + 1):
        losses.append(model.finetune_step(image, text, target, optimizer,
                                          clip_norm=args.clip_norm))
        if step == 1 or step % 5 == 0 or step == args.steps:
            print(f"step={step:04d}, loss={losses[-1]:.6f}")

    os.makedirs(os.path.dirname(args.save) or ".", exist_ok=True)
    save_finetuned_parameters(model, args.save)
    print(f"Saved finetuned params to {args.save}")
    return losses


if __name__ == "__main__":
    main()
