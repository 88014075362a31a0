"""CLIP zero-shot classification from the command line (port of
``llm/clip/infer.py``):

    python -m pydynet_tpu_torch.models.clip.infer --random-init \\
        [--image picture.png] [--labels "a fish,a dog,a cat"] \\
        [--finetuned ft.npz] [--weights-dir DIR] [--device cuda|cpu]

The JAX CLI's flags, with ``--device`` (``cuda`` by default, which raises
without a GPU) in place of ``--no-cuda``. The image is preprocessed as
CLIP's (``data.preprocess``); when its file is missing, the JAX CLI's
synthetic image is used (``default_rng(0)`` uniform 256 x 256 x 3). Without
OpenAI's checkpoint in ``--weights-dir`` (or with ``--random-init``) the
ViT-B/32 model is built with random weights from seed 0. Prints the labels
and each label's probability for the image.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ...device import resolve
from ...nn import functional as F
from .data import preprocess, preprocess_array, tokenize
from .io import Params, load_finetuned_parameters, load_model
from .model import CLIP


def load_image(path: str) -> torch.Tensor:
    """(3, 224, 224) float32: the image at ``path``, or the synthetic one
    when there is no file there."""
    if os.path.exists(path):
        from PIL import Image
        return preprocess(Image.open(path))
    print(f"[clip.infer] image {path!r} not found -> synthetic image")
    rng = np.random.default_rng(0)
    return preprocess_array(rng.uniform(0, 1, (256, 256, 3)))


def build_model(args, device, log: str) -> CLIP:
    """ViT-B/32 on ``device``: OpenAI's weights from ``args.weights_dir``,
    or random ones from seed 0 with ``args.random_init`` or when the
    checkpoint is missing."""
    model = CLIP(device=device)
    if not args.random_init:
        try:
            model = load_model(model, Params("ViT-B/32",
                                             download_root=args.weights_dir))
        except FileNotFoundError as e:
            print(f"[{log}] {e}\n-> random-initialized weights")
    return model


def main(argv=None):
    parser = argparse.ArgumentParser(description="CLIP image-text inference")
    parser.add_argument("--image", type=str, default="llm/clip/picture.png")
    parser.add_argument("--labels", type=str, default="a fish,a dog,a cat")
    parser.add_argument("--finetuned", type=str, default=None)
    parser.add_argument("--weights-dir", type=str, default="llm/clip/data")
    parser.add_argument("--random-init", action="store_true")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)

    labels = [x.strip() for x in args.labels.split(",") if x.strip()]
    device = resolve(args.device)
    image = load_image(args.image)[None]
    text = tokenize(labels)

    clip = build_model(args, device, "clip.infer")
    if args.finetuned is not None:
        clip = load_finetuned_parameters(clip, args.finetuned)
    clip.eval()

    with torch.no_grad():
        t0 = time.perf_counter()
        probs = F.softmax(clip(image, text), axis=-1)
        out = probs.cpu().numpy()[0]
        elapsed = time.perf_counter() - t0
    print("Labels:", labels)
    print("Label probs:", out)
    print(f"(run {elapsed:.2f}s)")
    return out


if __name__ == "__main__":
    main()
