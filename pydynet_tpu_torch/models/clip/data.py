"""CLIP's inputs (counterpart of ``pydynet_tpu/models/clip/data.py``):
texts to a (N, 77) int64 id matrix, and images to CHW float32 tensors
normalised by CLIP's mean and standard deviation.

``preprocess`` resizes a PIL image bicubically so its short side is
``image_size``, center-crops it and normalises; PIL is imported only there.
``preprocess_array`` center-crops an (H, W, 3) array in [0, 1]. Both return
CPU tensors with the JAX package's values bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from .tokenizer import SimpleTokenizer

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def tokenize(texts, context_length: int = 77, tokenizer=None) -> np.ndarray:
    """(N, context_length) int64: start token, the text's ids, end token,
    zeros after; a text longer than that raises ``RuntimeError``."""
    if tokenizer is None:
        tokenizer = SimpleTokenizer()
    sot = tokenizer.encoder["<|startoftext|>"]
    eot = tokenizer.encoder["<|endoftext|>"]
    all_tokens = [[sot] + tokenizer.encode(t) + [eot] for t in texts]

    result = np.zeros((len(all_tokens), context_length), dtype=np.int64)
    for i, tokens in enumerate(all_tokens):
        if len(tokens) > context_length:
            raise RuntimeError(f"Input {texts[i]} is too long for context "
                               f"length {context_length}")
        result[i, :len(tokens)] = tokens
    return result


def _normalized_chw(x: np.ndarray) -> torch.Tensor:
    x = (x - CLIP_MEAN) / CLIP_STD
    return torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1)))


def preprocess(image, image_size: int = 224) -> torch.Tensor:
    """PIL image -> (3, image_size, image_size) float32 tensor."""
    from PIL import Image

    width, height = image.size
    scale = image_size / min(width, height)
    width, height = int(scale * width), int(scale * height)
    resample = (Image.Resampling.BICUBIC
                if hasattr(Image, "Resampling") else Image.BICUBIC)
    image = image.resize((width, height), resample)

    x0 = round((width - image_size) / 2)
    y0 = round((height - image_size) / 2)
    image = image.crop((x0, y0, x0 + image_size,
                        y0 + image_size)).convert("RGB")
    return _normalized_chw(np.array(image, dtype=np.float32) / 255.0)


def preprocess_array(x: np.ndarray, image_size: int = 224) -> torch.Tensor:
    """(H, W, 3) float array in [0, 1] -> (3, image_size, image_size)
    float32 tensor."""
    h, w = x.shape[:2]
    y0, x0 = (h - image_size) // 2, (w - image_size) // 2
    x = x[y0:y0 + image_size, x0:x0 + image_size].astype(np.float32)
    return _normalized_chw(x)
