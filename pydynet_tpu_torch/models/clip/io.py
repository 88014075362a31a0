"""CLIP weights on disk (counterpart of ``pydynet_tpu/models/clip/io.py``).

:class:`Params` reads OpenAI's ViT-B/32 ``.pt`` (a zip) through the JSON
index beside it (each tensor's member, byte range, type and shape), or, when
there is no index, through ``torch.jit.load``; it gives float32 NumPy arrays
by OpenAI's names, as the JAX package's does. There is no download: a
missing checkpoint raises ``FileNotFoundError``. :func:`load_model` maps
OpenAI's names to the model's dotted names, transposing each Linear weight
to the (in, out) layout, and sets ``scale`` to ``exp(logit_scale)``.
Fine-tuned files are ``.npz`` by dotted name in the JAX package's layout, so
a file written by either package loads into both.
"""
from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import torch

from .model import CLIP

# the JAX package's CLIs keep their weights here (``--weights-dir``)
DEFAULT_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))), "llm", "clip", "data")


def load_zip(path: str) -> dict:
    files = {}
    with zipfile.ZipFile(path) as z:
        for info in z.infolist():
            with z.open(info) as f:
                files[info.filename] = f.read()
    return files


class Params:
    """OpenAI's checkpoint by name: ``params["visual.proj"]`` is a float32
    array. ``download_root`` (``$CLIP_DIR``, else the repository's
    ``llm/clip/data``, when not given) holds ``ViT-B-32.pt`` and, for the
    raw-byte reader, ``ViT-B-32.json``."""

    MODELS = ("ViT-B/32",)

    def __init__(self, name: str, download_root: str = None) -> None:
        assert name in self.MODELS, f"Model {name} not supported."
        name = name.replace("/", "-")
        if download_root is None:
            download_root = os.environ.get("CLIP_DIR", DEFAULT_ROOT)
        model_path = os.path.join(download_root, f"{name}.pt")
        index_path = os.path.join(download_root, f"{name}.json")
        self._tensors = None
        if os.path.isfile(model_path) and not os.path.isfile(index_path):
            self._tensors = self._load_with_torch(model_path)
            if self._tensors is not None:
                self.files, self.info = None, None
                return
        if not (os.path.isfile(model_path) and os.path.isfile(index_path)):
            raise FileNotFoundError(
                f"CLIP checkpoint not found at {model_path} (+ JSON index). "
                "Place the files there, or run the CLIs with --random-init.")
        self.files = load_zip(model_path)
        with open(index_path) as f:
            self.info = json.load(f)

    @staticmethod
    def _load_with_torch(path):
        try:
            sd = torch.jit.load(path, map_location="cpu").state_dict()
            return {k: v.detach().float().numpy() for k, v in sd.items()}
        except Exception as e:
            print(f"torch load of {path} failed: {type(e).__name__}: {e}")
            return None

    def __getitem__(self, name: str) -> np.ndarray:
        if self._tensors is not None:
            return np.asarray(self._tensors[name], np.float32)
        info = self.info[name]
        data = self.files[info["path"]][info["start"]:info["end"]]
        arr = np.frombuffer(data, dtype=info["dtype"]).reshape(info["shape"])
        return arr.astype(np.float32)


# a resblock's dotted names, OpenAI's, and whether the weight is transposed
PER_BLOCK = (
    ("mha.QKV.weight", "attn.in_proj_weight", True),
    ("mha.QKV.bias", "attn.in_proj_bias", False),
    ("mha.O.weight", "attn.out_proj.weight", True),
    ("mha.O.bias", "attn.out_proj.bias", False),
    ("layer_norm1.scale", "ln_1.weight", False),
    ("layer_norm1.shift", "ln_1.bias", False),
    ("layer_norm2.scale", "ln_2.weight", False),
    ("layer_norm2.shift", "ln_2.bias", False),
    ("mlp.fc1.weight", "mlp.c_fc.weight", True),
    ("mlp.fc1.bias", "mlp.c_fc.bias", False),
    ("mlp.fc2.weight", "mlp.c_proj.weight", True),
    ("mlp.fc2.bias", "mlp.c_proj.bias", False),
)


@torch.no_grad()
def load_model(model: CLIP, param) -> CLIP:
    """Copy OpenAI's ViT-B/32 weights (a :class:`Params` or a dict of
    arrays by OpenAI's names) into ``model``."""
    own = model.state_dict(keep_vars=True)

    def put(name, value):
        own[name].copy_(torch.from_numpy(np.ascontiguousarray(value)))

    model.scale = float(np.exp(param["logit_scale"].astype(np.float32)))
    put("class_embed", param["visual.class_embedding"].reshape(1, 1, -1))
    put("v_pos_emb", param["visual.positional_embedding"])
    put("t_pos_emb", param["positional_embedding"])

    put("image_encoder.kernel", param["visual.conv1.weight"])
    put("image_encoder.pre_norm.scale", param["visual.ln_pre.weight"])
    put("image_encoder.pre_norm.shift", param["visual.ln_pre.bias"])
    put("image_encoder.post_norm.scale", param["visual.ln_post.weight"])
    put("image_encoder.post_norm.shift", param["visual.ln_post.bias"])
    put("image_encoder.proj.weight", param["visual.proj"])

    put("text_encoder.token_embed.weight", param["token_embedding.weight"])
    put("text_encoder.post_norm.scale", param["ln_final.weight"])
    put("text_encoder.post_norm.shift", param["ln_final.bias"])
    put("text_encoder.proj.weight", param["text_projection"])

    for i in range(12):
        for ours, theirs, transpose in PER_BLOCK:
            v = param[f"visual.transformer.resblocks.{i}.{theirs}"]
            put(f"image_encoder.transformers.{i}.{ours}",
                v.T if transpose else v)
            t = param[f"transformer.resblocks.{i}.{theirs}"]
            put(f"text_encoder.transformers.{i}.{ours}",
                t.T if transpose else t)
    return model


@torch.no_grad()
def save_finetuned_parameters(model: CLIP, output_path: str) -> None:
    """Write ``model.trainable_names()`` to an ``.npz`` at exactly
    ``output_path``: the key set the JAX package writes for the same
    ``set_trainable_parameters`` prefixes or ``add_lora`` call."""
    own = model.state_dict(keep_vars=True)
    params = {name: own[name].detach().cpu().numpy()
              for name in model.trainable_names()}
    # a file object: np.savez appends '.npz' to an extensionless path
    with open(output_path, "wb") as f:
        np.savez(f, **params)


@torch.no_grad()
def load_finetuned_parameters(model: CLIP, finetuned_path: str) -> CLIP:
    """Copy every entry of a fine-tuned ``.npz`` (either package's) whose
    name the model has; ``path + ".npz"`` is tried when ``path`` is
    missing."""
    if not os.path.exists(finetuned_path) \
            and os.path.exists(finetuned_path + ".npz"):
        finetuned_path += ".npz"
    own = model.state_dict(keep_vars=True)
    with np.load(finetuned_path) as weights:
        for name, t in own.items():
            if name in weights:
                t.copy_(torch.from_numpy(weights[name]))
    return model
