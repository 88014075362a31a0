"""Checkpoint IO for the Llama path (port of
``pydynet_tpu/models/llama/io.py``): the same HF-named npz files.

HF stores Linear weights as (out, in), which is torch's layout, so unlike
the JAX package nothing is transposed when a checkpoint is loaded. Finetuned
parameters are the other way round: their npz files keep the JAX package's
(in, out) Linear layout, so one file loads into both packages.
"""
from __future__ import annotations

import math
import os
import warnings

import numpy as np
import torch

from .convert import params_to_tpu, swap_linear
from .model import Llama


def infer_config(model_path: str, max_seq_len: int = 1024,
                 max_batch_size: int = 1, n_heads: int = None) -> dict:
    """``Llama(**infer_config(path))`` kwargs from an HF-named npz's array
    shapes. Head counts come from ``config.n_heads`` / ``config.n_kv_heads``
    entries when present, then from ``n_heads``, then from the conventional
    head_dim candidates (a ``UserWarning`` names them when several fit)."""
    with np.load(model_path) as w:
        return _infer_config(w, max_seq_len, max_batch_size, n_heads)


def _infer_config(w, max_seq_len, max_batch_size, n_heads):
    vocab, dim = w["model.embed_tokens.weight"].shape
    n_layers = 0
    while f"model.layers.{n_layers}.self_attn.q_proj.weight" in w.files:
        n_layers += 1
    ffn_dim = w["model.layers.0.mlp.gate_proj.weight"].shape[0]
    kv_rows = w["model.layers.0.self_attn.k_proj.weight"].shape[0]
    if n_heads is None and "config.n_heads" in w.files:
        n_heads = int(w["config.n_heads"])
    if n_heads is None and "config.n_kv_heads" in w.files:
        n_kv = int(w["config.n_kv_heads"])
        if kv_rows % n_kv or dim % (kv_rows // n_kv):
            raise ValueError(f"config.n_kv_heads={n_kv} does not divide "
                             f"kv_rows={kv_rows} / dim={dim}")
        n_heads = dim // (kv_rows // n_kv)
    if n_heads is not None:
        if dim % n_heads or kv_rows % (dim // n_heads):
            raise ValueError(f"n_heads={n_heads} does not divide dim={dim} "
                             f"and kv_rows={kv_rows}")
        head_dim = dim // n_heads
    else:
        order = (48, 64, 128) if dim < 512 else (64, 128, 48)
        fits = [hd for hd in order if dim % hd == 0 and kv_rows % hd == 0]
        head_dim = fits[0] if fits else math.gcd(dim, kv_rows)
        if len(fits) > 1:
            warnings.warn(
                f"head_dim is ambiguous for dim={dim}, kv_rows={kv_rows}: "
                f"candidates {fits} all fit; assuming head_dim={head_dim} "
                f"(n_heads={dim // head_dim}). Pass n_heads= (CLI: "
                "--n-heads) if the checkpoint uses another layout.")
    return dict(vocab_size=vocab, embed_dim=dim, n_heads=dim // head_dim,
                n_kv_heads=kv_rows // head_dim, ffn_dim=ffn_dim,
                n_layers=n_layers, max_seq_len=max_seq_len,
                max_batch_size=max_batch_size)


_PER_LAYER = [
    ("attention.Q.weight", "self_attn.q_proj.weight"),
    ("attention.K.weight", "self_attn.k_proj.weight"),
    ("attention.V.weight", "self_attn.v_proj.weight"),
    ("attention.O.weight", "self_attn.o_proj.weight"),
    ("ffn.up.weight", "mlp.up_proj.weight"),
    ("ffn.gate.weight", "mlp.gate_proj.weight"),
    ("ffn.down.weight", "mlp.down_proj.weight"),
    ("input_norm.weight", "input_layernorm.weight"),
    ("post_attn_norm.weight", "post_attention_layernorm.weight"),
]


@torch.no_grad()
def load_model(llama: Llama, model_path: str) -> Llama:
    """Copy an HF-named npz into ``llama`` in place. The checkpoint has no
    ``lm_head.bias``; the model keeps its own, as the JAX package does."""
    params = dict(llama.named_parameters())

    def put(name, value):
        p = params[name]
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"{name}: checkpoint shape {value.shape}, "
                             f"model shape {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.ascontiguousarray(value)))

    with np.load(model_path) as w:
        put("tok_embedding.weight", w["model.embed_tokens.weight"])
        put("lm_head.weight", w["lm_head.weight"])
        for i in range(llama.n_layers):
            for ours, theirs in _PER_LAYER:
                put(f"layers.{i}.{ours}", w[f"model.layers.{i}.{theirs}"])
        put("norm.weight", w["model.norm.weight"])
    llama._weights_cache.clear()
    return llama


@torch.no_grad()
def save_finetuned_parameters(model: Llama, output_path: str):
    """Write the parameters that require a gradient to ``output_path`` as an
    npz, Linear weights transposed to the JAX package's (in, out). The path
    is used as given: no ``.npz`` is appended."""
    params = params_to_tpu({name: p for name, p in model.named_parameters()
                            if p.requires_grad})
    # a file object, because np.savez appends '.npz' to a bare path
    with open(output_path, "wb") as f:
        np.savez(f, **params)


@torch.no_grad()
def load_finetuned_parameters(model: Llama, finetuned_path: str) -> Llama:
    """Copy every parameter the npz holds into ``model`` (Linear weights
    transposed back to (out, in)); names the model lacks, such as the JAX
    package's KV caches, are ignored. A path without its ``.npz`` is found
    with it."""
    if not os.path.exists(finetuned_path) \
            and os.path.exists(finetuned_path + ".npz"):
        finetuned_path += ".npz"
    with np.load(finetuned_path) as weights:
        for name, param in model.named_parameters():
            if name in weights.files:
                param.copy_(torch.from_numpy(np.ascontiguousarray(
                    swap_linear(name, weights[name]))))
    model._weights_cache.clear()
    return model
