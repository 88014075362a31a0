"""CLIP ViT-B/32: an image and a text encoder for zero-shot classification
and fine-tuning (counterpart of ``pydynet_tpu/models/clip/model.py``).

The module tree and dotted names are the JAX package's, so its parameters,
the OpenAI checkpoint's mapping (``io.py``) and fine-tuned ``.npz`` files
carry over as they are; every Linear is the port's ``nn.Linear``, whose
weight is (in, out) as there. What the JAX package computes is kept:

* ``patch_project`` patchifies NCHW images and projects them with one
  float32 matmul, not a convolution (cuDNN's TF32 default would make the
  card's result differ from the CPU's);
* attention is ``softmax(q k^T * scale + mask) v`` in plain torch ops over a
  fused QKV projection, with the additive causal mask ``triu(-inf, 1)`` in
  the text encoder. No Pallas kernel lies on this path in the JAX package
  (its attention is XLA einsums), so none is launched here;
* ``CLIPLayerNorm`` normalises over the last axis with the biased variance
  in train and eval mode alike; it keeps its parent's running statistics as
  buffers, unused but in the state and counted, as the JAX package counts
  them among its parameters;
* the MLP's GELU is ``x * sigmoid(1.702 x)``; the text encoder pools the
  position of the largest id (the end token), the first one on a tie;
* ``CLIP.forward`` returns ``scale * img @ txt^T`` of the L2-normalised
  features (``+1e-12`` inside the root); ``scale`` is 1 unless
  ``io.load_model`` sets it to ``exp(logit_scale)``.

``CLIP(device=None)`` means the card; ``device="cpu"`` asks for the CPU.
The weights are drawn in float32 on the CPU from ``generator`` (a
``torch.Generator`` seeded 0 when not given) and copied to the device, so
one seed gives the same model on every device.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn as tnn

from ...device import resolve
from ... import nn
from ...nn import functional as F
from ...nn.utils import clip_grad_norm_
from ...nn.modules.module import Module, ModuleList


def build_attention_mask(context_length: int, device=None) -> torch.Tensor:
    """The additive causal mask: 0 on and below the diagonal, -inf
    above."""
    return torch.full((context_length, context_length), float("-inf"),
                      dtype=torch.float32, device=device).triu(1)


def patch_project(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """x (N, C, H, W), kernel (d, C, ph, pw) -> (N, (H/ph)*(W/pw), d): the
    (ph x pw) tiles in row-major order, each flattened (C, ph, pw) and
    multiplied by the flattened kernel."""
    n, c, h, w = x.shape
    d, pc, ph, pw = kernel.shape
    gh, gw = h // ph, w // pw
    W = kernel.permute(1, 2, 3, 0).reshape(pc * ph * pw, d)
    patches = x.reshape(n, c, gh, ph, gw, pw).permute(
        0, 2, 4, 1, 3, 5).reshape(n, gh * gw, pc * ph * pw)
    return patches @ W


def attention(q, k, v, mask, scale: float) -> torch.Tensor:
    """Attention over (B, L, H, hd) operands: ``softmax(q k^T * scale +
    mask) v``, the mask (L, L) additive or None."""
    s = torch.einsum("blhd,bmhd->bhlm", q, k) * scale
    if mask is not None:
        s = s + mask
    return torch.einsum("bhlm,bmhd->blhd", torch.softmax(s, dim=-1), v)


class MultiHeadAttention(Module):
    """Fused-QKV multi-head attention."""

    def __init__(self, n_dim: int, n_heads: int):
        super().__init__()
        self.n_dim = n_dim
        self.n_heads = n_heads
        self.head_dim = n_dim // n_heads
        self.QKV = nn.Linear(n_dim, n_dim * 3)
        self.O = nn.Linear(n_dim, n_dim)

    def forward(self, x, mask):
        B, L, _ = x.shape
        shape = (B, L, self.n_heads, self.head_dim)
        xq, xk, xv = (t.reshape(shape)
                      for t in torch.split(self.QKV(x), self.n_dim, -1))
        out = attention(xq, xk, xv, mask, 1.0 / math.sqrt(self.head_dim))
        return self.O(out.reshape(B, L, -1))


class CLIPLayerNorm(nn.LayerNorm):
    """Last-axis LayerNorm with scale and shift, the same in train and eval
    mode; the parent's running statistics stay as unused buffers."""

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.scale \
            + self.shift


class MLP(Module):

    def __init__(self, d_in: int, d_proj: int):
        super().__init__()
        self.d_in = d_in
        self.d_proj = d_proj
        self.fc1 = nn.Linear(d_in, d_proj)
        self.fc2 = nn.Linear(d_proj, d_in)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Transformer(Module):
    """Pre-norm residual block."""

    def __init__(self, n_dim: int, n_head: int, mlp_dim: int):
        super().__init__()
        self.mha = MultiHeadAttention(n_dim, n_head)
        self.mlp = MLP(n_dim, mlp_dim)
        self.layer_norm1 = CLIPLayerNorm((n_dim,), eps=1e-5)
        self.layer_norm2 = CLIPLayerNorm((n_dim,), eps=1e-5)

    def forward(self, x, mask):
        x = x + self.mha(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class ImageEncoder(Module):
    """ViT: patches, the class token, the position embedding, the blocks,
    then the class token's normalised features projected."""

    def __init__(self, n_dim, n_head, mlp_dim, kernel_size, n_layer,
                 final_dim):
        super().__init__()
        self.kernel = tnn.Parameter(
            torch.empty(n_dim, 3, kernel_size, kernel_size))
        self.pre_norm = CLIPLayerNorm((n_dim,), 1e-5)
        self.transformers = ModuleList(
            [Transformer(n_dim, n_head, mlp_dim) for _ in range(n_layer)])
        self.post_norm = CLIPLayerNorm((n_dim,), 1e-5)
        self.proj = nn.Linear(n_dim, final_dim, bias=False)

    def forward(self, x, class_emb, position_emb):
        x = patch_project(x, self.kernel)
        cls = class_emb.expand(x.shape[0], 1, class_emb.shape[-1])
        x = self.pre_norm(torch.cat([cls, x], dim=-2) + position_emb)
        for block in self.transformers:
            x = block(x, None)
        return self.proj(self.post_norm(x[:, 0]))


class TextEncoder(Module):
    """Causal text transformer pooled at the end token."""

    def __init__(self, n_dim, n_head, mlp_dim, n_layer, final_dim,
                 vocab_size):
        super().__init__()
        self.token_embed = nn.Embedding(vocab_size, n_dim)
        self.transformers = ModuleList(
            [Transformer(n_dim, n_head, mlp_dim) for _ in range(n_layer)])
        self.post_norm = CLIPLayerNorm((n_dim,), 1e-5)
        self.proj = nn.Linear(n_dim, final_dim, bias=False)
        self._mask_cache = {}  # (length, device) -> the causal mask

    def forward(self, idx, position_emb):
        x = self.token_embed(idx) + position_emb
        key = (x.shape[1], x.device)
        mask = self._mask_cache.get(key)
        if mask is None:
            mask = self._mask_cache[key] = build_attention_mask(
                x.shape[1], x.device)
        for block in self.transformers:
            x = block(x, mask)
        x = self.post_norm(x)
        eot = idx.argmax(-1)  # the end token has the largest id
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return self.proj(pooled)


class CLIP(Module):

    def __init__(self, image_dim: int = 768, image_heads: int = 12,
                 image_mlp_dim: int = 3072, image_patch: int = 32,
                 image_layers: int = 12, text_dim: int = 512,
                 text_heads: int = 8, text_mlp_dim: int = 2048,
                 text_layers: int = 12, final_dim: int = 512,
                 vocab_size: int = 49408, vision_tokens: int = 50,
                 text_tokens: int = 77, device=None,
                 generator: torch.Generator = None):
        super().__init__()
        device = resolve(device)
        with torch.device("meta"):  # shapes only: no storage, no draws
            self.class_embed = tnn.Parameter(torch.empty(1, 1, image_dim))
            self.v_pos_emb = tnn.Parameter(
                torch.empty(vision_tokens, image_dim))
            self.t_pos_emb = tnn.Parameter(torch.empty(text_tokens,
                                                       text_dim))
            self.image_encoder = ImageEncoder(image_dim, image_heads,
                                              image_mlp_dim, image_patch,
                                              image_layers, final_dim)
            self.text_encoder = TextEncoder(text_dim, text_heads,
                                            text_mlp_dim, text_layers,
                                            final_dim, vocab_size)
        self.to_empty(device=device)
        self.scale = 1
        self._trainable_buffers = set()  # buffer names saved as trainable
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator = None):
        """The embeddings and the patch kernel N(0, 1); each Linear's weight
        and bias uniform in +-1/sqrt(in_features) (kaiming-uniform with
        a = sqrt(5)); the norms' scale 1 and shift 0, running statistics 0
        and 1. Drawn in float32 on the CPU from ``generator`` in a fixed
        order and copied in."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)

        def normal(p):
            p.copy_(torch.empty(p.shape).normal_(generator=generator))

        for p in (self.class_embed, self.v_pos_emb, self.t_pos_emb,
                  self.image_encoder.kernel):
            normal(p)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                for p in (m.weight, m.bias):
                    if p is not None:
                        p.copy_(torch.empty(p.shape).uniform_(
                            -bound, bound, generator=generator))
            elif isinstance(m, nn.Embedding):
                normal(m.weight)
            elif isinstance(m, CLIPLayerNorm):
                m.reset_parameters()

    @property
    def device(self) -> torch.device:
        return self.class_embed.device

    def _input(self, x, dtype) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def forward(self, img, idx):
        """(N_img, N_txt) similarity logits of (N, 3, H, W) images and
        (N_txt, L) token ids (arrays or tensors, moved to the model's
        device)."""
        img = self._input(img, self.class_embed.dtype)
        idx = self._input(idx, torch.long)
        img_feature = self.image_encoder(img, self.class_embed,
                                         self.v_pos_emb)
        txt_feature = self.text_encoder(idx, self.t_pos_emb)
        norm_img = torch.sqrt(
            img_feature.square().sum(1, keepdim=True) + 1e-12)
        norm_txt = torch.sqrt(
            txt_feature.square().sum(1, keepdim=True) + 1e-12)
        img_feature = img_feature / norm_img
        txt_feature = txt_feature / norm_txt
        return (self.scale * img_feature) @ txt_feature.T

    # ------------------------- freezing / finetuning ------------------------
    def _counts(self):
        """(trainable, frozen) over the parameters and buffers, as the JAX
        package counts its ``_parameters`` (running statistics among
        them)."""
        trainable = sum(p.requires_grad for p in self.parameters()) \
            + len(self._trainable_buffers)
        total = sum(1 for _ in self.parameters()) \
            + sum(1 for _ in self.buffers())
        return trainable, total - trainable

    def set_trainable_parameters(self,
                                 trainable_prefixes=("text_encoder",)):
        """A parameter requires a gradient iff its dotted name starts with
        one of ``trainable_prefixes``. A buffer under such a prefix (a
        LayerNorm's running statistics, trainable in the JAX package, which
        keeps them as Parameters) is marked trainable for
        ``io.save_finetuned_parameters``; nothing steps it, and its
        gradient there is zero. Returns ``(trainable, frozen)``."""
        def on(name):
            return any(name.startswith(p) for p in trainable_prefixes)

        for name, param in self.named_parameters():
            param.requires_grad_(on(name))
        self._trainable_buffers = {n for n, _ in self.named_buffers()
                                   if on(n)}
        return self._counts()

    def trainable_names(self) -> list:
        """Dotted names of what a fine-tuned file holds: the parameters
        that require a gradient, then the buffers marked trainable."""
        return [n for n, p in self.named_parameters() if p.requires_grad] \
            + sorted(self._trainable_buffers)

    def add_lora(self, r: int = 8, alpha: float = 16.0,
                 targets=("QKV", "O"), dropout: float = 0.0):
        """Attach rank-``r`` LoRA adapters (``nn/modules/lora.py``) to every
        Linear whose attribute name is in ``targets`` (``QKV``/``O``
        attention, ``fc1``/``fc2`` MLP, ``proj`` heads) in both encoders
        and freeze everything else. Returns ``(trainable, frozen)``."""
        from ...nn.modules.lora import apply_lora
        if not apply_lora(self, r=r, alpha=alpha, targets=targets,
                          dropout=dropout, freeze=True):
            raise ValueError(f"no Linear matched targets={targets!r}")
        self._trainable_buffers = set()
        return self._counts()

    def merge_lora(self) -> int:
        """Fold every adapter into its base weight (plain Linears again);
        returns the number merged."""
        from ...nn.modules.lora import merge_lora
        return merge_lora(self)

    def finetune_step(self, image, text_tokens, target_ids, optimizer,
                      criterion=None, clip_norm=None) -> float:
        """One eager step: zero the gradients, forward, loss (the port's
        ``CrossEntropyLoss`` when not given) against ``target_ids`` (the
        right label of each image), backward, global-norm clipping to
        ``clip_norm`` when given, ``optimizer.step()``. Returns the loss.
        A frozen parameter gets no gradient here where the JAX package
        gives it zeros; neither moves the clipped norm."""
        if criterion is None:
            criterion = nn.CrossEntropyLoss()
        self.train(True)
        tgt = self._input(target_ids, torch.long).reshape(-1)
        optimizer.zero_grad()
        with torch.enable_grad():
            loss = criterion(self(image, text_tokens), tgt)
            loss.backward()
        if clip_norm is not None:
            clip_grad_norm_(optimizer.params, clip_norm)
        optimizer.step()
        return float(loss.detach())
