"""CLIP ViT-B/32 (counterpart of ``pydynet_tpu/models/clip``): the model,
its tokenizer and input pipelines, checkpoint reading and fine-tuned files.
The CLIs are ``python -m pydynet_tpu_torch.models.clip.infer`` and
``... .finetune``."""
from .model import CLIP, build_attention_mask, patch_project
from .tokenizer import SimpleTokenizer
from .data import tokenize, preprocess, preprocess_array
from .io import (Params, load_model, save_finetuned_parameters,
                 load_finetuned_parameters)

__all__ = ["CLIP", "Params", "SimpleTokenizer", "build_attention_mask",
           "load_finetuned_parameters", "load_model", "patch_project",
           "preprocess", "preprocess_array", "save_finetuned_parameters",
           "tokenize"]
