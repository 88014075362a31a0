from .model import Llama, compute_cos_sin_cache
from .tokenizer import Tokenizer
from .io import infer_config, load_model
from .convert import params_from_tpu, params_to_tpu

__all__ = ["Llama", "Tokenizer", "compute_cos_sin_cache", "infer_config",
           "load_model", "params_from_tpu", "params_to_tpu"]
