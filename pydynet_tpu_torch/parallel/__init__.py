"""The port's parallel package (counterpart of ``pydynet_tpu/parallel``):
meshes over ``torch.distributed`` (``mesh.py`` sets out the execution
model), the SPMD Llama (``llama_spmd``) and its server (``serve_spmd``),
pipeline, ring attention and expert parallelism."""
from .mesh import (P, Mesh, make_mesh, make_hybrid_mesh,
                   initialize_distributed, named_sharding, shard, replicate)
from .ring_attention import ring_attention
from . import llama_spmd
from . import moe
from . import pipeline
from . import serve_spmd

# Megatron-style tensor-parallel rules for the port's Llama module
# (models/llama/model.py), for jit(mesh=..., shard_rules=...). Its layers
# are torch Linears, (out, in): column-parallel shards dim 0, row-parallel
# dim 1 (the JAX package's (in, out) specs transposed).
LLAMA_TP_RULES = [
    ("*.attention.Q.weight", P("tp", None)),   # column-parallel QKV
    ("*.attention.K.weight", P("tp", None)),
    ("*.attention.V.weight", P("tp", None)),
    ("*.attention.O.weight", P(None, "tp")),   # row-parallel output proj
    ("*.ffn.gate.weight", P("tp", None)),
    ("*.ffn.up.weight", P("tp", None)),
    ("*.ffn.down.weight", P(None, "tp")),
    ("lm_head.weight", P("tp", None)),         # vocab-sharded head
    ("lm_head.bias", P("tp")),
    ("tok_embedding.weight", P("tp", None)),   # vocab-sharded embedding
    ("*.cache_k", P(None, None, "tp", None)),  # head-sharded KV caches
    ("*.cache_v", P(None, None, "tp", None)),
]
