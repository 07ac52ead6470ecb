"""Gemma 2B — GeGLU, head_dim 256, MQA (kv=1), tied embeddings
[arXiv:2403.08295]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    arch_family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000,
    mlp_act="geglu", tie_embeddings=True, rope_theta=1e4,
    citation="arXiv:2403.08295; hf",
)
