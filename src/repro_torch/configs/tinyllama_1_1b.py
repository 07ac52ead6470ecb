"""TinyLlama 1.1B — llama2 architecture, small [arXiv:2401.02385]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    arch_family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=64,
    d_ff=5632, vocab_size=32000,
    mlp_act="swiglu", rope_theta=1e4,
    citation="arXiv:2401.02385; hf",
)
