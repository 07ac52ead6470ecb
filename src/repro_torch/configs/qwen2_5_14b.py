"""Qwen2.5-14B — GQA with QKV bias [hf:Qwen/Qwen2.5]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    arch_family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=13824, vocab_size=152064,
    mlp_act="swiglu", qkv_bias=True, rope_theta=1e6,
    citation="hf:Qwen/Qwen2.5-0.5B; hf",
)
