"""Moonlight-16B-A3B-style MoE: 64 experts top-6, MHA (kv=16)
[hf:moonshotai/Moonlight-16B-A3B]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    arch_family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=163840,
    n_experts=64, top_k=6, moe_d_ff=1408,
    mlp_act="swiglu", rope_theta=5e4,
    citation="hf:moonshotai/Moonlight-16B-A3B; hf",
)
