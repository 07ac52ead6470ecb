"""Pixtral-12B — Mistral-Nemo-style backbone + ViT frontend STUB
[hf:mistralai/Pixtral-12B-2409]: input_specs() provides 1024 precomputed
patch embeddings prepended to the text tokens."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    arch_family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    frontend="vision_stub", n_patches=1024,
    mlp_act="swiglu", rope_theta=1e6,
    citation="hf:mistralai/Pixtral-12B-2409; unverified",
)
