"""Mamba-2 780M — attention-free SSD [arXiv:2405.21060]."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    arch_family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    block=(LayerSpec(mixer="mamba", ffn="none"),),
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    citation="arXiv:2405.21060; unverified",
)
