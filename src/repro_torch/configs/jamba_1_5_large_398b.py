"""Jamba-1.5-Large — hybrid Mamba+attention 1:7 interleave with MoE
[arXiv:2403.19887].  72 layers = 9 scanned super-blocks of 8 layers
(attention at in-block index 3, the rest Mamba-2-style SSD mixers); MoE on
every odd in-block layer (16 experts, top-2)."""
from .base import LayerSpec, ModelConfig

_BLOCK = tuple(
    LayerSpec(mixer=("attn" if i == 3 else "mamba"),
              ffn=("moe" if i % 2 == 1 else "dense"))
    for i in range(8))

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    n_experts=16, top_k=2, moe_d_ff=24576,
    block=_BLOCK,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    mlp_act="swiglu", rope_theta=1e4,
    citation="arXiv:2403.19887; hf",
)
