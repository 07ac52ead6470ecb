"""Kimi K2 — trillion-parameter MoE, 384 experts top-8 [arXiv:2501.kimi2].
Layer 0 is dense (d_ff=18432, per the released config), the remaining 60
layers are MoE with one shared expert.  head_dim = 7168/64 = 112 per the
assignment's GQA spec (the release uses MLA; the spec overrides — noted in
DESIGN.md §5 and in the roofline: 112 is not 128-aligned on the MXU)."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048, vocab_size=163840,
    n_experts=384, top_k=8, moe_d_ff=2048, n_shared_experts=1,
    prefix=(LayerSpec(mixer="attn", ffn="dense"),), prefix_d_ff=18432,
    mlp_act="swiglu", rope_theta=5e4,
    citation="arXiv:2501.kimi2; unverified",
)
