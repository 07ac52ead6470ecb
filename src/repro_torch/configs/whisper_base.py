"""Whisper-base — encoder-decoder speech backbone [arXiv:2212.04356].
Conv frontend is a STUB: input_specs() provides precomputed frame
embeddings; decoder length = seq_len // enc_seq_ratio (DESIGN.md §5)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    arch_family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, vocab_size=51865,
    enc_dec=True, n_enc_layers=6, enc_seq_ratio=4,
    frontend="audio_stub",
    mlp_act="gelu", qkv_bias=True, rope_theta=1e4,
    citation="arXiv:2212.04356; unverified",
)
