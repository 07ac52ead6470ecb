"""Model / parallelism configuration system.

Every assigned architecture is a `ModelConfig` in its own module under
`repro_torch.configs`; `repro_torch.configs.get_config(name)` resolves
them, and `--arch <id>` on the launchers selects one.  Reduced (smoke-test) variants
come from `ModelConfig.reduced()`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside a (possibly repeating) super-block."""
    mixer: str = "attn"      # "attn" | "mamba"
    ffn: str = "dense"       # "dense" | "moe" | "none"


@dataclasses.dataclass
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 → d_model // n_heads
    arch_family: str = "dense"             # dense|moe|ssm|hybrid|audio|vlm

    # ---- MoE ----
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                      # per-expert hidden (0 → d_ff)
    n_shared_experts: int = 0
    capacity_factor: float = 1.0
    moe_impl: str = "scatter"              # "scatter" (EP) | "dense" (tiny ref)

    # ---- layer layout ----
    # the model is `n_repeats` copies (scanned) of `block` (unrolled inside),
    # optionally preceded by `prefix` layers (unscanned).
    block: Tuple[LayerSpec, ...] = ()
    prefix: Tuple[LayerSpec, ...] = ()
    prefix_d_ff: int = 0                   # d_ff for prefix dense layers

    # ---- encoder-decoder (whisper) ----
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq_ratio: int = 4                 # enc len = seq_len // ratio

    # ---- SSM (Mamba-2 / SSD) ----
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # ---- misc architecture ----
    mlp_act: str = "swiglu"                # swiglu|geglu|gelu
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    sliding_window: int = 0                # 0 = full attention
    tie_embeddings: bool = False

    # ---- modality frontend (STUB: input_specs provides embeddings) ----
    frontend: str = "none"                 # none|audio_stub|vision_stub
    n_patches: int = 0                     # vlm: image patches prepended

    # ---- numerics / runtime ----
    dtype: str = "bfloat16"
    remat: str = "block"                   # none|block|full — see launch.steps
    attn_chunk: int = 1024                 # q-chunk for memory-efficient attn
    loss_chunk: int = 0                    # fused unembed+CE seq chunk (0=off)
    use_flash_kernel: bool = False         # Pallas path (TPU)
    citation: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            self.head_dim = self.d_model // self.n_heads
        if self.moe_d_ff == 0:
            self.moe_d_ff = self.d_ff
        if not self.block:
            ffn = "moe" if self.n_experts else ("none" if self.d_ff == 0 else "dense")
            mixer = "mamba" if self.arch_family == "ssm" else "attn"
            self.block = (LayerSpec(mixer=mixer, ffn=ffn),)

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so the unembedding shards over the
        16-way model axis (Megatron-style vocab padding)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def n_repeats(self) -> int:
        body = self.n_layers - len(self.prefix)
        assert body % len(self.block) == 0, \
            f"{self.name}: {body} layers not divisible by block {len(self.block)}"
        return body // len(self.block)

    @property
    def is_attention_free(self) -> bool:
        specs = list(self.block) + list(self.prefix)
        return all(s.mixer != "attn" for s in specs)

    @property
    def has_subquadratic_path(self) -> bool:
        """long_500k eligibility: SSM / hybrid archs (decode is state-bound
        or linear in the small attention fraction)."""
        return self.arch_family in ("ssm", "hybrid")

    # ---- parameter counting -------------------------------------------
    def _mixer_params(self, spec: LayerSpec) -> int:
        d, hd = self.d_model, self.head_dim
        if spec.mixer == "attn":
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            bias = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
            return q + kv + o + bias
        # mamba2: in_proj (d -> 2*dinner + 2*ngroups*state + nheads), conv,
        # out_proj, A/D/dt
        dinner = self.ssm_expand * d
        nheads = dinner // self.ssm_head_dim
        in_p = d * (2 * dinner + 2 * self.ssm_state + nheads)
        conv = (dinner + 2 * self.ssm_state) * self.ssm_conv_width
        out_p = dinner * d
        return in_p + conv + out_p + 3 * nheads

    def _ffn_params(self, spec: LayerSpec, d_ff: Optional[int] = None) -> int:
        d = self.d_model
        if spec.ffn == "none":
            return 0
        if spec.ffn == "moe":
            f = self.moe_d_ff
            gates = 3 if self.mlp_act in ("swiglu", "geglu") else 2
            per = gates * d * f
            return (self.n_experts + self.n_shared_experts) * per + d * self.n_experts
        f = d_ff or self.d_ff
        gates = 3 if self.mlp_act in ("swiglu", "geglu") else 2
        return gates * d * f

    def param_count(self) -> int:
        d = self.d_model
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        norms_per_layer = 2 * d

        def layer_params(spec: LayerSpec, d_ff=None) -> int:
            return self._mixer_params(spec) + self._ffn_params(spec, d_ff) \
                + norms_per_layer

        for spec in self.prefix:
            total += layer_params(spec, self.prefix_d_ff or self.d_ff)
        for _ in range(self.n_repeats):
            for spec in self.block:
                total += layer_params(spec)
        if self.enc_dec:
            # encoder stack + per-decoder-layer cross attention
            enc_spec = LayerSpec(mixer="attn", ffn="dense")
            total += self.n_enc_layers * layer_params(enc_spec)
            total += self.n_layers * (2 * self.d_model * self.n_heads
                                      * self.head_dim + self.d_model
                                      * self.n_heads * self.head_dim
                                      + self.d_model * self.n_kv_heads
                                      * self.head_dim)
        return total

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top-k + shared experts only)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)

        def layer_active(spec: LayerSpec, d_ff=None) -> int:
            mix = self._mixer_params(spec)
            if spec.ffn == "moe":
                gates = 3 if self.mlp_act in ("swiglu", "geglu") else 2
                per = gates * d * self.moe_d_ff
                ffn = (self.top_k + self.n_shared_experts) * per
            else:
                ffn = self._ffn_params(spec, d_ff)
            return mix + ffn + 2 * d

        for spec in self.prefix:
            total += layer_active(spec, self.prefix_d_ff or self.d_ff)
        for _ in range(self.n_repeats):
            for spec in self.block:
                total += layer_active(spec)
        return total

    # ------------------------------------------------------------------
    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant of the same family: tiny dims, same structure."""
        block = self.block
        prefix = self.prefix
        n_layers = len(prefix) + len(block)  # one super-block
        small = dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=min(self.d_model, 128),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=32,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            moe_d_ff=min(self.moe_d_ff, 128) if self.moe_d_ff else 0,
            prefix_d_ff=min(self.prefix_d_ff, 256) if self.prefix_d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=32,
            n_patches=min(self.n_patches, 16),
            attn_chunk=64,
            dtype="float32",
        )
        for k, v in overrides.items():
            object.__setattr__(small, k, v)
        return small


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ModelConfig) -> List[ShapeSpec]:
    """The assigned shape set, with the mandated skips (DESIGN.md §5):
    long_500k only for SSM/hybrid archs."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.has_subquadratic_path:
        out.append(LONG_500K)
    return out


def skipped_shapes_for(cfg: ModelConfig) -> List[Tuple[ShapeSpec, str]]:
    if cfg.has_subquadratic_path:
        return []
    return [(LONG_500K, "SKIP(full-attn): pure full-attention arch; "
                        "assignment mandates skip for long_500k")]
