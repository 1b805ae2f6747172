"""Architecture + shape configuration system (``--arch``/``--shape``)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One assigned architecture (exact public-literature config)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 1e4
    norm_type: str = "rms"  # "rms" | "ln" (whisper)
    mlp_gated: bool = True  # False -> GELU MLP with biases (whisper)
    use_rope: bool = True  # False -> absolute positions only (whisper)

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_softmax_topk: bool = True  # False -> sigmoid gates (llama4-style)

    # --- SSM (Mamba-2 / SSD) -------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # --- hybrid (Jamba) ------------------------------------------------------
    attn_period: int = 0  # one attention layer per `attn_period` layers
    attn_offset: int = 4  # its index within the period (Jamba uses 4)
    moe_period: int = 0  # MoE replaces dense MLP every `moe_period` layers
    mlp_in_ssm_blocks: bool = True  # hybrid blocks carry their own MLP

    # --- encoder-decoder (Whisper) -------------------------------------------
    encoder_layers: int = 0
    decoder_layers: int = 0

    # --- VLM (Qwen2-VL M-RoPE) ------------------------------------------------
    mrope_sections: tuple = ()  # head_dim/2 split into (t, h, w) sections

    # --- frontend stub ---------------------------------------------------------
    input_mode: str = "tokens"  # "tokens" | "embeddings" (audio/vision stub)

    # --- runtime/distribution knobs (tunable; see EXPERIMENTS.md §Perf) -------
    dtype: str = "bfloat16"
    remat: str = "full"  # none | dots | full
    scan_layers: bool = True
    attn_block_q: int = 1024
    attn_block_kv: int = 1024
    # Blockwise (flash-style) attention at/above this sequence length.
    # §Perf iteration 3 (refuted): lowering to 4096 does NOT reduce HLO-level
    # HBM traffic (blocks sum to the same S² bytes and scan carries add
    # copies) — the traffic win belongs to the Pallas flash kernel on real
    # TPU.  Kept at 8192 where the *footprint* forces the blockwise path.
    blockwise_attn_threshold: int = 8192
    fsdp: bool = True  # shard params/optimizer over the data axis
    seq_shard_activations: bool = True  # Megatron-SP style residual sharding
    # TP activation strategy (§Perf iteration 5): "megatron" pins attention
    # heads / MLP hidden to the model axis (partial-sum reductions of token
    # blocks); "gather" leaves them unconstrained, and XLA gathers the
    # model-sharded weights while tokens stay seq-sharded (ZeRO-3-like).
    # Collective bytes favour "gather" when per-layer token-block bytes
    # exceed per-layer param bytes and vice versa — measured per cell in
    # EXPERIMENTS.md §Perf.
    tp_style: str = "megatron"  # "megatron" | "gather"
    microbatches: int = 1  # gradient accumulation
    optimizer_moment_dtype: str = "float32"  # "bfloat16" for the largest archs
    logits_f32: bool = True
    # Inference weights: training keeps f32 masters, but serving reads every
    # weight once per token — storing them at compute precision removes the
    # f32-read + bf16-write convert traffic (3x the bf16 bytes) that
    # dominated the jamba long_500k decode cell (§Perf iteration B1).
    serve_params_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(
                self, "head_dim", self.d_model // max(self.num_heads, 1)
            )

    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid only)."""
        return self.family in ("ssm", "hybrid")

    def layer_kind(self, l: int) -> str:
        """'attn' or 'ssm' mixer at layer l (hybrid interleave)."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid" and self.attn_period:
            return "attn" if (l % self.attn_period) == self.attn_offset else "ssm"
        return "attn"

    def ffn_kind(self, l: int) -> str:
        """'moe', 'dense', or 'none' FFN at layer l."""
        if self.d_ff == 0:
            return "none"
        if self.num_experts:
            if self.moe_period:
                return "moe" if (l % self.moe_period) == 1 else "dense"
            return "moe"
        return "dense"


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The assigned LM shape set (identical across the 10 architectures).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) per the assignment's skip rules."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "skipped: pure full-attention arch; long_500k is reserved for "
            "sub-quadratic (SSM/hybrid) families per the assignment"
        )
    return True, ""
