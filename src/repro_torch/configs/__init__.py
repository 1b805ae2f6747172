"""Architecture registry: ``--arch <id>`` -> exact public config.

A copy of the JAX package's ``repro.configs`` (data only), kept here so the
port imports nothing of ``repro``.  Every family is registered, and
``repro_torch.models.build_model`` builds each of them.

``smoke_config()`` derives the reduced same-family configs used by the
per-arch CPU smoke tests (full configs are exercised only via the dry-run).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, shape_applicable  # noqa: F401
from repro_torch.configs import (
    dbrx_132b,
    jamba_1_5_large_398b,
    llama4_scout_17b_a16e,
    mamba2_1_3b,
    minitron_4b,
    qwen1_5_0_5b,
    qwen1_5_110b,
    qwen2_vl_2b,
    whisper_tiny,
    yi_6b,
)

REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        whisper_tiny,
        qwen1_5_110b,
        minitron_4b,
        yi_6b,
        qwen1_5_0_5b,
        qwen2_vl_2b,
        dbrx_132b,
        llama4_scout_17b_a16e,
        mamba2_1_3b,
        jamba_1_5_large_398b,
    )
}


def list_archs() -> list[str]:
    return sorted(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    return REGISTRY[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: small widths/layers/experts/vocab."""
    cfg = get_config(name)
    upd: dict = dict(
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab_size=512,
        dtype="float32",
        remat="none",
        fsdp=False,
        seq_shard_activations=False,
    )
    if cfg.family == "hybrid":
        upd["num_layers"] = cfg.attn_period  # one superblock
    elif cfg.is_encdec:
        upd["num_layers"] = 4
        upd["encoder_layers"] = 2
        upd["decoder_layers"] = 2
    else:
        upd["num_layers"] = 2
    if cfg.num_experts:
        upd["num_experts"] = 4
        upd["experts_per_token"] = min(cfg.experts_per_token, 2)
        upd["capacity_factor"] = 2.0
    if cfg.family in ("ssm", "hybrid"):
        upd["ssm_state"] = 32
        upd["ssm_headdim"] = 32
        upd["ssm_chunk"] = 32
    if cfg.mrope_sections:
        upd["mrope_sections"] = (4, 6, 6)  # head_dim/2 = 16 slots
    if cfg.is_encdec:
        upd["num_kv_heads"] = 4  # whisper is MHA: keep kv == heads
    return dataclasses.replace(cfg, **upd)
