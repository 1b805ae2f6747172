"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576, MoE 16 experts top-2, Mamba+attention 1:7 interleave
[arXiv:2403.19887; hf].

Superblock of 8 layers: attention at offset 4, Mamba elsewhere; MoE
replaces the dense MLP on odd layers (period 2).  We use Mamba-2 mixers
(unified SSM substrate; Jamba ships Mamba-1 — recorded deviation).
Largest arch in the pool: bf16 optimizer moments (see DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    attn_period=8,
    attn_offset=4,
    moe_period=2,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    optimizer_moment_dtype="bfloat16",
    microbatches=8,  # §Perf A6: fits v5e HBM (EXPERIMENTS.md)
)

# The depth cut served at the published widths on one 80 GB card (one
# superblock of 8 layers is 90.3 GB in bf16): ``dataclasses.replace(CONFIG,
# **JAMBA_CUT)`` keeps every width and has the kinds of the superblock's
# layers 4 and 5, attention with a dense MLP, then a Mamba-2 mixer with the
# 16-expert MoE.  The one reduction is the interleave, 1:1 in place of 1:7,
# and the depth, 2 of 72 layers: 11,899,496,192 parameters, 23.8 GB in bf16.
JAMBA_CUT = dict(num_layers=2, attn_period=2, attn_offset=0)
