"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Backbone only (text stream); top-1 routing uses sigmoid gates as in the
Llama-4 router.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    num_experts=16,
    experts_per_token=1,
    num_shared_experts=1,
    router_softmax_topk=False,
    rope_theta=5e5,
    microbatches=4,  # §Perf A6: fits v5e HBM (EXPERIMENTS.md)
    optimizer_moment_dtype="bfloat16",
)
