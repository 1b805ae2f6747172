"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, M-RoPE + dynamic resolution [arXiv:2409.12191; hf].

Vision frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings; M-RoPE (t, h, w) position streams are
first-class (sections 16/24/24 over head_dim/2 = 64 frequency slots).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    input_mode="embeddings",
    tie_embeddings=True,
)
