"""mamba2-1.3b [ssm]: 48L d_model=2048 attention-free, d_ff=0,
vocab=50280, ssm_state=128, SSD (state-space duality)
[arXiv:2405.21060; unverified].

d_inner = 2*d_model = 4096, headdim 64 -> 64 SSM heads, ngroups=1.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=1,       # unused (attention-free)
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
)
