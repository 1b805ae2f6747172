"""whisper-tiny [audio]: enc-dec, conv frontend stubbed (frame embeddings).

4L (4 enc + 4 dec) d_model=384 6H (kv=6) d_ff=1536 vocab=51865
[arXiv:2212.04356; unverified]. LayerNorm + GELU MLP, absolute sinusoidal
positions (no RoPE), attention biases.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=8,          # 4 encoder + 4 decoder
    encoder_layers=4,
    decoder_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    qkv_bias=True,
    norm_type="ln",
    mlp_gated=False,
    use_rope=False,
    input_mode="embeddings",
    tie_embeddings=True,
)
