"""qwen1.5-110b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].

§Perf hillclimb cell A (most collective-bound): the deployable train_4k
config is microbatches=8 + bf16 Adam moments + Megatron TP activations —
13.3 GiB/device on the single pod (fits v5e HBM) at a 0.38 roofline-MFU
bound.  ``tp_style="gather"`` with microbatches=1 is ~29% better on the
memory bound (0.54) but needs 45 GiB/device — see EXPERIMENTS.md §Perf.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    microbatches=8,
    optimizer_moment_dtype="bfloat16",
)
