"""Three-term roofline model of a dry-run cell (port of
``repro.analysis.roofline``, the arithmetic in the same order, so the counts
are bitwise the JAX package's).

Per (arch x shape x mesh) cell::

    compute_s    = flops_per_device    / PEAK_FLOPS
    memory_s     = bytes_per_device    / HBM_BW
    collective_s = collective_bytes_pd / LINK_BW    # per-device operand
                                                     # bytes over one link

The dry run (:mod:`repro_torch.launch.dryrun`) counts the per-device flops,
bytes and collective operand bytes of the port's eager step
(:mod:`repro_torch.analysis.op_analysis`).  ``model_flops`` is the analytic
useful-work count (6 N_active D train, 2 N_active D inference, plus the
attention/SSD mixing terms); the ratio of it to the counted flops exposes
the remat's recompute and sharding-induced redundancy.

Hardware constants: one NVIDIA H100 SXM5 80GB, from NVIDIA's H100 data sheet:

* ``PEAK_FLOPS = 989e12``: dense bf16 tensor-core flop/s (the data sheet's
  1,979 TFLOP/s is with 2:4 sparsity), the rate PERF.md's bounds use;
* ``HBM_BW = 3.35e12``: HBM3 bytes/s;
* ``LINK_BW = 50e9``: the link a production mesh's collective groups
  cross.  The (16, 16) mesh is 256 cards, 32 nodes of 8; its 16-wide
  ``model`` axis spans two nodes, so a ring over it crosses the nodes'
  InfiniBand: one 400 Gb/s NDR port a card, 50 GB/s.  (Within a node,
  NVLink 4 gives 450 GB/s a direction; the slowest link a ring crosses
  sets its rate.)
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig

PEAK_FLOPS = 989e12  # dense bf16 flop/s per card (H100 SXM5)
HBM_BW = 3.35e12  # bytes/s per card (HBM3)
LINK_BW = 50e9  # bytes/s: one 400 Gb/s NDR InfiniBand port a card


# ---------------------------------------------------------------------------
# analytic parameter / FLOP counts
# ---------------------------------------------------------------------------

def _mamba_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    heads = d_in // cfg.ssm_headdim
    groups = max(1, cfg.num_kv_heads) if cfg.family == "ssm" else 1
    # mirror repro.models.mamba.mamba_dims (groups=1 there)
    return d_in, heads, 1


def _layer_param_counts(cfg: ModelConfig, l: int) -> tuple[float, float]:
    """(total, active) matmul params of layer ``l`` (biases/norms ignored)."""
    d, hd = cfg.d_model, cfg.head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    total = active = 0.0
    if cfg.layer_kind(l) == "attn":
        qkv = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
        total += qkv
        active += qkv
    else:
        d_in, heads, g = _mamba_dims(cfg)
        s = cfg.ssm_state
        inp = d * (2 * d_in + 2 * g * s + heads)  # in_proj (zxBCdt fused)
        out = d_in * d
        total += inp + out
        active += inp + out
    fk = cfg.ffn_kind(l)
    if fk == "dense":
        m = (3 if cfg.mlp_gated else 2) * d * cfg.d_ff
        total += m
        active += m
    elif fk == "moe":
        e_par = 3 * d * cfg.d_ff  # gated expert
        total += cfg.num_experts * e_par + d * cfg.num_experts
        active += (
            (cfg.experts_per_token + cfg.num_shared_experts) * e_par
            + d * cfg.num_experts
        )
    return total, active


def param_counts(cfg: ModelConfig) -> tuple[float, float]:
    """(total, active) matmul params incl. unembed, excl. embedding gather."""
    if cfg.is_encdec:
        d, hd, h = cfg.d_model, cfg.head_dim, cfg.num_heads
        attn = 4 * d * h * hd
        mlp = 2 * d * cfg.d_ff  # whisper: GELU, 2 matmuls
        enc = cfg.encoder_layers * (attn + mlp)
        dec = cfg.decoder_layers * (2 * attn + mlp)  # self + cross
        unemb = d * cfg.vocab_size
        n = enc + dec + unemb
        return n, n
    total = active = 0.0
    for l in range(cfg.num_layers):
        t, a = _layer_param_counts(cfg, l)
        total += t
        active += a
    if not cfg.tie_embeddings:
        total += cfg.d_model * cfg.vocab_size
        active += cfg.d_model * cfg.vocab_size
    else:
        # tied: the unembed matmul still runs
        active += cfg.d_model * cfg.vocab_size
        total += cfg.d_model * cfg.vocab_size
    return total, active


def _mixing_flops_per_layer(
    cfg: ModelConfig, l: int, batch: int, s_q: int, s_kv: int, causal: bool
) -> float:
    """Forward FLOPs of the attention-score/SSD part (not projections)."""
    if cfg.layer_kind(l) == "attn":
        f = 4.0 * batch * s_q * s_kv * cfg.num_heads * cfg.head_dim
        if causal and s_q == s_kv:
            f *= 0.5
        return f
    d_in, heads, g = _mamba_dims(cfg)
    # SSD: state update + output contraction, ~6 flops per (channel, state)
    return 6.0 * batch * s_q * d_in * cfg.ssm_state


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic useful FLOPs of one step of this cell (global)."""
    b = shape.global_batch
    n_total, n_active = param_counts(cfg)
    if shape.kind == "train":
        tokens = b * shape.seq_len
        mix = sum(
            _mixing_flops_per_layer(cfg, l, b, shape.seq_len, shape.seq_len, True)
            for l in range(cfg.num_layers if not cfg.is_encdec else 0)
        )
        if cfg.is_encdec:
            mix = cfg.encoder_layers * _mixing_flops_per_layer(
                cfg, 0, b, shape.seq_len, shape.seq_len, False
            ) + cfg.decoder_layers * (
                _mixing_flops_per_layer(cfg, 0, b, shape.seq_len, shape.seq_len, True)
                + _mixing_flops_per_layer(cfg, 0, b, shape.seq_len, shape.seq_len, False)
            )
        return 6.0 * n_active * tokens + 3.0 * mix
    if shape.kind == "prefill":
        tokens = b * shape.seq_len
        mix = sum(
            _mixing_flops_per_layer(cfg, l, b, shape.seq_len, shape.seq_len, True)
            for l in range(cfg.num_layers if not cfg.is_encdec else 0)
        )
        if cfg.is_encdec:
            mix = cfg.encoder_layers * _mixing_flops_per_layer(
                cfg, 0, b, shape.seq_len, shape.seq_len, False
            ) + cfg.decoder_layers * (
                _mixing_flops_per_layer(cfg, 0, b, shape.seq_len, shape.seq_len, True)
                + _mixing_flops_per_layer(cfg, 0, b, shape.seq_len, shape.seq_len, False)
            )
        return 2.0 * n_active * tokens + mix
    # decode: one token per sequence against an S-long cache/state
    mix = sum(
        _mixing_flops_per_layer(cfg, l, b, 1, shape.seq_len, False)
        for l in range(cfg.num_layers if not cfg.is_encdec else 0)
    )
    if cfg.is_encdec:
        mix = cfg.decoder_layers * 2 * _mixing_flops_per_layer(
            cfg, 0, b, 1, shape.seq_len, False
        )
    return 2.0 * n_active * b + mix


# ---------------------------------------------------------------------------
# the three terms
# ---------------------------------------------------------------------------

def roofline_terms(
    *,
    flops_per_device: float,
    bytes_per_device: float,
    collective_operand_bytes: float,
    n_devices: int,
    model_flops_global: float,
) -> dict:
    compute_s = flops_per_device / PEAK_FLOPS
    memory_s = bytes_per_device / HBM_BW
    collective_s = collective_operand_bytes / LINK_BW
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
    }
    dominant = max(terms, key=terms.get)
    hlo_global = flops_per_device * n_devices
    bound_s = max(terms.values())
    useful = model_flops_global / hlo_global if hlo_global else 0.0
    # achievable MFU if the dominant term were perfectly overlapped with the
    # others: useful model flops / (bound time × fleet peak)
    mfu_bound = (
        model_flops_global / (bound_s * n_devices * PEAK_FLOPS)
        if bound_s > 0
        else 0.0
    )
    return {
        **terms,
        "dominant": dominant,
        "hlo_flops_global": hlo_global,
        "model_flops": model_flops_global,
        "useful_flops_ratio": useful,
        "roofline_mfu_bound": mfu_bound,
    }
