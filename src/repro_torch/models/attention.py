"""GQA attention: projections, prefill attention and cached decode
(port of ``repro.models.attention``).

* :func:`attention` — every multi-position call (prefill) goes through
  :func:`repro_torch.kernels.ops.flash_attention`: on the card the
  hand-written kernel, on the CPU its plain version.  The JAX package's
  ``full_attention`` and ``blockwise_attention`` compute this same function
  (causal GQA softmax attention, float32 softmax) and differ only in
  schedule, so one kernel covers both branches of its dispatch.
* :func:`decode_attention` — one query position against the KV cache, in
  plain PyTorch, as the JAX package computes it (no TPU kernel exists for
  it there).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import normal

_NEG = -1e30


def attention_params(cfg, *, generator, device, dtype) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(generator=generator, device=device, dtype=dtype)
    p = {
        "wq": normal((d, h * hd), d ** -0.5, **kw),
        "wk": normal((d, kv * hd), d ** -0.5, **kw),
        "wv": normal((d, kv * hd), d ** -0.5, **kw),
        "wo": normal((h * hd, d), (h * hd) ** -0.5, **kw),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
            p[name] = torch.zeros(width, device=device, dtype=dtype)
    return p


def qkv_project(p: dict, x: torch.Tensor, cfg, xkv: torch.Tensor | None = None):
    """x (B, S, d) -> q (B, S, H, D), k and v (B, T, KV, D): views of the
    projections, no copy.  K and V project ``xkv`` (B, T, d) where given
    (cross-attention), else x (T = S)."""
    b, s, _ = x.shape
    xkv = x if xkv is None else xkv
    t = xkv.shape[1]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"].to(x.dtype)
    k = xkv @ p["wk"].to(x.dtype)
    v = xkv @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    return q.view(b, s, h, hd), k.view(b, t, kv, hd), v.view(b, t, kv, hd)


def out_project(p: dict, o: torch.Tensor) -> torch.Tensor:
    b, s, h, hd = o.shape
    return o.reshape(b, s, h * hd) @ p["wo"].to(o.dtype)


def attention(q, k, v, *, causal: bool, use_kernel="auto") -> torch.Tensor:
    """q (B, S, H, D), k/v (B, T, KV, D) -> (B, S, H, D)."""
    return ops.flash_attention(q, k, v, causal=causal, use_kernel=use_kernel)


def decode_attention(q, k_cache, v_cache, pos: int | None = None) -> torch.Tensor:
    """q (B, 1, H, D) against a cache (B, T, KV, D) -> (B, 1, H, D).

    ``pos`` (the decode cursor) masks cache slots past it, so a cache
    allocated to the generation budget attends only to written slots.
    """
    b, _, h, d = q.shape
    kvh = k_cache.shape[2]
    qg = q.reshape(b, 1, kvh, h // kvh, d) * (d ** -0.5)
    sc = torch.einsum("bskgd,btkd->bkgst", qg, k_cache).to(torch.float32)
    if pos is not None:
        kpos = torch.arange(k_cache.shape[1], device=q.device)
        sc = sc.masked_fill(kpos > pos, _NEG)
    probs = torch.softmax(sc, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v_cache)
    return out.reshape(b, 1, h, d)
