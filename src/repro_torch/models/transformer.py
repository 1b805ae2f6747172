"""Decoder blocks of the dense family (port of ``repro.models.transformer``).

One block is pre-norm attention then a pre-norm MLP, each added to the
residual stream.  The JAX package scans the blocks with ``lax.scan`` over
stacked weights; here the model loops over its layers in Python.  Serving
needs no mesh, sharding constraints or rematerialisation, so none exist.

The KV cache of a layer is ``{"k", "v"}`` of ``(B, L, KV, D)``, allocated
once at the wave's full length ``L`` (prompt plus new tokens) and written in
place: prefill fills slots ``[0, S)``, each decode step the slot at its
cursor.  (The JAX engine pads its immutable caches after prefill instead.)
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import mlp_apply, norm_apply
from repro_torch.models.rope import rotate


def attn_block(p, h: torch.Tensor, cfg, rope, cache: dict, pos: int | None,
               use_kernel="auto") -> torch.Tensor:
    """Project, rotate by ``rope`` (the (cos, sin) of ``rope_cos_sin``),
    then either attend over the prompt (``pos`` None, prefill: K/V written
    to cache slots ``[0, S)``) or write this step's K/V at ``pos`` and
    attend over the cache (decode)."""
    q, k, v = attn_mod.qkv_project(p, h, cfg)
    if cfg.use_rope:
        q, k = rotate(q, *rope), rotate(k, *rope)
    s = q.shape[1]
    start = 0 if pos is None else pos
    cache["k"][:, start:start + s] = k
    cache["v"][:, start:start + s] = v
    if pos is None:
        out = attn_mod.attention(q, k, v, causal=True, use_kernel=use_kernel)
    else:
        out = attn_mod.decode_attention(q, cache["k"], cache["v"], pos)
    return attn_mod.out_project(p, out)


def block_apply(p, x: torch.Tensor, cfg, rope, cache: dict, pos: int | None,
                use_kernel="auto") -> torch.Tensor:
    """One dense transformer block: x -> x + attn(norm(x)) -> + mlp(norm(.))."""
    h = norm_apply(p["ln1"], x, cfg.norm_type, cfg.norm_eps)
    x = x + attn_block(p["attn"], h, cfg, rope, cache, pos, use_kernel)
    h2 = norm_apply(p["ln2"], x, cfg.norm_type, cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h2, gated=cfg.mlp_gated)
