"""Decoder blocks of every decoder-only family (port of
``repro.models.transformer``).

A block is a pre-norm mixer, attention (``attn``) or Mamba-2 (``ssm``),
then a pre-norm FFN, dense (``dense``), mixture of experts (``moe``) or none
(``none``), each added to the residual stream.  :func:`group_pattern` gives
the (mixer, FFN) kinds of one group of layers: one layer for the uniform
families, ``attn_period`` layers for the hybrid (Jamba: attention at offset
4, MoE on odd layers).  Layer ``l`` has the kinds of position
``l % len(pattern)``.  The JAX package scans the groups with ``lax.scan``
over stacked weights; here the model loops over its layers in Python.
No mesh or sharding constraint exists (one device).

A block returns its MoE load-balance loss beside its output (0 for other
FFNs); training sums it over the layers in layer order, as the scan does.
Training calls a block without a cache: attention goes through
:func:`~repro_torch.models.attention.train_attention`, never the flash
kernel, and :func:`remat` wraps each layer as ``cfg.remat`` asks.

A layer's decode cache is ``{"k", "v"}`` of ``(B, L, KV, D)`` for attention,
allocated once at the wave's full length ``L`` (prompt plus new tokens) and
written in place: prefill fills slots ``[0, S)``, each decode step the slot
at its cursor.  (The JAX engine pads its immutable caches after prefill
instead.)  A Mamba layer's cache (:mod:`repro_torch.models.mamba`) is
replaced, entry by entry, by prefill and by every step.
"""

from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as ckpt_mod

from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import mlp_apply, norm_apply
from repro_torch.models.mamba import mamba_apply
from repro_torch.models.moe import moe_einsum
from repro_torch.models.rope import rotate


def group_pattern(cfg) -> list[tuple[str, str]]:
    """Static (mixer kind, FFN kind) pattern of one group of layers."""
    period = cfg.attn_period if cfg.family == "hybrid" else 1
    return [(cfg.layer_kind(j), cfg.ffn_kind(j)) for j in range(period)]


def attn_block(p, h: torch.Tensor, cfg, rope, cache: dict | None, pos: int | None,
               use_kernel="auto") -> torch.Tensor:
    """Project, rotate by ``rope`` (the (cos, sin) of ``rope_cos_sin``),
    then attend over the sequence without a cache (training), attend over
    the prompt (``pos`` None, prefill: K/V written to cache slots
    ``[0, S)``), or write this step's K/V at ``pos`` and attend over the
    cache (decode)."""
    q, k, v = attn_mod.qkv_project(p, h, cfg)
    if cfg.use_rope:
        q, k = rotate(q, *rope), rotate(k, *rope)
    if cache is None:
        return attn_mod.out_project(p, attn_mod.train_attention(q, k, v, causal=True, cfg=cfg))
    s = q.shape[1]
    start = 0 if pos is None else pos
    cache["k"][:, start:start + s] = k
    cache["v"][:, start:start + s] = v
    if pos is None:
        out = attn_mod.attention(q, k, v, causal=True, use_kernel=use_kernel)
    else:
        out = attn_mod.decode_attention(q, cache["k"], cache["v"], pos)
    return attn_mod.out_project(p, out)


def block_apply(p, x: torch.Tensor, cfg, kind: str, ffn_kind: str, rope, cache: dict | None,
                pos: int | None, use_kernel="auto"):
    """One block: x -> x + mixer(norm(x)) -> + ffn(norm(.)) -> (x, the
    float32 load-balance loss, 0 but for MoE).  ``cache`` None is training;
    with a cache ``pos`` None is prefill (the cache filled), an int a decode
    step at that cursor."""
    h = norm_apply(p["ln1"], x, cfg.norm_type, cfg.norm_eps)
    if kind == "attn":
        x = x + attn_block(p["attn"], h, cfg, rope, cache, pos, use_kernel)
    elif cache is None:
        x = x + mamba_apply(p["ssm"], h, cfg=cfg)[0]
    else:
        mix, new = mamba_apply(p["ssm"], h, cfg=cfg, cache=None if pos is None else cache,
                               collect=True)
        cache.update(new)
        x = x + mix
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn_kind == "none":
        return x, aux
    h2 = norm_apply(p["ln2"], x, cfg.norm_type, cfg.norm_eps)
    if ffn_kind == "moe":
        y, aux = moe_einsum(p["moe"], h2, cfg=cfg)
        return x + y, aux
    return x + mlp_apply(p["mlp"], h2, gated=cfg.mlp_gated), aux


# Products without batch dimensions: a weight times the (B*S, d) rows.
# ``dots`` keeps their outputs, as JAX's ``dots_with_no_batch_dims_saveable``
# keeps its dot_generals without batch dims, and recomputes the rest.
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_PRODUCTS:
        return ckpt_mod.CheckpointPolicy.MUST_SAVE
    return ckpt_mod.CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, mode: str):
    """``fn`` under ``cfg.remat``: ``none`` keeps every activation, ``full``
    keeps only the inputs and recomputes the rest in the backward pass,
    ``dots`` keeps the weight products' outputs and recomputes the rest
    (``torch.utils.checkpoint``, non-reentrant).  The recomputation runs
    the same operations on the same inputs, so gradients are bitwise those
    of ``none``."""
    if mode == "none":
        return fn
    if mode == "full":
        return functools.partial(ckpt_mod.checkpoint, fn, use_reentrant=False)
    if mode == "dots":
        ctx = functools.partial(ckpt_mod.create_selective_checkpoint_contexts, _dots_policy)
        return functools.partial(ckpt_mod.checkpoint, fn, use_reentrant=False, context_fn=ctx)
    raise ValueError(f"remat must be none, dots or full; got {mode!r}")
