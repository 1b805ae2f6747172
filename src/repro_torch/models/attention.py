"""GQA attention: projections, prefill attention, training attention and
cached decode (port of ``repro.models.attention``).

* :func:`attention` — every multi-position call of serving (prefill) goes
  through :func:`repro_torch.kernels.ops.flash_attention`: on the card the
  hand-written kernel, on the CPU its plain version.  The kernel has no
  backward, and the wrapper raises when asked for a gradient.
* :func:`train_attention` — training's attention, the JAX package's own
  dispatch (``attention`` there): :func:`decode_attention` for one query,
  :func:`blockwise_attention` when the longer of S and T reaches
  ``cfg.blockwise_attn_threshold``, else :func:`full_attention`.  The JAX
  models compute these with jnp outside any Pallas kernel, and so does the
  port, in plain differentiable PyTorch: the products in the compute dtype,
  scores and softmax in float32.
* :func:`decode_attention` — one query position against the KV cache, in
  plain PyTorch, as the JAX package computes it (no TPU kernel exists for
  it there).  :func:`decode_attention_partial` is its share on one slice of
  a cache whose sequence a model mesh shards: the slices' partial softmaxes
  are combined over the positions holding them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import ParamDef

_NEG = -1e30


def attention_defs(cfg) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((d, h * hd), ("fsdp", "heads"), scale=d ** -0.5),
        "wk": ParamDef((d, kv * hd), ("fsdp", "kv_heads"), scale=d ** -0.5),
        "wv": ParamDef((d, kv * hd), ("fsdp", "kv_heads"), scale=d ** -0.5),
        "wo": ParamDef((h * hd, d), ("heads", "fsdp"), scale=(h * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h * hd,), ("heads",), init="zeros")
        defs["bk"] = ParamDef((kv * hd,), ("kv_heads",), init="zeros")
        defs["bv"] = ParamDef((kv * hd,), ("kv_heads",), init="zeros")
    return defs


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


def _split_gqa(q: torch.Tensor, num_kv: int) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, KV, G, D)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, num_kv, h // num_kv, d)


def repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, T, KV, D) -> (B, T, KV * groups, D): each KV head repeated for
    the ``groups`` query heads that read it (Megatron's KV replication, as
    the JAX package's ``repeat_kv``)."""
    if groups == 1:
        return k
    b, t, kv, d = k.shape
    return k[:, :, :, None, :].expand(b, t, kv, groups, d).reshape(b, t, kv * groups, d)


def full_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """q (B, S, H, D), k/v (B, T, KV, D) -> (B, S, H, D), the (S, T) scores
    materialised; causal query ``i`` sees keys ``<= i + T - S``."""
    b, s, h, d = q.shape
    qg = _split_gqa(q, k.shape[2]) * (d ** -0.5)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).to(torch.float32)
    if causal:
        t = k.shape[1]
        mask = torch.ones((s, t), dtype=torch.bool, device=q.device).tril(t - s)
        scores = scores.masked_fill(~mask, _NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, d)


def blockwise_attention(q, k, v, *, causal: bool, block_q: int = 1024,
                        block_kv: int = 1024) -> torch.Tensor:
    """Memory-efficient attention, q (B, S, H, D), k/v (B, T, KV, D): an
    online softmax over KV blocks for each query block, a causal query
    block scanning only the KV blocks it can see.  S and T must be
    multiples of their (clipped) block sizes, as the JAX package asserts."""
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    block_q, block_kv = min(block_q, s), min(block_kv, t)
    if s % block_q or t % block_kv:
        raise ValueError(f"blockwise attention: S={s}, T={t} are not multiples of the "
                         f"blocks ({block_q}, {block_kv})")
    nq, nkv = s // block_q, t // block_kv
    qg = _split_gqa(q, kvh) * (d ** -0.5)  # (B, S, KV, G, D)
    kb = k.reshape(b, nkv, block_kv, kvh, d)
    vb = v.reshape(b, nkv, block_kv, kvh, d)
    offset = t - s if causal else 0  # query i attends keys <= i + offset
    outs = []
    for qi in range(nq):
        q_blk = qg[:, qi * block_q:(qi + 1) * block_q]
        hi = min(nkv, -(-(offset + (qi + 1) * block_q) // block_kv)) if causal else nkv
        m = torch.full((b, kvh, g, block_q), -torch.inf, dtype=torch.float32, device=q.device)
        l_sum = torch.zeros((b, kvh, g, block_q), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kvh, g, block_q, d), dtype=q.dtype, device=q.device)
        for j in range(hi):
            sc = torch.einsum("bskgd,btkd->bkgst", q_blk, kb[:, j]).to(torch.float32)
            if causal:
                qpos = offset + qi * block_q + torch.arange(block_q, device=q.device)
                kpos = j * block_kv + torch.arange(block_kv, device=q.device)
                sc = sc.masked_fill(~(qpos[:, None] >= kpos[None, :]), _NEG)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l_sum = l_sum * alpha + p.sum(dim=-1)
            pv = torch.einsum("bkgst,btkd->bkgsd", p.to(q.dtype), vb[:, j])
            acc = acc * alpha[..., None].to(q.dtype) + pv
            m = m_new
        out = acc / torch.clamp(l_sum, min=1e-30)[..., None].to(q.dtype)
        outs.append(out.movedim(3, 1))  # (B, bq, KV, G, D)
    return torch.cat(outs, dim=1).reshape(b, s, h, d)


def train_attention(q, k, v, *, causal: bool, cfg) -> torch.Tensor:
    """The JAX package's attention dispatch (training and its oracle): one
    query against its keys, blockwise at or above
    ``cfg.blockwise_attn_threshold`` positions, else full."""
    if q.shape[1] == 1:
        return decode_attention(q, k, v)
    if max(q.shape[1], k.shape[1]) >= cfg.blockwise_attn_threshold:
        return blockwise_attention(q, k, v, causal=causal, block_q=cfg.attn_block_q,
                                   block_kv=cfg.attn_block_kv)
    return full_attention(q, k, v, causal=causal)


def decode_attention(q, k_cache, v_cache, pos: int | None = None) -> torch.Tensor:
    """q (B, 1, H, D) against a cache (B, T, KV, D) -> (B, 1, H, D).

    ``pos`` (the decode cursor) masks cache slots past it, so a cache
    allocated to the generation budget attends only to written slots.
    """
    b, _, h, d = q.shape
    qg = _split_gqa(q, k_cache.shape[2]) * (d ** -0.5)
    sc = torch.einsum("bskgd,btkd->bkgst", qg, k_cache).to(torch.float32)
    if pos is not None:
        kpos = torch.arange(k_cache.shape[1], device=q.device)
        sc = sc.masked_fill(kpos > pos, _NEG)
    probs = torch.softmax(sc, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v_cache)
    return out.reshape(b, 1, h, d)


def decode_attention_partial(q, k_block, v_block, pos: int | None = None, start: int = 0):
    """q (B, 1, H, D) against a slice of the cache, ``k_block`` / ``v_block``
    (B, n, KV, D) holding slots ``[start, start + n)`` -> ``(o, m, l)``:
    the float32 row maxima ``m`` (B, 1, H, 1) of the scores, slots past
    ``pos`` masked by ``_NEG``; ``l = sum exp(s - m)`` (B, 1, H, 1); and
    the unnormalised ``o = sum exp(s - m) v`` (B, 1, H, D), float32.

    Over slices ``j`` of one cache, with ``M = max_j m_j``,
    ``sum_j exp(m_j - M) o_j / sum_j exp(m_j - M) l_j`` is
    :func:`decode_attention` over the whole.  ``_NEG`` is finite, so a
    slice whose every slot is masked gives finite ``m_j`` (slot 0 is always
    written, so ``M`` is a real score and such a slice's weight is 0)."""
    b, _, h, d = q.shape
    qg = _split_gqa(q, k_block.shape[2]) * (d ** -0.5)
    sc = torch.einsum("bskgd,btkd->bkgst", qg, k_block).to(torch.float32)
    if pos is not None:
        kpos = start + torch.arange(k_block.shape[1], device=q.device)
        sc = sc.masked_fill(kpos > pos, _NEG)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l_sum = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgst,btkd->bskgd", p.to(v_block.dtype), v_block).to(torch.float32)

    def rows(x):  # (B, KV, G, 1, 1) -> (B, 1, H, 1)
        return x.permute(0, 3, 1, 2, 4).reshape(b, 1, h, 1)

    return o.reshape(b, 1, h, d), rows(m), rows(l_sum)
