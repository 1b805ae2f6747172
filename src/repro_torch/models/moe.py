"""Mixture-of-Experts FFN, the one-device path (port of ``moe_einsum`` in
``repro.models.moe``).

The JAX package's ``moe_apply`` takes this path whenever there is no mesh
with a ``model`` axis, which is every serving and training call on one
card:

* ``_route``: float32 router logits, the top ``k`` experts a token (ties to
  the lower expert index, as ``lax.top_k`` breaks them), softmax over the
  top-k logits, or a sigmoid of each (``router_softmax_topk=False``,
  llama4);
* ``_dispatch_sorted``: a stable argsort of the ``T * k`` slots by expert;
  a slot's rank is its position minus its expert's first position, and
  slots ranked ``>= capacity`` are dropped (contribute nothing);
* ``_expert_ffn``: each expert's SwiGLU over its ``(capacity, d)`` tokens as
  batched products (``torch.bmm``) in the model dtype;
* the gated outputs added back to their tokens, plus llama4's shared expert.

The expert-parallel ``shard_map`` path waits for the model-parallel mesh
(ROADMAP.md §1 item 2).  :func:`moe_dense_reference` is the plain version every
expert computes densely, for the tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import normal


def moe_params(cfg, *, generator, device, dtype) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    kw = dict(generator=generator, device=device, dtype=dtype)
    p = {"router": normal((d, e), d ** -0.5, **kw),
         "gate": normal((e, d, f), d ** -0.5, **kw),
         "up": normal((e, d, f), d ** -0.5, **kw),
         "down": normal((e, f, d), f ** -0.5, **kw)}
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared_gate"] = normal((d, fs), d ** -0.5, **kw)
        p["shared_up"] = normal((d, fs), d ** -0.5, **kw)
        p["shared_down"] = normal((fs, d), fs ** -0.5, **kw)
    return p


def _route(x2d: torch.Tensor, wr: torch.Tensor, k: int, softmax_topk: bool):
    """-> (ids (T, k) int64, gates (T, k) float32, probs (T, E) float32)."""
    logits = x2d.to(torch.float32) @ wr.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    # A stable descending sort puts the lower index first among equal
    # logits, as lax.top_k does (torch.topk promises no order on ties).
    top_vals, top_ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_vals, top_ids = top_vals[:, :k], top_ids[:, :k]
    gates = torch.softmax(top_vals, dim=-1) if softmax_topk else torch.sigmoid(top_vals)
    return top_ids, gates, probs


def _capacity(tokens: int, k: int, e: int, factor: float) -> int:
    c = int(tokens * k / e * factor) + 1
    return max(8, -(-c // 8) * 8)  # rounded up to a multiple of 8


def _dispatch_sorted(ids: torch.Tensor, gates: torch.Tensor, e: int, cap: int):
    """Sort-based capacity dispatch -> buf_tok (E, C) int32 token index or
    -1, buf_gate (E, C) float32 (0 where empty)."""
    t, k = ids.shape
    flat_e = ids.reshape(t * k)
    order = torch.argsort(flat_e, stable=True)  # slots grouped by expert
    sorted_e = flat_e[order]
    group_start = torch.searchsorted(sorted_e, torch.arange(e, device=ids.device))
    pos = torch.arange(t * k, device=ids.device) - group_start[sorted_e]
    keep = pos < cap
    # Kept slots own distinct (expert, rank) cells: a write each; dropped
    # slots go to a row past the end, cut off below.
    row = torch.where(keep, sorted_e, e)
    col = torch.where(keep, pos, 0)
    buf_tok = torch.full((e + 1, cap), -1, dtype=torch.int32, device=ids.device)
    buf_gate = torch.zeros((e + 1, cap), dtype=torch.float32, device=ids.device)
    buf_tok[row, col] = (order // k).to(torch.int32)
    buf_gate[row, col] = gates.reshape(t * k)[order].to(torch.float32)
    return buf_tok[:e], buf_gate[:e]


def _expert_ffn(xe: torch.Tensor, p, dtype) -> torch.Tensor:
    """(E, C, d) tokens through each expert's SwiGLU -> (E, C, d)."""
    g = F.silu(torch.bmm(xe, p["gate"].to(dtype)))
    h = g * torch.bmm(xe, p["up"].to(dtype))
    return torch.bmm(h, p["down"].to(dtype))


def _aux_loss(probs: torch.Tensor, ids: torch.Tensor, e: int) -> torch.Tensor:
    """Switch/GShard load-balance loss: ``E * sum_e f_e * p_e``."""
    f = F.one_hot(ids[:, 0], e).to(torch.float32).mean(dim=0)
    return e * torch.sum(f * probs.mean(dim=0))


def _shared_ffn(p, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ p["shared_gate"].to(x.dtype))
    h = g * (x @ p["shared_up"].to(x.dtype))
    return h @ p["shared_down"].to(x.dtype)


def moe_einsum(p, x: torch.Tensor, *, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), the float32 load-balance loss).  Serving
    discards the loss; training sums it over layers into its aux loss.
    Differentiable: the buffers written by index are fresh tensors, and the
    gates reach the router's weights through the top-k softmax."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    cap = _capacity(t, k, e, cfg.capacity_factor)
    x2d = x.reshape(t, d)
    ids, gates, probs = _route(x2d, p["router"], k, cfg.router_softmax_topk)
    buf_tok, buf_gate = _dispatch_sorted(ids, gates, e, cap)
    filled = (buf_tok >= 0)[..., None]
    src = buf_tok.clamp(min=0).long()
    xe = torch.where(filled, x2d[src], 0)
    ye = _expert_ffn(xe, p, x.dtype)
    contrib = torch.where(filled, ye * buf_gate[..., None].to(ye.dtype), 0)
    y2d = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    y2d.index_add_(0, src.reshape(-1), contrib.reshape(e * cap, d))
    y = y2d.reshape(b, s, d)
    if cfg.num_shared_experts:
        y = y + _shared_ffn(p, x)
    return y, _aux_loss(probs, ids, e)


def moe_dense_reference(p, x: torch.Tensor, *, cfg) -> torch.Tensor:
    """Every expert on every token, weighted by the router's gates (tests)."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    ids, gates, _ = _route(x2d, p["router"], cfg.experts_per_token, cfg.router_softmax_topk)
    y = torch.zeros_like(x2d)
    for e_idx in range(cfg.num_experts):
        g = F.silu(x2d @ p["gate"][e_idx].to(x.dtype))
        h = g * (x2d @ p["up"][e_idx].to(x.dtype))
        ye = h @ p["down"][e_idx].to(x.dtype)
        w = ((ids == e_idx).to(torch.float32) * gates).sum(dim=1)
        y = y + ye * w[:, None].to(x.dtype)
    y = y.reshape(b, s, d)
    if cfg.num_shared_experts:
        y = y + _shared_ffn(p, x)
    return y
