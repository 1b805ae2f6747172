"""Mixture-of-Experts FFN (port of ``repro.models.moe``): the one-device
``moe_einsum`` and, on a mesh, the expert-parallel ``moe_apply``.

One routing and dispatch core serves both:

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

``moe_apply`` runs a meshed model's MoE layer (the JAX ``moe_apply`` and
``_moe_body``).  A prefill whose sequence divides by the ``model`` extent
``ep`` takes the expert-parallel path: each (batch shard, sequence chunk)
position routes its own tokens with its own block's capacity, an
all-to-all moves the ``(E, C, d)`` dispatch to the experts' owners as
``(E/ep, ep*C, d)``, the f-sliced SwiGLU runs where the experts' ``d_ff``
shards lie on ``data`` (the tokens gathered over ``data``, the partial
outputs psum-scattered back), and a second all-to-all brings the outputs
home.  Under the sequence-parallel residual the position's slice is its
chunk already: it is taken as it is and its output stays on the slice.
Decode, and a sequence ``ep`` does not divide, keep ``moe_einsum``'s
semantics over the whole batch: one routing and dispatch, each position
running the experts (and ``d_ff`` slice) it stores, the partials summed in
mesh order.  :func:`moe_blockwise_reference` is those semantics on one
device, :func:`moe_dense_reference` the plain version every expert
computes densely; both are for the tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.analysis.op_analysis import charge_collective
from repro_torch.dist.sharding import flat_axis_index, mesh_extent, psum
from repro_torch.models.layers import ParamDef


def moe_defs(cfg) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    defs = {
        "router": ParamDef((d, e), ("fsdp", "none"), scale=d ** -0.5),
        # d_ff (not d_model) carries the data-axis storage split: the
        # expert-parallel prefill moves tokens to the weights' ff shards.
        "gate": ParamDef((e, d, f), ("experts", "none", "expert_ff"), scale=d ** -0.5),
        "up": ParamDef((e, d, f), ("experts", "none", "expert_ff"), scale=d ** -0.5),
        "down": ParamDef((e, f, d), ("experts", "expert_ff", "none"), scale=f ** -0.5),
    }
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        defs["shared_gate"] = ParamDef((d, fs), ("fsdp", "ff"), scale=d ** -0.5)
        defs["shared_up"] = ParamDef((d, fs), ("fsdp", "ff"), scale=d ** -0.5)
        defs["shared_down"] = ParamDef((fs, d), ("ff", "fsdp"), scale=fs ** -0.5)
    return defs


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


def _dispatch(x2d: torch.Tensor, p, cfg):
    """Route and dispatch ``x2d`` (T, d) -> (buf_tok, buf_gate, the
    dispatched tokens (E, C, d), ids, probs)."""
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = _capacity(x2d.shape[0], k, e, cfg.capacity_factor)
    ids, gates, probs = _route(x2d, p["router"], k, cfg.router_softmax_topk)
    buf_tok, buf_gate = _dispatch_sorted(ids, gates, e, cap)
    xe = torch.where((buf_tok >= 0)[..., None], x2d[buf_tok.clamp(min=0).long()], 0)
    return buf_tok, buf_gate, xe, ids, probs


def _combine(ye: torch.Tensor, buf_tok: torch.Tensor, buf_gate: torch.Tensor, t: int) -> torch.Tensor:
    """The gated expert outputs (E', C, d) added to their tokens -> (t, d)."""
    filled = (buf_tok >= 0)[..., None]
    contrib = torch.where(filled, ye * buf_gate[..., None].to(ye.dtype), 0)
    y2d = torch.zeros((t, ye.shape[-1]), dtype=ye.dtype, device=ye.device)
    return y2d.index_add_(0, buf_tok.clamp(min=0).long().reshape(-1),
                          contrib.reshape(-1, ye.shape[-1]))


def moe_einsum(p, x: torch.Tensor, *, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), the float32 load-balance loss).  Serving
    discards the loss; training sums it over layers into its aux loss.
    Differentiable: the buffers written by index are fresh tensors, and the
    gates reach the router's weights through the top-k softmax."""
    b, s, d = x.shape
    buf_tok, buf_gate, xe, ids, probs = _dispatch(x.reshape(b * s, d), p, cfg)
    y = _combine(_expert_ffn(xe, p, x.dtype), buf_tok, buf_gate, b * s).reshape(b, s, d)
    if cfg.num_shared_experts:
        y = y + _shared_ffn(p, x)
    return y, _aux_loss(probs, ids, cfg.num_experts)


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


def moe_apply(m, pre: str, hs: list, record: list | None = None):
    """The MoE layer ``pre`` of the meshed model ``m`` on each position's
    normed activations ``hs`` (B/n_batch, S, d), replicated over ``model``,
    or each position's sequence slice (B/n_batch, S/tp, d) where the
    residual is sequence-sharded (``ctx.seq``) -> (outputs in the layout of
    ``hs``, load-balance losses), one a position.  ``record``, where
    given, receives one dict a position of the expert-parallel path:
    its block's ``buf_tok``, ``tokens``, ``capacity`` and ``dropped`` slots."""
    ctx, s = m.ctx, hs[0].shape[1]
    if ctx.seq is None and (ctx.model_axis is None or s == 1 or s % ctx.tp):
        return _moe_whole_batch(m, pre, hs)
    return _moe_expert_parallel(m, pre, hs, record)


def _moe_expert_parallel(m, pre: str, hs: list, record):
    cfg, ctx = m.cfg, m.ctx
    sliced = ctx.seq is not None  # the residual's slices are the blocks already
    ax, ep, e = ctx.model_axis, ctx.tp, cfg.num_experts
    if m.spec(pre + "gate")[0] != ax or e % ep:
        raise ValueError(f"{e} experts do not shard over the {ep}-way model axis")
    mesh = ctx.mesh
    ff_axis = ("data" if cfg.fsdp and "data" in mesh.shape
               and cfg.d_ff % mesh.shape["data"] == 0 else None)
    # each position's block: its sequence chunk (JAX's in_specs P(batch, model))
    sl = hs[0].shape[1] if sliced else hs[0].shape[1] // ep
    xb = hs if sliced else [x[:, j * sl:(j + 1) * sl] for x, j in zip(hs, ctx.model_index)]
    router = m.weight(pre + "router")
    disp = [_dispatch(x.reshape(-1, cfg.d_model), {"router": r}, cfg) for x, r in zip(xb, router)]
    xe = [d[2] for d in disp]
    if ep > 1:  # tokens to the experts' owners: (E, C, d) -> (E/ep, ep*C, d)
        xe = ctx.all_to_all(xe, ax, 0, 1)
    if ff_axis is not None:  # every d_ff shard of an expert sees its tokens
        xe = ctx.all_gather(xe, ff_axis, 1)
    experts = zip(*(m.local(pre + n) for n in ("gate", "up", "down")))
    ye = [_expert_ffn(x, {"gate": g, "up": u, "down": dn}, x.dtype)
          for x, (g, u, dn) in zip(xe, experts)]
    if ff_axis is not None:  # sum the f-sliced partials, each shard its own tokens
        ye = ctx.psum_scatter(ye, ff_axis, 1)
    if ep > 1:
        ye = ctx.all_to_all(ye, ax, 1, 0)
    ys, aux = [], []
    shared = ([m.weight(pre + n, full=True) for n in ("shared_gate", "shared_up", "shared_down")]
              if cfg.num_shared_experts else None)
    for i, (x, (buf_tok, buf_gate, _, ids, probs), y) in enumerate(zip(xb, disp, ye)):
        t = x.shape[0] * sl
        out = _combine(y, buf_tok, buf_gate, t).reshape(x.shape)
        if shared is not None:
            out = out + _shared_ffn({"shared_gate": shared[0][i], "shared_up": shared[1][i],
                                     "shared_down": shared[2][i]}, x)
        ys.append(out)
        aux.append(_aux_loss(probs, ids, e))
        if record is not None:
            kept = int((buf_tok >= 0).sum())
            record.append(dict(buf_tok=buf_tok, tokens=t, capacity=buf_tok.shape[1],
                               dropped=t * cfg.experts_per_token - kept))
    reduce_axes = ctx.batch_axes + ((ax,) if ep > 1 else ())
    n_red = mesh_extent(mesh, reduce_axes)
    aux = [a / n_red for a in ctx.psum(aux, reduce_axes)] if reduce_axes else aux
    return (ys if sliced else ctx.all_gather(ys, ax, 1)), aux


def _moe_whole_batch(m, pre: str, hs: list):
    """``moe_einsum`` over the whole batch: routed and dispatched once (on
    the first position's device); each position runs the expert and
    ``d_ff`` shards it stores (a position whose shards another position
    already runs, a replica along an axis the experts do not use, runs
    nothing), and the partial outputs are summed in mesh order."""
    cfg, ctx = m.cfg, m.ctx
    dev = ctx.devices[0]
    x = ctx.gather_batch(hs, dev)
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    buf_tok, buf_gate, xe, ids, probs = _dispatch(x2d, {"router": m.weight(pre + "router")[0]},
                                                  cfg)
    spec = m.spec(pre + "gate")
    used = {a for a in spec if a is not None}
    e_ax = spec[0]
    partials = []
    local = [m.local(pre + n) for n in ("gate", "up", "down")]
    for i in range(ctx.n):
        if any(c for a, c in ctx.coords[i].items() if a not in used):
            continue  # a replica of shards another position runs
        lo, n_e = 0, cfg.num_experts
        if e_ax is not None:
            n_e //= mesh_extent(ctx.mesh, e_ax)
            lo = flat_axis_index(ctx.coords[i], e_ax, ctx.mesh) * n_e
        dv = ctx.devices[i]
        w = {"gate": local[0][i], "up": local[1][i], "down": local[2][i]}
        ye = _expert_ffn(xe[lo:lo + n_e].to(dv), w, x.dtype)
        partials.append(_combine(ye, buf_tok[lo:lo + n_e].to(dv), buf_gate[lo:lo + n_e].to(dv),
                                 b * s))
    y = psum(partials, dev)
    # every position takes part in the sum of the expert partials (an
    # all-reduce over the positions that ran them; the whole batch's rows)
    charge_collective("all-reduce", len(partials), y.numel() * y.element_size(), ctx.n, ctx.n)
    y = y.reshape(b, s, d)
    if cfg.num_shared_experts:
        shared = {n: m.weight(pre + n, full=True)[0]
                  for n in ("shared_gate", "shared_up", "shared_down")}
        y = y + _shared_ffn(shared, x)
    aux = _aux_loss(probs, ids, cfg.num_experts)
    return ctx.split_batch(y), [aux.to(dv) for dv in ctx.devices]


def moe_blockwise_reference(p, x: torch.Tensor, cfg, n_data: int, n_model: int):
    """The meshed MoE's semantics on one device (tests): where the
    expert-parallel path runs (``S > 1``, ``S % n_model == 0``),
    ``moe_einsum`` on each (batch shard, sequence chunk) block of ``x``
    (B, S, d), the ``n_data`` batch shards by ``n_model`` chunks, each with
    its own capacity; else ``moe_einsum`` over the whole batch.  -> (y, the
    load-balance loss averaged over the blocks)."""
    b, s, _ = x.shape
    if s == 1 or s % n_model:
        return moe_einsum(p, x, cfg=cfg)
    if b % n_data:
        raise ValueError(f"a batch of {b} rows does not divide over {n_data} data shards")
    rows, sl = b // n_data, s // n_model
    y = torch.empty_like(x)
    aux = []
    for i in range(n_data):
        for j in range(n_model):
            blk = (slice(i * rows, (i + 1) * rows), slice(j * sl, (j + 1) * sl))
            y[blk], a = moe_einsum(p, x[blk], cfg=cfg)
            aux.append(a)
    return y, torch.stack(aux).mean()
