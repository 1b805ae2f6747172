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

On a mesh (:class:`RunCtx`, :func:`mesh_block_apply`) every family runs
tensor parallel: every value is a list with one tensor a mesh
position, and the collectives between them are explicit tensor operations
in mesh order (a psum is a sum, an all-gather a ``cat``, a move between
devices a ``.to``), differentiable as they stand: a meshed layer trains
under autograd and :func:`remat` as a one-device layer does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt_mod

from repro_torch.analysis.op_analysis import report_collective
from repro_torch.dist.sharding import flat_axis_index, mesh_extent, psum
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import linear, mlp_apply, norm_apply
from repro_torch.models.mamba import mamba_apply, mesh_mamba
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


# -- the model mesh ------------------------------------------------------------


class RunCtx:
    """Where a meshed model runs (port of the JAX ``RunCtx``): the mesh, the
    batch axes present (``pod``, ``data``) and the ``model`` axis (None
    without one), with the collectives between positions.

    A value of a meshed model is a list, one tensor a position in the
    mesh's row-major order.  Each collective runs once a group (the
    positions that differ only along its axes), in mesh order, on the
    group's first device, and hands every member its result with ``.to``:
    positions that repeat a device share one tensor.
    """

    def __init__(self, mesh, batch_axes=("pod", "data"), model_axis="model", gather_axes=None):
        self.mesh = mesh
        self.batch_axes = tuple(a for a in batch_axes if a in mesh.shape)
        # the axes weights sharded over ``data`` (fsdp) are gathered over at
        # their use: the batch axes, unless the batch is replicated over them
        self.gather_axes = self.batch_axes if gather_axes is None else tuple(gather_axes)
        self.model_axis = model_axis if model_axis in mesh.shape else None
        self.n_batch = mesh_extent(mesh, self.batch_axes)
        self.tp = mesh_extent(mesh, self.model_axis)
        self.shape = mesh.devices.shape
        self.devices = list(mesh.devices.flat)
        self.n = len(self.devices)
        self.coords = [dict(zip(mesh.axis_names, c)) for c in np.ndindex(self.shape)]
        self.batch_index = [flat_axis_index(c, self.batch_axes, mesh) for c in self.coords]
        self.model_index = [flat_axis_index(c, self.model_axis, mesh) for c in self.coords]

    def group(self, i: int, axes) -> list:
        """The positions through ``i`` along ``axes``, in mesh order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        base = [self.coords[i][a] for a in self.mesh.axis_names]
        at = [self.mesh.axis_names.index(a) for a in axes]
        out = []
        for combo in np.ndindex(*[self.shape[k] for k in at]):
            pos = list(base)
            for k, c in zip(at, combo):
                pos[k] = c
            out.append(int(np.ravel_multi_index(pos, self.shape)))
        return out

    def _groupwise(self, vals: list, axes, fn, kind: str, shared: bool = True,
                   backward: bool = True) -> list:
        """``fn(members' values, first device) -> one result per member``,
        once a group; each group's collective of ``kind`` is reported to
        the open cost counter (:func:`~repro_torch.analysis.op_analysis
        .report_collective`: ``shared`` when the members share one result)."""
        out = [None] * self.n
        for i in range(self.n):
            if out[i] is None:
                g = self.group(i, axes)
                res = fn([vals[j] for j in g], self.devices[g[0]])
                report_collective(kind, res, len(g), self.n, shared=shared, first=i == 0,
                                  backward=backward)
                for j, r in zip(g, res):
                    out[j] = r.to(self.devices[j])
        return out

    def psum(self, vals: list, axes) -> list:
        """The sum over ``axes``, in mesh order."""
        return self._groupwise(vals, axes, lambda parts, dev: [psum(parts, dev)] * len(parts),
                               "all-reduce")

    def pmax(self, vals: list, axes) -> list:
        """The elementwise max over ``axes``."""
        def pmax(parts, dev):
            out = parts[0].to(dev)
            for p in parts[1:]:
                out = torch.maximum(out, p.to(dev))
            return [out] * len(parts)
        return self._groupwise(vals, axes, pmax, "all-reduce", backward=False)

    def all_gather(self, vals: list, axes, dim: int) -> list:
        """The members' values concatenated along ``dim``, in mesh order."""
        def gather(parts, dev):
            whole = parts[0] if len(parts) == 1 else torch.cat([p.to(dev) for p in parts], dim)
            return [whole] * len(parts)
        return self._groupwise(vals, axes, gather, "all-gather")

    def psum_scatter(self, vals: list, axes, dim: int) -> list:
        """The sum over ``axes``, member ``k`` of a group keeping chunk ``k``
        of ``dim``."""
        return self._groupwise(vals, axes, lambda parts, dev: psum(parts, dev).chunk(len(parts),
                                                                                      dim),
                               "reduce-scatter", shared=False)

    def all_to_all(self, vals: list, axes, split: int, concat: int) -> list:
        """Member ``k`` gets chunk ``k`` (of ``split``) of every member's
        value, concatenated along ``concat`` in mesh order (JAX's tiled
        ``all_to_all``)."""
        def a2a(parts, dev):
            chunks = [p.chunk(len(parts), split) for p in parts]
            return [torch.cat([c[k].to(dev) for c in chunks], concat) for k in range(len(parts))]
        return self._groupwise(vals, axes, a2a, "all-to-all", shared=False)

    def split_batch(self, x: torch.Tensor) -> list:
        """Each position's rows of the batch ``x`` (its batch shard), on its
        device.  A batch that does not divide by the batch axes raises, as
        JAX's ``shard_map`` does."""
        b = x.shape[0]
        if b % self.n_batch:
            raise ValueError(f"a batch of {b} rows does not divide over the batch axes "
                             f"{dict((a, self.mesh.shape[a]) for a in self.batch_axes)}")
        rows = b // self.n_batch
        return [x[k * rows:(k + 1) * rows].to(dev)
                for k, dev in zip(self.batch_index, self.devices)]

    def gather_batch(self, vals: list, device) -> torch.Tensor:
        """A value replicated over every axis but the batch axes, its batch
        shards concatenated in order on ``device``."""
        firsts = {}
        for i, k in enumerate(self.batch_index):
            firsts.setdefault(k, i)
        return torch.cat([vals[firsts[k]].to(device) for k in range(self.n_batch)], 0)


def is_sharded(spec, dim: int, axis) -> bool:
    """Whether ``spec`` shards dim ``dim`` over the mesh axis ``axis``."""
    return axis is not None and spec[dim] == axis


def attn_heads(cfg, tp: int) -> tuple[int, int]:
    """(query heads, cached KV heads) of one position of a ``tp``-way
    ``model`` axis: ``H / tp`` query heads where they divide (JAX's rule),
    with ``KV / tp`` KV heads where those divide too, else the ``H / tp``
    repeated heads they read; every head where ``H`` does not divide."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    if not (cfg.tp_style == "megatron" and tp > 1 and h % tp == 0):
        return h, kv
    return h // tp, (kv // tp if kv % tp == 0 else h // tp)


def mesh_attn(m, pre: str, hs: list, ropes: list | None, caches, pos, use_kernel, *,
              causal: bool = True, cross: bool = False, xkv: list | None = None,
              train: bool | None = None) -> list:
    """Attention on the mesh (``attn_block`` of the JAX package under its
    sharding rules) -> each position's share of the output projection,
    psummed over ``model``.

    Where the query heads divide by the model extent (``H % tp == 0``,
    ``tp > 1``) each position computes its ``H / tp`` heads: its columns of
    ``wq``; its KV heads when ``KV % tp == 0``, else the K and V projections
    gathered over ``model`` and repeated to the query heads
    (``attention.repeat_kv``), its heads of those.  Training (``train``,
    by default ``caches`` None) attends through ``train_attention`` on the
    position's heads, as the one-device ``train_loss`` does; prefill
    (``pos`` None) runs the flash kernel on the position's heads, writing
    its cache where ``caches`` holds one, and decode attends over the
    position's own cache, which holds the KV heads its query heads read:
    ``KV / tp`` heads, or ``H / tp`` repeated heads where ``KV % tp != 0``
    (JAX's ``_cache_specs`` shards such a cache's sequence over ``model``
    instead).  Otherwise every position computes every head.  ``wo`` is row
    parallel where its rows are sharded: each position's heads times its
    rows, the partials summed in mesh order.

    ``causal`` False is the encoder's attention and the cross-attention.
    ``cross`` is the decoder's cross-attention: K and V projected from the
    encoder states ``xkv`` (one tensor a position) with their biases, on the
    position's KV heads, and kept in the cache as ``xk`` / ``xv`` at
    prefill; a decode step projects only its query and reads them.  Rotary
    positions apply to self-attention only.
    """
    cfg, ctx = m.cfg, m.ctx
    h, kvh, hd, tp, ax = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, ctx.tp, ctx.model_axis
    hq = attn_heads(cfg, tp)[0]
    heads = hq < h
    train = caches is None and pos is None if train is None else train

    def project(w, b, src):
        out = [linear(x, wi) for x, wi in zip(src, m.weight(pre + w))]
        if cfg.qkv_bias:
            out = [o + bi.to(o.dtype) for o, bi in zip(out, m.weight(pre + b))]
        if not heads and is_sharded(m.spec(pre + w), 1, ax):
            out = ctx.all_gather(out, ax, -1)
        return out

    bsz, s = hs[0].shape[:2]
    q = [t.view(bsz, s, hq, hd) for t in project("wq", "bq", hs)]
    k = v = [None] * ctx.n  # a cross-attention decode step reads its K and V from the cache
    if not (cross and pos is not None):
        src = xkv if cross else hs
        t = src[0].shape[1]
        k, v = project("wk", "bk", src), project("wv", "bv", src)
        if heads and kvh % tp:  # KV heads not whole on a position: gather, repeat
            k, v = (ctx.all_gather(x, ax, -1) if is_sharded(m.spec(pre + w), 1, ax) else x
                    for x, w in ((k, "wk"), (v, "wv")))
            k, v = ([attn_mod.repeat_kv(x.view(bsz, t, kvh, hd), h // kvh)
                     [:, :, j * hq:(j + 1) * hq] for x, j in zip(y, ctx.model_index)]
                    for y in (k, v))
        else:
            k, v = ([x.view(bsz, t, -1, hd) for x in y] for y in (k, v))
    if cfg.use_rope and not cross:
        q = [rotate(x, *r) for x, r in zip(q, ropes)]
        k = [rotate(x, *r) for x, r in zip(k, ropes)]
    outs = []
    for i in range(ctx.n):
        if train:  # the JAX package's attention, no kernel
            o = attn_mod.train_attention(q[i], k[i], v[i], causal=causal, cfg=cfg)
        elif cross:
            if pos is None:
                caches[i]["xk"], caches[i]["xv"] = k[i], v[i]
                o = attn_mod.attention(q[i], k[i], v[i], causal=causal, use_kernel=use_kernel)
            else:
                o = attn_mod.decode_attention(q[i], caches[i]["xk"], caches[i]["xv"])
        else:
            start = 0 if pos is None else pos
            if caches is not None:
                caches[i]["k"][:, start:start + s] = k[i]
                caches[i]["v"][:, start:start + s] = v[i]
            if pos is None:
                o = attn_mod.attention(q[i], k[i], v[i], causal=causal, use_kernel=use_kernel)
            else:
                o = attn_mod.decode_attention(q[i], caches[i]["k"], caches[i]["v"], pos)
        outs.append(o.reshape(bsz, s, hq * hd))
    row = is_sharded(m.spec(pre + "wo"), 0, ax)
    if row and not heads:  # every head here, a row shard of wo: its heads' columns
        width = h * hd // tp
        outs = [o[..., j * width:(j + 1) * width] for o, j in zip(outs, ctx.model_index)]
    partial = [o @ w.to(o.dtype) for o, w in zip(outs, m.weight(pre + "wo"))]
    return ctx.psum(partial, ax) if row else partial


def mesh_mlp(m, pre: str, hs: list) -> list:
    """The MLP: its first products (``gate`` and ``up``, or ``in`` and its
    bias) column parallel on ``ff``, the last (``down`` or ``out``) row
    parallel, its partials psummed over ``model``, then the output bias
    (all replicated where ``d_ff`` does not divide)."""
    cfg, ctx = m.cfg, m.ctx
    if cfg.mlp_gated:
        gate, up, down = (m.weight(pre + n) for n in ("gate", "up", "down"))
        partial = [linear(F.silu(linear(x, g)) * linear(x, u), d)
                   for x, g, u, d in zip(hs, gate, up, down)]
        last = "down"
    else:
        w_in, b_in, w_out = (m.weight(pre + n) for n in ("in", "b_in", "out"))
        # jax.nn.gelu defaults to the tanh approximation.
        partial = [linear(F.gelu(linear(x, wi, bi), approximate="tanh"), wo)
                   for x, wi, bi, wo in zip(hs, w_in, b_in, w_out)]
        last = "out"
    if is_sharded(m.spec(pre + last), 0, ctx.model_axis):
        partial = ctx.psum(partial, ctx.model_axis)
    if cfg.mlp_gated:
        return partial
    return [y + b.to(y.dtype) for y, b in zip(partial, m.weight(pre + "b_out"))]


def mesh_norm(m, name: str, xs: list) -> list:
    """The norm ``name`` (a weight prefix) of a meshed model on each
    position's residual."""
    cfg = m.cfg
    return [norm_apply(p, x, cfg.norm_type, cfg.norm_eps) for x, p in zip(xs, m.weights(name))]


def mesh_block_apply(m, l: int, xs: list, kind: str, ffn_kind: str, ropes: list, caches: list,
                     pos: int | None, use_kernel="auto") -> list:
    """Layer ``l`` of a meshed model on the per-position residual ``xs``,
    replicated over ``model``: the mixer of ``kind`` (``attn``:
    :func:`mesh_attn`, ``ssm``: :func:`~repro_torch.models.mamba.mesh_mamba`),
    then the FFN of ``ffn_kind`` -> (the new residual, each position's MoE
    load-balance loss, averaged over the expert-parallel blocks; float32
    zeros but for MoE).  ``caches`` holds each position's cache of the layer
    (None: training, no cache); ``pos`` None is prefill."""
    pre = f"layers.{l}."
    hs = mesh_norm(m, pre + "ln1", xs)
    if kind == "attn":
        mix = mesh_attn(m, pre + "attn.", hs, ropes, caches, pos, use_kernel)
    else:
        mix = mesh_mamba(m, pre + "ssm.", hs, caches, pos)
    xs = [x + y for x, y in zip(xs, mix)]
    aux = [torch.zeros((), dtype=torch.float32, device=x.device) for x in xs]
    if ffn_kind == "none":
        return xs, aux
    hs = mesh_norm(m, pre + "ln2", xs)
    if ffn_kind == "moe":
        ys, aux = moe_mod.moe_apply(m, pre + "moe.", hs)
    else:
        ys = mesh_mlp(m, pre + "mlp.", hs)
    return [x + y for x, y in zip(xs, ys)], aux
