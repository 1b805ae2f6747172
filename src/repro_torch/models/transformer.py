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


class CacheBlock(dict):
    """A position's cache of one layer on a model mesh: leaf name -> the
    block of it the position holds, and ``specs``: leaf name -> the
    :class:`~repro_torch.dist.sharding.PartitionSpec` laying the whole leaf
    out over the mesh (``cache_specs``), so the blocks of every position
    make the whole (:func:`~repro_torch.models.model.gather_caches`)."""

    def __init__(self, leaves: dict, specs: dict):
        super().__init__(leaves)
        self.specs = dict(specs)


def cross_spec(spec, length: int, mesh):
    """The spec of a cross-attention cache (``xk``, ``xv``) of ``length``
    encoder positions: the self-attention cache's ``spec``, its sequence
    whole where ``length`` does not divide over the sequence's axes (where
    JAX's ``NamedSharding(mesh, spec).shard_shape`` refuses it)."""
    if spec[1] is None or length % mesh_extent(mesh, spec[1]) == 0:
        return spec
    return type(spec)(spec[0], None, *spec[2:])


def query_heads(cfg, tp: int) -> int:
    """The query heads one position of a ``tp``-way ``model`` axis
    computes: ``H / tp`` where they divide (JAX's rule), else every head."""
    h = cfg.num_heads
    return h // tp if cfg.tp_style == "megatron" and tp > 1 and h % tp == 0 else h


def _heads_of(ctx, i: int, x: torch.Tensor, spec, n: int) -> torch.Tensor:
    """Position ``i``'s ``n`` heads of ``x`` (B, T, heads, D): ``x`` itself
    where it holds ``n``, else its ``j``-th group of ``n``, ``j`` the
    position's index along ``spec``'s head entry."""
    if x.shape[2] == n:
        return x
    j = flat_axis_index(ctx.coords[i], spec[2], ctx.mesh)
    return x[:, :, j * n:(j + 1) * n]


def _cache_write(ctx, i: int, cache: CacheBlock, key: str, x: torch.Tensor, start: int) -> None:
    """Write ``x`` (B, s, heads, D), the values of slots ``[start, start +
    s)``, into position ``i``'s block of the cache leaf ``key``: the
    block's KV heads, the slots of its sequence slice."""
    block, spec = cache[key], cache.specs[key]
    n = block.shape[1]
    x = _heads_of(ctx, i, x, spec, block.shape[2])
    lo = flat_axis_index(ctx.coords[i], spec[1], ctx.mesh) * n
    a, z = max(start, lo), min(start + x.shape[1], lo + n)
    if z > a:
        block[:, a - lo:z - lo] = x[:, a - start:z - start]


def _cross_block(ctx, i: int, x: torch.Tensor, spec, kv: int) -> torch.Tensor:
    """Position ``i``'s block of the cross-attention K or V ``x`` (B, T,
    heads, D) under ``spec``, ``kv`` heads a block."""
    x = _heads_of(ctx, i, x, spec, kv)
    if spec[1] is not None:
        n = x.shape[1] // mesh_extent(ctx.mesh, spec[1])
        lo = flat_axis_index(ctx.coords[i], spec[1], ctx.mesh) * n
        x = x[:, lo:lo + n].clone()
    return x


def _mesh_decode(m, q: list, caches: list, keys: tuple, pos: int | None) -> list:
    """One query a row against each position's cache block -> each
    position's (B, 1, heads, D) output at the query heads its block's KV
    heads read.  Where the blocks hold every KV head and a position's
    query heads are a share of them, ``q`` is gathered over ``model``
    first.  Where the spec shards the sequence over axes ``A`` each
    position attends over its slice and the partial softmaxes are combined
    over ``A`` in mesh order: ``M = pmax(m_j)``, ``l = psum(exp(m_j - M)
    l_j)``, ``o = psum(exp(m_j - M) o_j) / l``."""
    cfg, ctx = m.cfg, m.ctx
    kvh, g = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    k0 = caches[0][keys[0]]
    spec, kv = caches[0].specs[keys[0]], k0.shape[2]
    if kv == kvh and q[0].shape[2] < cfg.num_heads:  # a share of the query heads: all of them
        q = ctx.all_gather(q, ctx.model_axis, 2)
    qs = [_heads_of(ctx, i, x, spec, kv * g) for i, x in enumerate(q)]
    if spec[1] is None:
        return [attn_mod.decode_attention(x, c[keys[0]], c[keys[1]], pos)
                for x, c in zip(qs, caches)]
    n = k0.shape[1]
    parts = [attn_mod.decode_attention_partial(
        x, c[keys[0]], c[keys[1]], pos, flat_axis_index(ctx.coords[i], spec[1], ctx.mesh) * n)
        for i, (x, c) in enumerate(zip(qs, caches))]
    top = ctx.pmax([mj for _, mj, _ in parts], spec[1])
    scale = [torch.exp(mj - t) for (_, mj, _), t in zip(parts, top)]
    l_sum = ctx.psum([a * lj for a, (_, _, lj) in zip(scale, parts)], spec[1])
    o = ctx.psum([a * oj for a, (oj, _, _) in zip(scale, parts)], spec[1])
    return [(oi / li).to(x.dtype) for oi, li, x in zip(o, l_sum, qs)]


def mesh_attn(m, pre: str, hs: list, ropes: list | None, caches, pos, use_kernel, *,
              causal: bool = True, cross: bool = False, xkv: list | None = None,
              train: bool | None = None) -> list:
    """Attention on the mesh (``attn_block`` of the JAX package under its
    sharding rules) -> each position's share of the output projection,
    psummed over ``model``.

    Where the query heads divide by the model extent (``H % tp == 0``,
    ``tp > 1``) each position computes its ``H / tp`` heads: its columns of
    ``wq``; its KV heads when ``KV % tp == 0``, else every KV head (the K
    and V projections gathered over ``model``), repeated to its query heads
    (``attention.repeat_kv``) for the attention itself.  Otherwise every
    position computes every head.  Training (``train``, by default
    ``caches`` None) attends through ``train_attention`` on the position's
    heads, as the one-device ``train_loss`` does; prefill (``pos`` None)
    runs the flash kernel on the position's heads.

    ``caches`` holds each position's :class:`CacheBlock` of the layer: the
    block of ``(B, L, KV, D)`` that JAX's ``_cache_specs`` gives it, its
    rows, its ``KV / tp`` heads where they divide (else every KV head), and
    its slice of the sequence where the spec shards it (over ``model``,
    over the batch axes too where the batch did not divide).  Prefill
    writes each position the slots of ``[0, S)`` its slice holds; a decode
    step writes slot ``pos`` on the position whose slice holds it, then
    attends over each block (:func:`_mesh_decode`: the partial softmaxes
    of a sharded sequence combined over its axes).  ``wo`` is row parallel
    where its rows are sharded: each position's heads times its rows, the
    partials summed in mesh order.

    ``causal`` False is the encoder's attention and the cross-attention.
    ``cross`` is the decoder's cross-attention: K and V projected from the
    encoder states ``xkv`` (one tensor a position) with their biases, kept
    in the cache as ``xk`` / ``xv`` at prefill (the block the
    self-attention cache's spec gives them, the sequence whole where the
    encoder's length does not divide: :func:`cross_spec`); a decode step
    projects only its query and reads them.  Rotary positions apply to
    self-attention only.
    """
    cfg, ctx = m.cfg, m.ctx
    h, kvh, hd, tp, ax = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, ctx.tp, ctx.model_axis
    hq = query_heads(cfg, tp)
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
        if heads and kvh % tp:  # KV heads not whole on a position: every one of them
            k, v = (ctx.all_gather(x, ax, -1) if is_sharded(m.spec(pre + w), 1, ax) else x
                    for x, w in ((k, "wk"), (v, "wv")))
        k, v = ([x.view(bsz, t, -1, hd) for x in y] for y in (k, v))
    if cfg.use_rope and not cross:
        q = [rotate(x, *r) for x, r in zip(q, ropes)]
        k = [rotate(x, *r) for x, r in zip(k, ropes)]
    keys = ("xk", "xv") if cross else ("k", "v")
    if caches is not None and not train:
        for i, c in enumerate(caches):
            if cross and pos is None:
                spec = cross_spec(c.specs["k"], k[i].shape[1], ctx.mesh)
                kv = c["k"].shape[2]
                c["xk"], c["xv"] = (_cross_block(ctx, i, x[i], spec, kv) for x in (k, v))
                c.specs["xk"] = c.specs["xv"] = spec
            elif not cross:
                for key, x in zip(keys, (k, v)):
                    _cache_write(ctx, i, c, key, x[i], 0 if pos is None else pos)
    if pos is not None and not train:
        outs = _mesh_decode(m, q, caches, keys, None if cross else pos)
        if outs[0].shape[2] != hq:  # the block's query heads -> this position's
            if outs[0].shape[2] == h:
                outs = [o[:, :, j * hq:(j + 1) * hq] for o, j in zip(outs, ctx.model_index)]
            else:
                outs = ctx.all_gather(outs, ax, 2)
        outs = [o.reshape(bsz, s, hq * hd) for o in outs]
    else:
        if heads and kvh % tp:  # repeated to the position's query heads
            k, v = ([attn_mod.repeat_kv(x, h // kvh)[:, :, j * hq:(j + 1) * hq]
                     for x, j in zip(y, ctx.model_index)] for y in (k, v))
        outs = []
        for i in range(ctx.n):
            if train:  # the JAX package's attention, no kernel
                o = attn_mod.train_attention(q[i], k[i], v[i], causal=causal, cfg=cfg)
            else:
                o = attn_mod.attention(q[i], k[i], v[i], causal=causal, use_kernel=use_kernel)
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
