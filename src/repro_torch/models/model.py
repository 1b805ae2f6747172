"""build_model(): a model of every family, served and trained (port of
``repro.models.model``).

:class:`DecoderLM` (dense, MoE, SSM, hybrid and VLM families) mirrors
``ModelBundle.prefill`` and ``serve_step``:

* ``prefill(tokens)`` or ``prefill(embeds=...)`` (the VLM and audio stub:
  precomputed input embeddings) -> (last-position logits ``(B, V)``,
  per-layer caches), the prompt's attention through the flash-attention
  kernel; ``positions`` default to ``0 .. S-1`` and may be ``(B, S, 3)``
  (t, h, w) ids under M-RoPE;
* ``serve_step(tokens, pos, caches)`` -> (logits ``(B, 1, V)``, caches),
  one decode step at cursor ``pos`` (broadcast to ``(B, 1, 3)`` under
  M-RoPE), the caches written in place.

* ``train_loss(batch, params)`` -> (loss, ``{"loss", "aux_loss"}``), the
  JAX ``train_loss``: next-token cross-entropy plus ``AUX_COEF`` times the
  MoE load-balance loss summed over layers.  The batch is JAX's
  ``input_specs``: ``tokens`` or ``embeds``, ``targets``, and optional
  ``positions`` (``(B, S, 3)`` under M-RoPE).  ``params`` is a flat
  name -> tensor dict (``flat_params``), so a train step differentiates
  tensors it owns; attention runs through ``train_attention`` (never the
  flash kernel, which has no backward), each layer under ``cfg.remat``.

The encoder-decoder family (Whisper) is :class:`repro_torch.models.encdec.EncDecLM`.
A served model stores its weights in the serving dtype (the JAX engine
keeps float32 weights and casts them at every use, which rounds to the same
values); a trained one keeps float32 weights and computes in ``cfg.dtype``
(``build_model(..., dtype=torch.float32, compute_dtype=...)``).
The vocabulary is padded to a multiple of 16 as the JAX package pads it.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import ShardedArray, mesh_extent, rules_for, spec_axes
from repro_torch.models.attention import attention_defs
from repro_torch.models.layers import (
    LMBase,
    ParamDef,
    Params,
    cross_entropy_loss,
    flatten_defs,
    materialize,
    mlp_defs,
    nest,
    norm_apply,
    norm_defs,
    param_specs,
    vocab_parallel_nll,
)
from repro_torch.models.mamba import mamba_cache, mamba_defs, mamba_dims
from repro_torch.models.moe import moe_defs
from repro_torch.models.rope import rope_cos_sin
from repro_torch.models.transformer import (
    CacheBlock,
    RunCtx,
    block_apply,
    group_pattern,
    is_sharded,
    mesh_block_apply,
    remat,
)

AUX_COEF = 0.01  # weight of the MoE load-balance loss in the training loss


def _pad_vocab(v: int, multiple: int = 16) -> int:
    return -(-v // multiple) * multiple


class DecoderLM(LMBase):
    """A decoder-only LM for serving (weights in one dtype, one device);
    ``kinds[l]`` is layer ``l``'s (mixer, FFN) kinds."""

    def __init__(self, cfg: ModelConfig, layers: list, top: dict):
        super().__init__()
        self.cfg = cfg
        pattern = group_pattern(cfg)
        self.kinds = [pattern[i % len(pattern)] for i in range(len(layers))]
        self.layers = nn.ModuleList(Params(p) for p in layers)
        self.top = Params(top)

    def param_defs(self) -> dict:
        """name -> :class:`ParamDef` of every weight."""
        return flatten_defs(decoder_defs(self.cfg))

    def new_caches(self, batch: int, length: int, device=None) -> list:
        """Zeroed per-layer caches: ``{"k", "v"}`` of ``(B, length, KV, D)``
        for attention (zeros, so unwritten slots never carry NaN into the
        masked sum), the Mamba cache for SSM layers; on ``device``
        (default the model's)."""
        cfg = self.cfg
        shape = (batch, length, cfg.num_kv_heads, cfg.head_dim)
        kw = dict(dtype=self.dtype, device=self.device if device is None else device)
        return [{"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}
                if kind == "attn" else mamba_cache(cfg, batch, **kw)
                for kind, _ in self.kinds]

    def _run(self, x, positions, caches, pos, use_kernel) -> torch.Tensor:
        cfg = self.cfg
        rope = rope_cos_sin(positions, cfg.head_dim, theta=cfg.rope_theta,
                            sections=cfg.mrope_sections)  # shared by all layers
        for p, (kind, ffn), cache in zip(self.layers, self.kinds, caches):
            x = block_apply(p, x, cfg, kind, ffn, rope, cache, pos, use_kernel)[0]
        return x

    def _logits(self, x: torch.Tensor, top=None) -> torch.Tensor:
        cfg = self.cfg
        top = self.top if top is None else top
        return self.unembed(norm_apply(top["final_norm"], x, cfg.norm_type, cfg.norm_eps), top)

    def embed(self, tokens: torch.Tensor, top=None) -> torch.Tensor:
        table = (self.top if top is None else top)["embed"]
        return table[tokens.to(table.device)].to(self.dtype)

    def train_loss(self, batch: dict, params: dict | None = None):
        """-> (loss + AUX_COEF * aux, {"loss", "aux_loss"}) on ``batch``
        (tensors on the weights' device), with the weights ``params`` (a
        flat dict as ``flat_params`` gives; default: the model's own
        parameters, which the loss's backward then fills ``.grad`` of)."""
        cfg = self.cfg
        tree = nest(dict(self.named_parameters()) if params is None else params)
        top = tree["top"]
        targets = batch["targets"]
        b, s = targets.shape
        x = (batch["embeds"].to(self.dtype) if "embeds" in batch
             else self.embed(batch["tokens"], top))
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(s, device=x.device).expand(b, s)
        rope = rope_cos_sin(positions, cfg.head_dim, theta=cfg.rope_theta,
                            sections=cfg.mrope_sections)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, (kind, ffn) in enumerate(self.kinds):
            x, aux_i = remat(block_apply, cfg.remat)(tree["layers"][str(i)], x, cfg, kind, ffn,
                                                     rope, None, None)
            aux = aux + aux_i
        loss = cross_entropy_loss(self._logits(x, top), targets)
        return loss + AUX_COEF * aux, {"loss": loss, "aux_loss": aux}

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor | None = None, *, embeds: torch.Tensor | None = None,
                positions: torch.Tensor | None = None, cache_len: int | None = None,
                use_kernel="auto"):
        """tokens (B, S), or embeds (B, S, d) -> (logits (B, V) at the last
        position, caches of length ``cache_len`` (default S) holding the
        prompt's K/V and each SSM layer's state)."""
        if (tokens is None) == (embeds is None):
            raise ValueError("prefill takes tokens or embeds, not both")
        x = self.embed(tokens) if embeds is None else embeds.to(self.device, self.dtype)
        b, s = x.shape[:2]
        if positions is None:
            positions = torch.arange(s, device=self.device).expand(b, s)
        caches = self.new_caches(b, s if cache_len is None else cache_len)
        x = self._run(x, positions.to(self.device), caches, None, use_kernel)
        return self._logits(x[:, -1:])[:, 0], caches

    @torch.inference_mode()
    def serve_step(self, tokens: torch.Tensor, pos: int, caches: list):
        """One decode step: tokens (B, 1) at cursor ``pos`` -> (logits
        (B, 1, V), caches with this step's K/V written at ``pos``)."""
        b = tokens.shape[0]
        shape = (b, 1, 3) if self.cfg.mrope_sections else (b, 1)
        positions = torch.full(shape, pos, device=self.device)
        x = self._run(self.embed(tokens), positions, caches, int(pos), "auto")
        return self._logits(x), caches


def layer_defs(cfg: ModelConfig, kind: str, ffn_kind: str) -> dict:
    """One decoder layer's weights, named as the JAX ``layer_defs``."""
    d = cfg.d_model
    defs = {"ln1": norm_defs(d, cfg.norm_type)}
    if kind == "attn":
        defs["attn"] = attention_defs(cfg)
    else:
        defs["ssm"] = mamba_defs(cfg)
    if ffn_kind != "none":
        defs["ln2"] = norm_defs(d, cfg.norm_type)
    if ffn_kind == "dense":
        defs["mlp"] = mlp_defs(d, cfg.d_ff, gated=cfg.mlp_gated)
    elif ffn_kind == "moe":
        defs["moe"] = moe_defs(cfg)
    return defs


def decoder_defs(cfg: ModelConfig) -> dict:
    """``{"layers": {i: defs}, "top": defs}``: layer ``i`` has the kinds of
    position ``i % len(pattern)``; ``top`` holds the embedding table (kept by
    embedding-input archs too: their decode steps embed tokens), the final
    norm and the unembedding unless tied."""
    pattern = group_pattern(cfg)
    if cfg.num_layers % len(pattern):
        raise ValueError(f"{cfg.num_layers} layers is not a whole number of "
                         f"{len(pattern)}-layer groups")
    d, v = cfg.d_model, cfg.vocab_size
    top = {"embed": ParamDef((v, d), ("vocab", "fsdp"), scale=0.02),
           "final_norm": norm_defs(d, cfg.norm_type)}
    if not cfg.tie_embeddings:
        top["unembed"] = ParamDef((d, v), ("fsdp", "vocab"), scale=d ** -0.5)
    return {"layers": {str(i): layer_defs(cfg, *pattern[i % len(pattern)])
                       for i in range(cfg.num_layers)}, "top": top}


def build_model(cfg: ModelConfig, *, device="cuda", dtype: torch.dtype | None = None,
                compute_dtype: torch.dtype | str | None = None,
                generator: torch.Generator | None = None, mesh=None):
    """A randomly initialised model for ``cfg`` on ``device``: a
    :class:`DecoderLM`, or an :class:`~repro_torch.models.encdec.EncDecLM`
    for the encoder-decoder family.

    ``dtype`` (the weights') defaults to ``cfg.dtype``, ``compute_dtype``
    to ``dtype``; weights come from ``generator`` (default: seed 0 on
    ``device``) with the JAX package's init scales.  On the ``meta`` device
    the model is a skeleton: names, shapes and dtypes, nothing allocated.

    ``mesh`` (anything with a ``shape`` mapping axis names to extents) is
    kept with the sharding rules ``rules_for(mesh, fsdp=cfg.fsdp,
    seq_shard=cfg.seq_shard_activations)``, as the JAX ``build_model``
    keeps them: ``specs()``, ``cache_specs()`` and ``input_shardings()``
    read them, and :func:`shard_params` carries the weights onto the mesh.
    """
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype) if dtype is None else dtype
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    cfg = dataclasses.replace(cfg, vocab_size=_pad_vocab(cfg.vocab_size))
    kw = dict(generator=generator, device=dev, dtype=dtype)
    if isinstance(compute_dtype, str):
        compute_dtype = getattr(torch, compute_dtype)
    if cfg.is_encdec:
        from repro_torch.models.encdec import build_encdec

        model = build_encdec(cfg, **kw)
    else:
        model = _build_decoder(cfg, **kw)
    model.compute_dtype = compute_dtype
    if mesh is not None:
        model.mesh = mesh
        model.rules = rules_for(mesh, fsdp=cfg.fsdp, seq_shard=cfg.seq_shard_activations)
    return model


def _build_decoder(cfg: ModelConfig, **kw) -> DecoderLM:
    defs = decoder_defs(cfg)
    layers = [materialize(p, **kw) for p in defs["layers"].values()]
    return DecoderLM(cfg, layers, materialize(defs["top"], **kw))


# -- the model mesh ------------------------------------------------------------

class MeshLM:
    """A decoder-only LM of any family, served and trained on a mesh
    (:func:`shard_params` builds it from a one-device model,
    :func:`mesh_model` its structure alone; the encoder-decoder family is
    :class:`~repro_torch.models.encdec.MeshEncDecLM`).

    Every position holds its shard of every weight, as ``param_specs``
    lays it out, on its own device; positions may repeat a device.  The
    batch goes over the batch axes (``pod``, ``data``): a position takes
    its batch shard's rows and each position's decode cache holds those
    rows.  Attention heads, the MLP's ``d_ff``, Mamba's ``d_inner`` and SSM
    heads (:func:`~repro_torch.models.mamba.mesh_mamba`), the experts and
    the vocabulary go over ``model``; weights sharded over ``data`` (``fsdp``)
    are gathered over ``data`` at their use.

    The residual stream between blocks is laid out as JAX's
    ``constrain_residual`` pins it (Megatron-SP): where the config sets
    ``seq_shard_activations``, the ``model`` extent tp is above 1 and a
    call's sequence length S (above 1) divides by it, each position holds
    its rows' slice ``[j S/tp, (j+1) S/tp)`` of the sequence, ``j`` its
    ``model`` index (:meth:`RunCtx.at_length`).  The norms and the adds run
    on the slices; each mixer and MLP gathers the normed slices over
    ``model`` before its column-parallel products and reduce-scatters its
    row-parallel partials back onto them; the MoE's expert-parallel blocks
    are the slices; the vocabulary-parallel embedding's sum is a
    reduce-scatter; the loss gathers the final normed slices.  Decode
    steps (S = 1), lengths that do not divide, and configs without the
    flag keep the residual whole on every position, the row-parallel
    partials psummed.

    ``prefill`` and ``serve_step`` have :class:`DecoderLM`'s signatures and
    return the logits gathered over the mesh onto ``device`` (the first
    position's), so :class:`~repro_torch.serve.engine.ServeEngine` drives a
    meshed model unchanged; the caches it hands back are one list of
    per-layer caches a position.  Prefill unembeds only the last position's
    row, handed over by the ``model`` member whose slice holds it.  The
    row-parallel sums (``wo``, ``down``, the experts) add the partials in
    mesh order, not in the one-device product's order: the logits match the
    one-device model's within float rounding, not bit for bit.

    ``train_loss(batch, shards)`` is :meth:`DecoderLM.train_loss` on the
    mesh, differentiable in the per-position weights ``shards``.
    """

    final_norm = "top.final_norm"  # the norm before the unembedding

    def __init__(self, cfg, mesh, specs: dict, shapes: dict, shards: list, kinds,
                 param_dtype, compute_dtype=None):
        self.cfg, self.mesh, self.kinds = cfg, mesh, kinds
        self.param_dtype, self.compute_dtype = param_dtype, compute_dtype
        self.ctx = RunCtx(mesh, act_seq=rules_for(
            mesh, seq_shard=cfg.seq_shard_activations).act_seq)
        self.device = self.ctx.devices[0]
        self.specs, self.shapes, self.shards = specs, shapes, shards
        self._children: dict = {}  # prefix -> the weight names under it

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (``compute_dtype``, else the weights')."""
        return self.compute_dtype or self.param_dtype

    def spec(self, name: str):
        return self.specs[name]

    def replica_axes(self, name: str) -> tuple:
        """The mesh axes ``name`` is replicated over: the positions that
        differ only along them hold the same block."""
        used = spec_axes(self.specs[name])
        return tuple(a for a in self.mesh.axis_names if a not in used)

    def owners(self, name: str) -> list:
        """The positions holding a distinct block of ``name``, in mesh
        order: each block's first holder."""
        rep = self.replica_axes(name)
        return [i for i, c in enumerate(self.ctx.coords) if not any(c[a] for a in rep)]

    def with_shards(self, shards: list) -> "MeshLM":
        """This model reading its weights from ``shards`` (one flat dict a
        position, as a training state holds them)."""
        out = copy.copy(self)
        out.shards = shards
        return out

    def with_batch_replicated(self) -> "MeshLM":
        """This model with every position taking the whole batch: the layout
        JAX's ``input_shardings`` give a batch that does not divide over
        the batch axes (``long_500k``'s one row on ``data`` = 16).  The
        positions along those axes compute the same rows; weights sharded
        over them are still gathered at their use."""
        out = copy.copy(self)
        out.ctx = RunCtx(self.mesh, batch_axes=(), gather_axes=self.ctx.batch_axes,
                         act_seq=self.ctx.act_seq)
        return out

    def with_seq_shard(self, on: bool) -> "MeshLM":
        """This model, its weights shared, with the config's
        ``seq_shard_activations`` set to ``on``."""
        out = copy.copy(self)
        out.cfg = dataclasses.replace(self.cfg, seq_shard_activations=on)
        out.ctx = copy.copy(self.ctx)
        out.ctx.act_seq = rules_for(self.mesh, seq_shard=on).act_seq
        return out

    def at_length(self, s: int) -> "MeshLM":
        """This model for a call whose residual has ``s`` positions: its
        context's ``seq`` (:meth:`RunCtx.at_length`) says whether each
        position holds a sequence slice."""
        out = copy.copy(self)
        out.ctx = self.ctx.at_length(s)
        return out

    def local(self, name: str) -> list:
        """Each position's stored shard of ``name``."""
        return [sh[name] for sh in self.shards]

    def weight(self, name: str, full: bool = False) -> list:
        """``name`` at every position as it is used: its ``data``-sharded
        dims gathered (every sharded dim with ``full``)."""
        vals = self.local(name)
        for dim, entry in enumerate(self.specs[name]):
            if entry is not None and (full or entry in self.ctx.gather_axes):
                vals = self.ctx.all_gather(vals, entry, dim)
        return vals

    def weights(self, prefix: str) -> list:
        """The weights under ``prefix`` as one dict a position (leaf name ->
        tensor)."""
        if prefix not in self._children:
            self._children[prefix] = [n for n in self.specs if n.startswith(prefix + ".")]
        cols = {n[len(prefix) + 1:]: self.weight(n) for n in self._children[prefix]}
        return [{k: v[i] for k, v in cols.items()} for i in range(self.ctx.n)]

    def num_params(self) -> int:
        return sum(math.prod(s) for s in self.shapes.values())

    def weight_bytes(self) -> int:
        """Bytes the positions store (a tensor shared by positions on one
        device counted once)."""
        seen = {}
        for sh in self.shards:
            for t in sh.values():
                seen[(t.device, t.data_ptr())] = t.numel() * t.element_size()
        return sum(seen.values())

    def cache_layout(self, batch: int, length: int) -> list:
        """Each layer's leaf -> PartitionSpec of a ``batch`` x ``length``
        decode cache: ``cache_specs`` (JAX's ``_cache_specs``) of that
        cell.  Its batch entry must be this model's split of the rows (a
        batch the batch axes divide goes over them; ``with_batch_replicated``
        takes one that they do not)."""
        specs = self.cache_specs(ShapeConfig("decode", length, batch, "decode"))
        batch_entry = next(iter(specs[0].values()))[0]
        if mesh_extent(self.mesh, batch_entry) != self.ctx.n_batch:
            raise ValueError(f"a batch of {batch} rows is laid out over the batch axes "
                             f"{self.ctx.gather_axes} otherwise than this model splits it "
                             f"({self.ctx.n_batch} ways)")
        return specs

    def _block(self, whole: tuple, spec) -> tuple:
        return tuple(d if e is None else d // mesh_extent(self.mesh, e) for d, e in zip(whole, spec))

    def new_caches(self, batch: int, length: int, device=None) -> list:
        """Zeroed caches, one list of per-layer :class:`CacheBlock` a
        position (on its device, or all on ``device``), each leaf the block
        :meth:`cache_layout` gives the position: ``{"k", "v"}`` of
        ``(batch, length, KV, D)`` for attention (its rows, its ``KV / tp``
        heads or every KV head, its slice of the sequence where the spec
        shards it); for Mamba ``state`` of ``(batch / n_batch, its heads, P,
        N)``, ``conv_x`` of ``(batch / n_batch, K - 1, its channels)``,
        ``conv_b`` and ``conv_c`` whole (:func:`~repro_torch.models.mamba
        .mesh_mamba`'s layout, the same blocks)."""
        cfg, ctx = self.cfg, self.ctx
        specs = self.cache_layout(batch, length)
        rows = batch // ctx.n_batch
        shapes = {}
        kinds = [kind for kind, _ in self.kinds]
        if "attn" in kinds:
            kv = self._block((batch, length, cfg.num_kv_heads, cfg.head_dim),
                             specs[kinds.index("attn")]["k"])
            shapes["attn"] = {"k": kv, "v": kv}
        if "ssm" in kinds:
            pre = f"layers.{kinds.index('ssm')}.ssm."
            split = {name: ctx.tp if self.spec(pre + name)[1] == ctx.model_axis else 1
                     for name in ("in_x", "in_dt")}
            d_in, h, _ = mamba_dims(cfg)
            n, k = cfg.ssm_state, cfg.ssm_conv
            shapes["ssm"] = {"state": (rows, h // split["in_dt"], cfg.ssm_headdim, n),
                             "conv_x": (rows, k - 1, d_in // split["in_x"]),
                             "conv_b": (rows, k - 1, n), "conv_c": (rows, k - 1, n)}
        return [[CacheBlock({name: torch.zeros(shape, dtype=self.dtype, device=dev)
                             for name, shape in shapes[kind].items()}, spec)
                 for kind, spec in zip(kinds, specs)]
                for dev in (ctx.devices if device is None else [device] * ctx.n)]

    cache_specs = LMBase.cache_specs
    _batch_axes = LMBase._batch_axes
    input_specs = LMBase.input_specs

    def _embed(self, tokens: list) -> list:
        """The vocabulary-parallel lookup: each position looks up the rows
        of its vocabulary shard (zeros for another shard's tokens), then a
        psum over ``model`` (exact: one nonzero term), a reduce-scatter onto
        the sequence slices where the residual is sequence-sharded."""
        ctx = self.ctx
        tables = self.weight("top.embed")
        if not is_sharded(self.spec("top.embed"), 0, ctx.model_axis):
            return [tab[t].to(self.dtype) for tab, t in zip(tables, ctx.seq_slices(tokens))]
        out = []
        for tab, t, j in zip(tables, tokens, ctx.model_index):
            loc = t - j * tab.shape[0]
            hit = (loc >= 0) & (loc < tab.shape[0])
            rows = tab[loc.clamp(0, tab.shape[0] - 1)].to(self.dtype)
            out.append(torch.where(hit[..., None], rows, 0))
        return ctx.reduce_partials(out, ctx.model_axis)

    def _vocab_logits(self, xs: list) -> tuple[list, bool]:
        """Final norm and the vocabulary-column-parallel unembedding (the
        embedding table transposed when tied) -> (each position's logits
        (B / n_batch, S, V or V / tp), whether they are its vocabulary
        shard).  Sequence slices are gathered over ``model`` after the norm
        (the gather JAX's vocabulary-sharded logits imply)."""
        cfg, ctx = self.cfg, self.ctx
        norms = self.weights(self.final_norm)
        hs = ctx.gather_seq([norm_apply(p, x, cfg.norm_type, cfg.norm_eps)
                             for p, x in zip(norms, xs)])
        if cfg.tie_embeddings:
            name, dim = "top.embed", 0
            out = [h @ w.to(h.dtype).T for h, w in zip(hs, self.weight(name))]
        else:
            name, dim = "top.unembed", 1
            out = [h @ w.to(h.dtype) for h, w in zip(hs, self.weight(name))]
        return out, is_sharded(self.spec(name), dim, ctx.model_axis)

    def _logits(self, xs: list) -> torch.Tensor:
        """The logits gathered over the mesh -> (B, S, V) on ``device``."""
        out, sharded = self._vocab_logits(xs)
        if sharded:
            out = self.ctx.all_gather(out, self.ctx.model_axis, -1)
        return self.ctx.gather_batch(out, self.device)

    def _run(self, xs, positions, caches, pos, use_kernel) -> list:
        cfg = self.cfg
        ropes = [rope_cos_sin(p, cfg.head_dim, theta=cfg.rope_theta, sections=cfg.mrope_sections)
                 for p in positions]
        for l, (kind, ffn) in enumerate(self.kinds):
            xs = mesh_block_apply(self, l, xs, kind, ffn, ropes, [c[l] for c in caches], pos,
                                  use_kernel)[0]
        return xs

    def split_inputs(self, batch) -> list:
        """Each position's block of a batch on its device, as
        ``input_shardings`` lays it out: its rows (``batch`` is the global
        batch, a dict of (B, ...) tensors split over the batch axes, or one
        dict a batch shard in order, as ``ShardedDataPipeline.shards_at``
        gives them), and of ``embeds`` its sequence slice where the residual
        is sequence-sharded; ``positions`` and ``targets`` stay whole."""
        ctx = self.ctx
        if isinstance(batch, dict):
            cols = {k: ctx.split_batch(v) for k, v in batch.items()}
        else:
            if len(batch) != ctx.n_batch:
                raise ValueError(f"{len(batch)} batch shards for {ctx.n_batch} batch positions")
            cols = {k: [batch[j][k].to(dev) for j, dev in zip(ctx.batch_index, ctx.devices)]
                    for k in batch[0]}
        if "embeds" in cols:
            cols["embeds"] = ctx.at_length(cols["embeds"][0].shape[1]).seq_slices(cols["embeds"])
        return [{k: v[i] for k, v in cols.items()} for i in range(ctx.n)]

    def train_loss(self, batch, shards: list | None = None):
        """:meth:`DecoderLM.train_loss` on the mesh -> (loss + AUX_COEF *
        aux, {"loss", "aux_loss"}), scalars on ``device``, with the
        weights ``shards`` (one flat dict a position; default the model's
        own).  ``batch`` as :meth:`split_inputs` takes it.

        Each layer runs under ``cfg.remat``.  The cross-entropy is taken on
        each position's vocabulary shard of the logits
        (:func:`~repro_torch.models.layers.vocab_parallel_nll`, the
        reductions over ``model``), never on the gathered (B, S, V) logits;
        each batch shard's mean is summed in mesh order and divided by the
        shard count.  The MoE aux loss is each layer's mean over the
        expert-parallel blocks, summed over layers.  The loss reads only
        the first position's values: the psums carry every position's part
        of them, so the gradient of every position's weights follows."""
        m = self if shards is None else self.with_shards(shards)
        return m.train_loss_positions(self.split_inputs(batch))

    def train_loss_positions(self, parts: list):
        """:meth:`train_loss` of inputs already split: one dict a position,
        as :meth:`split_inputs` gives them (``embeds`` a sequence slice
        where the residual is sequence-sharded)."""
        cfg = self.cfg
        targets = [p["targets"] for p in parts]
        b, s = targets[0].shape
        m = self.at_length(s)
        if "embeds" in parts[0]:
            xs = [p["embeds"].to(self.dtype) for p in parts]
        else:
            xs = m._embed([p["tokens"] for p in parts])
        positions = [p["positions"] if "positions" in p
                     else torch.arange(s, device=x.device).expand(b, s) for p, x in zip(parts, xs)]
        ropes = [rope_cos_sin(p, cfg.head_dim, theta=cfg.rope_theta, sections=cfg.mrope_sections)
                 for p in positions]
        aux = [torch.zeros((), dtype=torch.float32, device=x.device) for x in xs]
        for l, (kind, ffn) in enumerate(self.kinds):
            xs, aux_l = remat(mesh_block_apply, cfg.remat)(m, l, xs, kind, ffn, ropes, None, None)
            aux = [a + b for a, b in zip(aux, aux_l)]
        loss = m._mean_nll(xs, targets)
        aux = aux[0].to(self.device)
        return loss + AUX_COEF * aux, {"loss": loss, "aux_loss": aux}

    def _mean_nll(self, xs: list, targets: list) -> torch.Tensor:
        """The mean next-token cross-entropy of the final residuals ``xs``
        against ``targets`` (one a position), on ``device``: taken on each
        position's vocabulary shard of the logits, each batch shard's mean
        summed in mesh order and divided by the shard count."""
        ctx = self.ctx
        logits, sharded = self._vocab_logits(xs)
        if sharded and ctx.tp > 1:
            ax = ctx.model_axis

            def reduce(vals, op):
                return ctx.pmax(vals, ax) if op == "max" else ctx.psum(vals, ax)

            starts = [j * x.shape[-1] for x, j in zip(logits, ctx.model_index)]
            means = [n.mean() for n in vocab_parallel_nll(logits, targets, starts, reduce)]
        else:
            means = [cross_entropy_loss(x, t) for x, t in zip(logits, targets)]
        return ctx.psum(means, ctx.batch_axes)[0].to(self.device) / ctx.n_batch

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor | None = None, *, embeds: torch.Tensor | None = None,
                positions: torch.Tensor | None = None, cache_len: int | None = None,
                use_kernel="auto"):
        """:meth:`DecoderLM.prefill` on the mesh -> (logits (B, V) on
        ``device``, each position's caches)."""
        if (tokens is None) == (embeds is None):
            raise ValueError("prefill takes tokens or embeds, not both")
        ctx = self.ctx
        x = tokens if embeds is None else embeds
        b, s = x.shape[:2]
        m = self.at_length(s)
        if positions is None:
            positions = torch.arange(s, device=x.device).expand(b, s)
        xs = (m._embed(ctx.split_batch(tokens)) if embeds is None
              else [e.to(self.dtype) for e in m.ctx.seq_slices(ctx.split_batch(embeds))])
        caches = self.new_caches(b, s if cache_len is None else cache_len)
        xs = m._run(xs, ctx.split_batch(positions), caches, None, use_kernel)
        return self._logits(m.ctx.last_rows(xs))[:, 0], caches

    @torch.inference_mode()
    def serve_step(self, tokens: torch.Tensor, pos: int, caches: list):
        """:meth:`DecoderLM.serve_step` on the mesh -> (logits (B, 1, V) on
        ``device``, the caches with this step's K/V written at ``pos``)."""
        ctx = self.ctx
        b = tokens.shape[0]
        shape = (b, 1, 3) if self.cfg.mrope_sections else (b, 1)
        positions = ctx.split_batch(torch.full(shape, pos, device=tokens.device))
        xs = self._run(self._embed(ctx.split_batch(tokens)), positions, caches, int(pos), "auto")
        return self._logits(xs), caches


def mesh_model(model, mesh=None) -> MeshLM:
    """The structure of ``model`` on ``mesh`` (default: the mesh
    ``build_model(..., mesh=)`` kept): its weights' specs by
    ``param_specs`` and whole shapes, no weights (``model`` may be a
    ``meta`` skeleton).  A :class:`MeshLM` for every decoder-only family, a
    :class:`~repro_torch.models.encdec.MeshEncDecLM` for the
    encoder-decoder."""
    mesh = model.mesh if mesh is None else mesh
    cfg = model.cfg
    if mesh is None:
        raise ValueError("a model mesh needs a mesh (build_model(..., mesh=) or mesh=)")
    shapes = {name: tuple(p.shape) for name, p in model.named_parameters()}
    specs = param_specs(model, mesh)
    if cfg.is_encdec:
        from repro_torch.models.encdec import MeshEncDecLM

        return MeshEncDecLM(cfg, mesh, specs, shapes, None, None, model.param_dtype,
                            model.compute_dtype)
    return MeshLM(cfg, mesh, specs, shapes, None, model.kinds, model.param_dtype,
                  model.compute_dtype)


def shard_leaves(meshed: MeshLM, flat: dict, share_replicated: bool = False) -> list:
    """A one-device flat dict (weights, or anything shaped as them: the
    AdamW moments, meta tensors) -> one flat dict a position, each leaf the
    block its spec gives the position, a fresh contiguous copy on the
    position's device (``ShardedArray.from_whole``).  With
    ``share_replicated`` a leaf replicated over the whole mesh is stored
    once a device (the one-device tensor itself on its own device), as a
    served model keeps it; a training state holds a copy a position, whose
    gradient the step sums over the positions."""
    ctx = meshed.ctx
    shards = [{} for _ in range(ctx.n)]
    for name, w in flat.items():
        w, spec = w.detach(), meshed.spec(name)
        if share_replicated and not spec_axes(spec):
            per_device: dict = {}
            parts = [per_device.setdefault(dev, w.to(dev)) for dev in ctx.devices]
        else:
            parts = ShardedArray.from_whole(w, ctx.mesh, spec).parts
        for sh, part in zip(shards, parts):
            sh[name] = part
    return shards


def gather_leaves(meshed: MeshLM, shards: list, device=None) -> dict:
    """The inverse of :func:`shard_leaves`: name -> the whole tensor on
    ``device`` (default the mesh's first), assembled from each block's
    first holder."""
    device = meshed.device if device is None else device
    return {name: ShardedArray([sh[name] for sh in shards], meshed.mesh,
                               meshed.spec(name)).whole(device) for name in shards[0]}


def shard_params(model, mesh=None) -> MeshLM:
    """Carry a one-device model's weights onto ``mesh`` (default: the mesh
    ``build_model(..., mesh=)`` kept): each position stores its shard of
    every weight by ``param_specs``, a fresh contiguous copy on its device,
    so the shards together hold one device's bytes.  A weight replicated
    over the mesh is stored once a device (on the model's own device, the
    model's tensor itself).  One-device weights may come from
    ``params_from_jax``."""
    meshed = mesh_model(model, mesh)
    meshed.shards = shard_leaves(meshed, model.flat_params(), share_replicated=True)
    return meshed


def gather_params(meshed: MeshLM, device=None) -> dict:
    """The inverse of :func:`shard_params`: name -> the whole weight on
    ``device`` (default the mesh's first), assembled from the shards."""
    return gather_leaves(meshed, meshed.shards, device)


def gather_caches(meshed: MeshLM, caches: list, device=None) -> list:
    """Each position's caches -> the one-device model's layout, one dict a
    layer on ``device``: every leaf assembled from its blocks by the spec
    its :class:`CacheBlock` carries (sequence slices in the flat order of
    the sequence's axes, ``KV / tp`` heads over ``model``, batch shards in
    order), a block that positions repeat from its first holder."""
    device = meshed.device if device is None else device
    return [{key: ShardedArray([c[l][key] for c in caches], meshed.mesh,
                               caches[0][l].specs[key]).whole(device)
             for key in caches[0][l]} for l in range(len(caches[0]))]
