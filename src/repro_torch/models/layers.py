"""Primitive layers and parameter creation (port of ``repro.models.layers``).

The layer functions keep the JAX package's order of casts: every weight is
cast to the activations' dtype at its use (``w.to(x.dtype)``), norms take
float32 statistics and cast back before the weight multiply; ``linear`` is
``x @ w`` plus a bias.  So the parameters' dtype and the compute dtype are
separate: a served model stores its weights in the dtype it computes in,
a trained one keeps float32 masters and computes in ``cfg.dtype`` (bf16 for
every published config), as the JAX package does.

Every weight is declared once as a :class:`ParamDef`, as in the JAX
package: its shape, its *logical* axes (named as JAX names them, resolved
to a mesh by :func:`param_specs`), its init and scale.  :func:`materialize`
draws a def tree from an explicit ``torch.Generator``: normal weights
``N(0, scale^2)`` drawn in float32 and cast to the storage dtype once, in
the tree's order, norm weights one, biases zero.  The JAX package draws
from ``jax.random`` keyed by the parameter path, so the two packages share
weights only through :func:`repro_torch.models.convert.params_from_jax`.  :class:`Params` holds
a nested dict of weights as modules named by the JAX parameter paths;
:class:`LMBase` is what every model shares (dtypes, device, counts, the
unembedding, the flat parameter dict training works on).
:func:`cross_entropy_loss` is the training loss, :func:`vocab_parallel_nll`
its form on vocabulary-sharded logits (a model mesh).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.sharding import (
    PartitionSpec,
    ShardingRules,
    logical_to_spec,
    mesh_extent,
    rules_for,
)


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """One weight: its full shape, one logical axis name a dim (``"none"``:
    never sharded), its init (``normal``, ``zeros`` or ``ones``) and the
    normal init's scale."""

    shape: tuple
    logical: tuple
    init: str = "normal"
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes {self.logical} differ in rank")


def materialize(defs: dict, *, generator, device, dtype) -> dict:
    """The tensors of a (nested) def tree, drawn in the tree's order."""
    out = {}
    for name, d in defs.items():
        if isinstance(d, dict):
            out[name] = materialize(d, generator=generator, device=device, dtype=dtype)
        elif d.init == "normal":
            out[name] = normal(d.shape, d.scale, generator=generator, device=device, dtype=dtype)
        else:
            out[name] = torch.full(d.shape, float(d.init == "ones"), device=device, dtype=dtype)
    return out


def flatten_defs(tree: dict, prefix: str = "") -> dict:
    """A nested def tree -> ``{"a.b.c": ParamDef}``, the names of
    ``named_parameters`` of the model it builds."""
    out = {}
    for name, d in tree.items():
        if isinstance(d, dict):
            out.update(flatten_defs(d, f"{prefix}{name}."))
        else:
            out[prefix + name] = d
    return out


def param_specs(model, mesh, rules=None) -> dict:
    """name -> :class:`~repro_torch.dist.sharding.PartitionSpec` of every
    weight of ``model`` on ``mesh`` (port of the JAX ``param_specs``).  A
    per-layer weight's spec is the JAX stacked leaf's with the leading
    layer axis dropped (that axis is ``"none"``: it uses no mesh axis).
    ``rules`` default to ``rules_for(mesh)`` with the config's ``fsdp`` and
    ``seq_shard_activations``, as ``build_model`` picks them."""
    cfg = model.cfg
    if rules is None:
        rules = rules_for(mesh, fsdp=cfg.fsdp, seq_shard=cfg.seq_shard_activations)
    return {name: logical_to_spec(d.logical, d.shape, mesh, rules)
            for name, d in model.param_defs().items()}


class Params(nn.Module):
    """A nested dict of weights as a module: ``p["attn"]["wq"]`` reads the
    parameter registered as ``attn.wq`` (the JAX package's parameter path).
    Every weight is a trainable parameter; serving runs under
    ``torch.inference_mode``, which records no graph."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                self.add_module(name, Params(leaf))
            else:
                self.register_parameter(name, nn.Parameter(leaf))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def get(self, name: str, default=None):
        return getattr(self, name, default)


def nest(flat: dict) -> dict:
    """``{"a.b.c": t}`` -> ``{"a": {"b": {"c": t}}}``: a flat parameter dict
    (the names of ``named_parameters``) as the nested dicts the layer
    functions read, ``p["attn"]["wq"]`` as on a :class:`Params`."""
    out: dict = {}
    for name, leaf in flat.items():
        node = out
        *path, last = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


class LMBase(nn.Module):
    """What every model shares: ``top`` holds the embedding table (and the
    unembedding unless tied); weights in one dtype on one device.

    ``compute_dtype`` (None: the weights' dtype) is the dtype activations,
    caches and logits are computed in."""

    cfg = None
    top: Params
    compute_dtype: torch.dtype | None = None
    mesh = None  # build_model(..., mesh=) keeps the mesh and its rules
    rules = ShardingRules()

    def specs(self) -> dict:
        """name -> PartitionSpec of every weight (``ModelBundle.specs``):
        all replicated without a mesh."""
        if self.mesh is None:
            return {name: PartitionSpec() for name in self.param_defs()}
        return param_specs(self, self.mesh, self.rules)

    def _batch_axes(self) -> tuple:
        if self.mesh is None:
            return ()
        return tuple(a for a in ("pod", "data") if a in self.mesh.shape)

    def cache_specs(self, shape) -> list:
        """The decode caches' PartitionSpecs (the JAX ``_cache_specs``), one
        entry a layer as ``new_caches`` lays them out, each the JAX stacked
        spec without its layer axis: ``{"k", "v"}`` of attention
        (``{"k", "v", "xk", "xv"}`` for the encoder-decoder), the Mamba
        cache's four leaves.  The batch axes shard the batch when it divides;
        the kv heads go on ``model`` when they divide, else the sequence
        does (with the batch axes too where the batch did not divide)."""
        from repro_torch.models.mamba import mamba_dims

        cfg, mesh, ba = self.cfg, self.mesh, self._batch_axes()
        b, s = shape.global_batch, shape.seq_len
        batch_ax = ba if (ba and b % mesh_extent(mesh, ba) == 0) else None
        model_ok = mesh is not None and "model" in mesh.shape
        kv_ax = "model" if model_ok and cfg.num_kv_heads % mesh.shape["model"] == 0 else None
        seq_axes = ["model"] if model_ok and kv_ax is None else []
        if batch_ax is None and ba:
            seq_axes = list(ba) + seq_axes
        seq_ax = tuple(seq_axes) if seq_axes and s % mesh_extent(mesh, seq_axes) == 0 else None
        kv = PartitionSpec(batch_ax, seq_ax, kv_ax, None)
        if cfg.is_encdec:
            return [{"k": kv, "v": kv, "xk": kv, "xv": kv} for _ in range(cfg.decoder_layers)]
        d_in, h, _ = mamba_dims(cfg)
        h_ax = "model" if model_ok and h % mesh.shape["model"] == 0 else None
        c_ax = "model" if model_ok and d_in % mesh.shape["model"] == 0 else None
        ssm = {"state": PartitionSpec(batch_ax, h_ax, None, None),
               "conv_x": PartitionSpec(batch_ax, None, c_ax),
               "conv_b": PartitionSpec(batch_ax, None, None),
               "conv_c": PartitionSpec(batch_ax, None, None)}
        return [{"k": kv, "v": kv} if kind == "attn" else dict(ssm) for kind, _ in self.kinds]

    def input_specs(self, shape) -> dict:
        """``meta`` tensors of every input of a shape cell (the JAX
        ``input_specs``): ``train`` and ``prefill`` batches by the family's
        input keys (``tokens`` or ``embeds``, ``positions`` under M-RoPE,
        the encoder-decoder's ``enc_embeds`` and ``dec_tokens``; ``targets``
        to train), ``decode`` the ``(B, 1)`` tokens, the cursor ``pos`` (an
        int32 scalar; ``serve_step`` takes it as an int) and the caches
        ``new_caches(B, S)`` lays out, with the cross-attention's ``xk``,
        ``xv`` (``(B, S, KV, D)``) for the encoder-decoder.  A meshed
        model's caches are each position's, its other inputs the global
        batch its ``prefill``, ``serve_step`` and ``train_loss`` split."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def meta(*dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device="meta")

        if shape.kind == "decode":
            caches = self.new_caches(b, s, device="meta", **({"cross": s} if cfg.is_encdec else {}))
            return {"tokens": meta(b, 1), "pos": meta(), "caches": caches}
        if cfg.is_encdec:
            out = {"enc_embeds": meta(b, s, cfg.d_model, dtype=self.dtype), "dec_tokens": meta(b, s)}
        else:
            out = ({"embeds": meta(b, s, cfg.d_model, dtype=self.dtype)}
                   if cfg.input_mode == "embeddings" else {"tokens": meta(b, s)})
            if cfg.mrope_sections:
                out["positions"] = meta(b, s, 3)
        if shape.kind == "train":
            out["targets"] = meta(b, s)
        return out

    def input_shardings(self, shape) -> dict:
        """PartitionSpecs of a shape cell's inputs (the JAX
        ``input_shardings``): ``train`` and ``prefill`` batches by the
        family's input keys, ``decode`` the tokens, cursor and caches."""
        cfg, mesh, ba = self.cfg, self.mesh, self._batch_axes()
        batch_ax = ba if (ba and shape.global_batch % mesh_extent(mesh, ba) == 0) else None
        sa = ("model" if mesh is not None and "model" in mesh.shape
              and cfg.seq_shard_activations and shape.seq_len % mesh.shape["model"] == 0
              else None)
        tok, emb = PartitionSpec(batch_ax, None), PartitionSpec(batch_ax, sa, None)
        if shape.kind == "decode":
            return {"tokens": tok, "pos": PartitionSpec(), "caches": self.cache_specs(shape)}
        if cfg.is_encdec:
            out = {"enc_embeds": emb, "dec_tokens": tok}
        else:
            out = {"embeds": emb} if cfg.input_mode == "embeddings" else {"tokens": tok}
            if cfg.mrope_sections:
                out["positions"] = PartitionSpec(batch_ax, None, None)
        if shape.kind == "train":
            out["targets"] = tok
        return out

    @property
    def param_dtype(self) -> torch.dtype:
        return self.top["embed"].dtype

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype."""
        return self.compute_dtype or self.param_dtype

    @property
    def device(self) -> torch.device:
        return self.top["embed"].device

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def weight_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())

    def flat_params(self) -> dict:
        """name -> weight (detached, sharing storage): the port-layout
        parameter dict a ``TrainState`` holds and ``train_loss`` takes."""
        return {name: p.detach() for name, p in self.named_parameters()}

    def unembed(self, x: torch.Tensor, top=None) -> torch.Tensor:
        """Final-normed states (B, S, d) -> logits (B, S, V) (the embedding
        table transposed when tied); ``top`` defaults to the model's own."""
        top = self.top if top is None else top
        if self.cfg.tie_embeddings:
            return x @ top["embed"].to(x.dtype).T
        return x @ top["unembed"].to(x.dtype)


def normal(shape, scale: float, *, generator, device, dtype) -> torch.Tensor:
    """``N(0, scale^2)`` drawn in float32 on ``device``, stored as ``dtype``."""
    w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return (w * scale).to(dtype)


def dense_def(d_in: int, d_out: int, logical=("fsdp", "ff")) -> ParamDef:
    """A ``(d_in, d_out)`` weight at the scale ``d_in ** -0.5``."""
    return ParamDef((d_in, d_out), logical, scale=d_in ** -0.5)


def norm_defs(d: int, norm_type: str = "rms") -> dict:
    defs = {"w": ParamDef((d,), ("none",), init="ones")}
    if norm_type == "ln":
        defs["b"] = ParamDef((d,), ("none",), init="zeros")
    return defs


def mlp_defs(d_model: int, d_ff: int, *, gated: bool = True) -> dict:
    if gated:
        return {"gate": dense_def(d_model, d_ff, ("fsdp", "ff")),
                "up": dense_def(d_model, d_ff, ("fsdp", "ff")),
                "down": dense_def(d_ff, d_model, ("ff", "fsdp"))}
    # The non-gated MLP always carries biases (``bias=not gated`` in the JAX
    # layer defs).
    return {"in": dense_def(d_model, d_ff, ("fsdp", "ff")),
            "out": dense_def(d_ff, d_model, ("ff", "fsdp")),
            "b_in": ParamDef((d_ff,), ("ff",), init="zeros"),
            "b_out": ParamDef((d_model,), ("none",), init="zeros")}


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * w.to(x.dtype) + b.to(x.dtype)


def norm_apply(p: dict, x: torch.Tensor, norm_type: str = "rms",
               eps: float = 1e-5) -> torch.Tensor:
    if norm_type == "ln":
        return layer_norm(x, p["w"], p["b"], eps)
    return rms_norm(x, p["w"], eps)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def swiglu(x, w_gate, w_up, w_down) -> torch.Tensor:
    return linear(F.silu(linear(x, w_gate)) * linear(x, w_up), w_down)


def gelu_mlp(x, w_in, b_in, w_out, b_out) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    return linear(F.gelu(linear(x, w_in, b_in), approximate="tanh"), w_out, b_out)


def mlp_apply(p: dict, x: torch.Tensor, *, gated: bool = True) -> torch.Tensor:
    if gated:
        return swiglu(x, p["gate"], p["up"], p["down"])
    return gelu_mlp(x, p["in"], p.get("b_in"), p["out"], p.get("b_out"))


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy in nats: logits (B, S, V) (taken in
    float32, the logsumexp over every column, padding included, as in the
    JAX package), targets (B, S) int; an optional (B, S) ``mask`` weights
    the positions (its sum floored at 1)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _reduce_in_order(vals: list, op: str) -> list:
    """The max or sum of ``vals`` in list order on the first one's device,
    handed to each (one group of vocabulary shards)."""
    dev = vals[0].device
    out = vals[0]
    for v in vals[1:]:
        out = torch.maximum(out, v.to(dev)) if op == "max" else out + v.to(dev)
    return [out.to(v.device) for v in vals]


def vocab_parallel_nll(logits: list, targets: list, starts: list,
                       reduce=_reduce_in_order) -> list:
    """Next-token negative log-likelihood from vocabulary-sharded logits,
    without gathering them: ``logits[i]`` (B, S, V_i) holds the columns
    ``[starts[i], starts[i] + V_i)`` of the (B, S, V) logits, ``targets[i]``
    (B, S) the rows' targets.  ``reduce(values, "max" | "sum")`` reduces
    over the shards that share rows and hands every shard the result (by
    default: all of them, in list order).  The row max is a max over the
    shards (held out of the gradient: the logsumexp's own max cancels), the
    sum of exponentials and the target's logit are sums, so the logsumexp
    covers every column, padding included, as :func:`cross_entropy_loss`'s
    does.  -> each shard's float32 (B, S) nll."""
    lf = [x.to(torch.float32) for x in logits]
    mx = reduce([x.detach().amax(dim=-1) for x in lf], "max")
    sumexp = reduce([torch.exp(x - m[..., None]).sum(dim=-1) for x, m in zip(lf, mx)], "sum")
    gold = []
    for x, t, lo in zip(lf, targets, starts):
        loc = t.long() - lo
        hit = (loc >= 0) & (loc < x.shape[-1])
        g = torch.gather(x, -1, loc.clamp(0, x.shape[-1] - 1)[..., None])[..., 0]
        gold.append(torch.where(hit, g, 0))
    gold = reduce(gold, "sum")
    return [torch.log(s) + m - g for s, m, g in zip(sumexp, mx, gold)]
