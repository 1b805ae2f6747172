"""Primitive layers and parameter creation (port of ``repro.models.layers``).

The layer functions keep the JAX package's order of casts: every weight is
cast to the activations' dtype at its use (``w.to(x.dtype)``), norms take
float32 statistics and cast back before the weight multiply; ``linear`` is
``x @ w`` plus a bias.  So the parameters' dtype and the compute dtype are
separate: a served model stores its weights in the dtype it computes in,
a trained one keeps float32 masters and computes in ``cfg.dtype`` (bf16 for
every published config), as the JAX package does.

Parameters are created from an explicit ``torch.Generator`` with the
scales of the JAX ``ParamDef``s: normal weights ``N(0, scale^2)`` drawn in
float32 and cast to the storage dtype once, norm weights one, biases zero.
The JAX package draws from ``jax.random`` keyed by the parameter path, so
the two packages share weights only through
:func:`repro_torch.models.convert.params_from_jax`.  :class:`Params` holds
a nested dict of weights as modules named by the JAX parameter paths;
:class:`LMBase` is what every model shares (dtypes, device, counts, the
unembedding, the flat parameter dict training works on).
:func:`cross_entropy_loss` is the training loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


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


def dense(d_in: int, d_out: int, **kw) -> torch.Tensor:
    """``(d_in, d_out)`` weight at the ``dense_def`` scale ``d_in ** -0.5``."""
    return normal((d_in, d_out), d_in ** -0.5, **kw)


def norm_params(d: int, norm_type: str, *, device, dtype) -> dict:
    p = {"w": torch.ones(d, device=device, dtype=dtype)}
    if norm_type == "ln":
        p["b"] = torch.zeros(d, device=device, dtype=dtype)
    return p


def mlp_params(d_model: int, d_ff: int, *, gated: bool, generator, device, dtype) -> dict:
    kw = dict(generator=generator, device=device, dtype=dtype)
    if gated:
        return {"gate": dense(d_model, d_ff, **kw), "up": dense(d_model, d_ff, **kw),
                "down": dense(d_ff, d_model, **kw)}
    # The non-gated MLP always carries biases (``bias=not gated`` in the JAX
    # layer defs).
    return {"in": dense(d_model, d_ff, **kw), "out": dense(d_ff, d_model, **kw),
            "b_in": torch.zeros(d_ff, device=device, dtype=dtype),
            "b_out": torch.zeros(d_model, device=device, dtype=dtype)}


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
