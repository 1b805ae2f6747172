"""Primitive layers and parameter creation (port of ``repro.models.layers``).

The layer functions take weights stored in the working dtype and keep the
JAX package's order of casts: norms take float32 statistics and cast back
before the weight multiply; ``linear`` is ``x @ w`` plus a bias.

Parameters are created from an explicit ``torch.Generator`` with the
scales of the JAX ``ParamDef``s: normal weights ``N(0, scale^2)`` drawn in
float32 and cast to the storage dtype once, norm weights one, biases zero.
The JAX package draws from ``jax.random`` keyed by the parameter path, so
the two packages share weights only through
:func:`repro_torch.models.convert.params_from_jax`.  :class:`Params` holds
a nested dict of weights as modules named by the JAX parameter paths;
:class:`LMBase` is what every served model shares (dtype, device, counts,
the unembedding).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Params(nn.Module):
    """A nested dict of weights as a module: ``p["attn"]["wq"]`` reads the
    parameter registered as ``attn.wq`` (the JAX package's parameter path)."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                self.add_module(name, Params(leaf))
            else:
                self.register_parameter(name, nn.Parameter(leaf, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def get(self, name: str, default=None):
        return getattr(self, name, default)


class LMBase(nn.Module):
    """What every served model shares: ``top`` holds the embedding table
    (and the unembedding unless tied); weights in one dtype on one device."""

    cfg = None
    top: Params

    @property
    def dtype(self) -> torch.dtype:
        return self.top["embed"].dtype

    @property
    def device(self) -> torch.device:
        return self.top["embed"].device

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def weight_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """Final-normed states (B, S, d) -> logits (B, S, V) (the embedding
        table transposed when tied)."""
        if self.cfg.tie_embeddings:
            return x @ self.top["embed"].to(x.dtype).T
        return x @ self.top["unembed"].to(x.dtype)


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
