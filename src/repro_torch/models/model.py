"""build_model(): a servable decoder for the dense family
(port of the serving half of ``repro.models.model``).

:class:`DecoderLM` mirrors ``ModelBundle.prefill`` and ``serve_step``:

* ``prefill(tokens)`` -> (last-position logits ``(B, V)``, per-layer KV
  caches), the prompt's attention through the flash-attention kernel;
* ``serve_step(tokens, pos, caches)`` -> (logits ``(B, 1, V)``, caches),
  one decode step at cursor ``pos``, the caches written in place.

Weights are stored in the serving dtype (the JAX engine keeps float32
weights and casts them at every use, which rounds to the same values).
The vocabulary is padded to a multiple of 16 as the JAX package pads it.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import attention_params
from repro_torch.models.layers import mlp_params, norm_apply, norm_params, normal
from repro_torch.models.rope import rope_cos_sin
from repro_torch.models.transformer import block_apply

UNPORTED = "ROADMAP.md §1, item 1 (the other LM families)"


def _pad_vocab(v: int, multiple: int = 16) -> int:
    return -(-v // multiple) * multiple


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


class DecoderLM(nn.Module):
    """A dense decoder-only LM for serving (weights in one dtype, one device)."""

    def __init__(self, cfg: ModelConfig, layers: list, top: dict):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(Params(p) for p in layers)
        self.top = Params(top)

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

    def new_caches(self, batch: int, length: int) -> list:
        """Zeroed per-layer ``{"k", "v"}`` caches of ``(B, length, KV, D)``
        (zeros, so unwritten slots never carry NaN into the masked sum)."""
        cfg = self.cfg
        shape = (batch, length, cfg.num_kv_heads, cfg.head_dim)
        return [{"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                 "v": torch.zeros(shape, dtype=self.dtype, device=self.device)}
                for _ in self.layers]

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = norm_apply(self.top["final_norm"], x, cfg.norm_type, cfg.norm_eps)
        if cfg.tie_embeddings:
            return x @ self.top["embed"].to(x.dtype).T
        return x @ self.top["unembed"].to(x.dtype)

    def _run(self, tokens, positions, caches, pos, use_kernel) -> torch.Tensor:
        cfg = self.cfg
        x = self.top["embed"][tokens].to(self.dtype)
        rope = rope_cos_sin(positions, cfg.head_dim, theta=cfg.rope_theta)  # shared by all layers
        for p, cache in zip(self.layers, caches):
            x = block_apply(p, x, cfg, rope, cache, pos, use_kernel)
        return x

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, *, cache_len: int | None = None,
                use_kernel="auto"):
        """tokens (B, S) -> (logits (B, V) at the last position, caches of
        length ``cache_len`` (default S) holding the prompt's K/V)."""
        b, s = tokens.shape
        tokens = tokens.to(self.device)
        caches = self.new_caches(b, s if cache_len is None else cache_len)
        positions = torch.arange(s, device=self.device).expand(b, s)
        x = self._run(tokens, positions, caches, None, use_kernel)
        return self._logits(x[:, -1:])[:, 0], caches

    @torch.inference_mode()
    def serve_step(self, tokens: torch.Tensor, pos: int, caches: list):
        """One decode step: tokens (B, 1) at cursor ``pos`` -> (logits
        (B, 1, V), caches with this step's K/V written at ``pos``)."""
        b = tokens.shape[0]
        positions = torch.full((b, 1), pos, device=self.device)
        x = self._run(tokens.to(self.device), positions, caches, int(pos), "auto")
        return self._logits(x), caches


def check_family(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this package cannot run yet."""
    if cfg.family != "dense" or cfg.mrope_sections or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name} is a {cfg.family} model; the port serves the dense "
            f"family only, the others wait for {UNPORTED}"
        )


def build_model(cfg: ModelConfig, *, device="cuda", dtype: torch.dtype | None = None,
                generator: torch.Generator | None = None) -> DecoderLM:
    """A randomly initialised :class:`DecoderLM` for ``cfg`` on ``device``.

    ``dtype`` defaults to ``cfg.dtype``; weights come from ``generator``
    (default: seed 0 on ``device``) with the JAX package's init scales.
    """
    check_family(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype) if dtype is None else dtype
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    cfg = dataclasses.replace(cfg, vocab_size=_pad_vocab(cfg.vocab_size))
    kw = dict(generator=generator, device=dev, dtype=dtype)
    d, v = cfg.d_model, cfg.vocab_size
    layers = [
        {"ln1": norm_params(d, cfg.norm_type, device=dev, dtype=dtype),
         "attn": attention_params(cfg, **kw),
         "ln2": norm_params(d, cfg.norm_type, device=dev, dtype=dtype),
         "mlp": mlp_params(d, cfg.d_ff, gated=cfg.mlp_gated, **kw)}
        for _ in range(cfg.num_layers)
    ]
    top = {"embed": normal((v, d), 0.02, **kw),
           "final_norm": norm_params(d, cfg.norm_type, device=dev, dtype=dtype)}
    if not cfg.tie_embeddings:
        top["unembed"] = normal((d, v), d ** -0.5, **kw)
    return DecoderLM(cfg, layers, top)
