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

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec
from repro_torch.models.attention import attention_params
from repro_torch.models.layers import (
    LMBase,
    Params,
    cross_entropy_loss,
    mlp_params,
    nest,
    norm_apply,
    norm_params,
    normal,
)
from repro_torch.models.mamba import mamba_cache, mamba_params
from repro_torch.models.moe import moe_params
from repro_torch.models.rope import rope_cos_sin
from repro_torch.models.transformer import block_apply, group_pattern, remat

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

    def new_caches(self, batch: int, length: int) -> list:
        """Zeroed per-layer caches: ``{"k", "v"}`` of ``(B, length, KV, D)``
        for attention (zeros, so unwritten slots never carry NaN into the
        masked sum), the Mamba cache for SSM layers."""
        cfg = self.cfg
        shape = (batch, length, cfg.num_kv_heads, cfg.head_dim)
        kw = dict(dtype=self.dtype, device=self.device)
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


def layer_params(cfg: ModelConfig, kind: str, ffn_kind: str, **kw) -> dict:
    """One decoder layer's weights, named as the JAX ``layer_defs``."""
    d, dev, dtype = cfg.d_model, kw["device"], kw["dtype"]
    p = {"ln1": norm_params(d, cfg.norm_type, device=dev, dtype=dtype)}
    if kind == "attn":
        p["attn"] = attention_params(cfg, **kw)
    else:
        p["ssm"] = mamba_params(cfg, **kw)
    if ffn_kind != "none":
        p["ln2"] = norm_params(d, cfg.norm_type, device=dev, dtype=dtype)
    if ffn_kind == "dense":
        p["mlp"] = mlp_params(d, cfg.d_ff, gated=cfg.mlp_gated, **kw)
    elif ffn_kind == "moe":
        p["moe"] = moe_params(cfg, **kw)
    return p


def build_model(cfg: ModelConfig, *, device="cuda", dtype: torch.dtype | None = None,
                compute_dtype: torch.dtype | str | None = None,
                generator: torch.Generator | None = None):
    """A randomly initialised model for ``cfg`` on ``device``: a
    :class:`DecoderLM`, or an :class:`~repro_torch.models.encdec.EncDecLM`
    for the encoder-decoder family.

    ``dtype`` (the weights') defaults to ``cfg.dtype``, ``compute_dtype``
    to ``dtype``; weights come from ``generator`` (default: seed 0 on
    ``device``) with the JAX package's init scales.  On the ``meta`` device
    the model is a skeleton: names, shapes and dtypes, nothing allocated.
    """
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype) if dtype is None else dtype
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    cfg = dataclasses.replace(cfg, vocab_size=_pad_vocab(cfg.vocab_size))
    kw = dict(generator=generator, device=dev, dtype=dtype)
    if isinstance(compute_dtype, str):
        compute_dtype = getattr(torch, compute_dtype)
    model = encdec.build_encdec(cfg, **kw) if cfg.is_encdec else _build_decoder(cfg, **kw)
    model.compute_dtype = compute_dtype
    return model


def _build_decoder(cfg: ModelConfig, **kw) -> DecoderLM:
    pattern = group_pattern(cfg)
    if cfg.num_layers % len(pattern):
        raise ValueError(f"{cfg.num_layers} layers is not a whole number of "
                         f"{len(pattern)}-layer groups")
    layers = [layer_params(cfg, *pattern[i % len(pattern)], **kw)
              for i in range(cfg.num_layers)]
    d, v = cfg.d_model, cfg.vocab_size
    # Embedding-input archs still decode text: the table serves serve_step.
    top = {"embed": normal((v, d), 0.02, **kw),
           "final_norm": norm_params(d, cfg.norm_type, device=kw["device"], dtype=kw["dtype"])}
    if not cfg.tie_embeddings:
        top["unembed"] = normal((d, v), d ** -0.5, **kw)
    return DecoderLM(cfg, layers, top)
