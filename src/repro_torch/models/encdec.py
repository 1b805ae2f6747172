"""Whisper-style encoder-decoder for serving (port of ``repro.models.encdec``
and the encoder-decoder half of ``ModelBundle.prefill`` / ``serve_step``).

The audio convolution front end is a stub, as in the JAX package: the
encoder takes precomputed frame embeddings ``(B, S_enc, d)``.  Both stacks
add the fixed sinusoidal table (the JAX package's decoder positions are
sinusoidal too, not learned) and use LayerNorm and the GELU MLP.

:class:`EncDecLM`:

* ``prefill(enc_embeds, dec_tokens)`` -> (last-position logits ``(B, V)``,
  per-decoder-layer caches ``{"k", "v", "xk", "xv"}``): the encoder's
  non-causal self-attention, the decoder's causal self-attention and its
  cross-attention over the encoder states all go through the
  flash-attention kernel (one launch each a layer);
* ``serve_step(tokens, pos, caches)``: one decoder step at cursor ``pos``,
  self-attention K/V written at ``pos``; both attentions over the caches in
  plain PyTorch (``decode_attention``), as the JAX package computes them;
* ``train_loss(batch, params)``: the JAX ``_encdec_loss`` over
  ``enc_embeds``, ``dec_tokens`` and ``targets``, every attention through
  ``train_attention`` (no flash kernel), each layer under ``cfg.remat``;
  its ``aux_loss`` is 0.

:class:`MeshEncDecLM` is the same model on a model mesh (``shard_params``
and ``mesh_model`` of :mod:`repro_torch.models.model` build it): the
encoder's and both decoder attentions' heads, the MLP's ``d_ff`` and the
vocabulary over ``model``, the batch over the batch axes, as
:class:`~repro_torch.models.model.MeshLM` lays out a decoder-only model.
"""

from __future__ import annotations

import time

import torch
from torch import nn

from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import attention_defs
from repro_torch.models.layers import (
    LMBase,
    ParamDef,
    Params,
    cross_entropy_loss,
    flatten_defs,
    materialize,
    mlp_apply,
    mlp_defs,
    nest,
    norm_apply,
    norm_defs,
)
from repro_torch.models.model import MeshLM
from repro_torch.models.rope import sinusoidal_positions, sinusoidal_rows
from repro_torch.models.transformer import (
    CacheBlock,
    cross_spec,
    mesh_attn,
    mesh_mlp,
    mesh_norm,
    remat,
)


def _enc_layer_defs(cfg) -> dict:
    d = cfg.d_model
    return {"ln1": norm_defs(d, cfg.norm_type), "attn": attention_defs(cfg),
            "ln2": norm_defs(d, cfg.norm_type),
            "mlp": mlp_defs(d, cfg.d_ff, gated=cfg.mlp_gated)}


def _dec_layer_defs(cfg) -> dict:
    d = cfg.d_model
    return {"ln1": norm_defs(d, cfg.norm_type), "self": attention_defs(cfg),
            "lnx": norm_defs(d, cfg.norm_type), "cross": attention_defs(cfg),
            "ln2": norm_defs(d, cfg.norm_type),
            "mlp": mlp_defs(d, cfg.d_ff, gated=cfg.mlp_gated)}


def encdec_defs(cfg) -> dict:
    """``{"enc_layers": {i: defs}, "dec_layers": ..., "top": ...}``, each
    layer's defs the JAX stacks' without the layer axis."""
    d, v = cfg.d_model, cfg.vocab_size
    top = {"embed": ParamDef((v, d), ("vocab", "fsdp"), scale=0.02),
           "enc_final": norm_defs(d, cfg.norm_type), "dec_final": norm_defs(d, cfg.norm_type)}
    if not cfg.tie_embeddings:
        top["unembed"] = ParamDef((d, v), ("fsdp", "vocab"), scale=d ** -0.5)
    return {"enc_layers": {str(i): _enc_layer_defs(cfg) for i in range(cfg.encoder_layers)},
            "dec_layers": {str(i): _dec_layer_defs(cfg) for i in range(cfg.decoder_layers)},
            "top": top}


def build_encdec(cfg, *, generator, device, dtype) -> "EncDecLM":
    """Random weights for ``cfg`` (vocabulary already padded), drawn
    embedding, encoder layers, decoder layers, unembedding."""
    defs = encdec_defs(cfg)
    kw = dict(generator=generator, device=device, dtype=dtype)
    top_defs = defs["top"]
    top = materialize({"embed": top_defs["embed"]}, **kw)
    enc = [materialize(p, **kw) for p in defs["enc_layers"].values()]
    dec = [materialize(p, **kw) for p in defs["dec_layers"].values()]
    top.update(materialize({k: v for k, v in top_defs.items() if k != "embed"}, **kw))
    return EncDecLM(cfg, enc, dec, top)


class GreedyDecoding:
    """Greedy decoding of an encoder-decoder model through its ``prefill``
    and ``serve_step``, one device or a mesh."""

    def greedy(self, enc_embeds: torch.Tensor, dec_tokens: torch.Tensor,
               max_new_tokens: int, use_kernel="auto"):
        """Greedy decoding of one wave -> (new tokens (B, max_new_tokens)
        int64 on the host, ``{"prefill_s", "decode_s", "decode_steps"}``)."""
        clock = time.perf_counter
        b, s = dec_tokens.shape
        t0 = clock()
        last, caches = self.prefill(enc_embeds, dec_tokens, cache_len=s + max_new_tokens,
                                    use_kernel=use_kernel)
        tok = torch.argmax(last, dim=-1)
        self._sync()
        t1 = clock()
        out = [tok]
        for i in range(max_new_tokens - 1):
            logits, caches = self.serve_step(tok[:, None], s + i, caches)
            tok = torch.argmax(logits[:, 0], dim=-1)
            out.append(tok)
        self._sync()
        stats = dict(prefill_s=t1 - t0, decode_s=clock() - t1, decode_steps=max_new_tokens - 1)
        return torch.stack(out, dim=1).cpu(), stats

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class EncDecLM(GreedyDecoding, LMBase):
    """An encoder-decoder LM for serving (weights in one dtype, one device)."""

    def __init__(self, cfg, enc_layers: list, dec_layers: list, top: dict):
        super().__init__()
        self.cfg = cfg
        self.enc_layers = nn.ModuleList(Params(p) for p in enc_layers)
        self.dec_layers = nn.ModuleList(Params(p) for p in dec_layers)
        self.top = Params(top)

    def param_defs(self) -> dict:
        """name -> :class:`ParamDef` of every weight."""
        return flatten_defs(encdec_defs(self.cfg))

    def _norm(self, p, x):
        return norm_apply(p, x, self.cfg.norm_type, self.cfg.norm_eps)

    def _mlp(self, p, x):
        return x + mlp_apply(p["mlp"], self._norm(p["ln2"], x), gated=self.cfg.mlp_gated)

    def encode(self, enc_embeds: torch.Tensor, use_kernel="auto") -> torch.Tensor:
        """(B, S_enc, d) frame embeddings -> final-normed encoder states."""
        cfg = self.cfg
        x = enc_embeds.to(self.device, self.dtype)
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model, device=self.device).to(x.dtype)
        for p in self.enc_layers:
            q, k, v = attn_mod.qkv_project(p["attn"], self._norm(p["ln1"], x), cfg)
            out = attn_mod.attention(q, k, v, causal=False, use_kernel=use_kernel)
            x = self._mlp(p, x + attn_mod.out_project(p["attn"], out))
        return self._norm(self.top["enc_final"], x)

    def embed_decoder_tokens(self, tokens: torch.Tensor, pos: int | None = None,
                             top=None) -> torch.Tensor:
        """Token embeddings plus the sinusoidal rows of their positions:
        ``0 .. S-1`` (``pos`` None), or the one decode row at cursor ``pos``."""
        table = (self.top if top is None else top)["embed"]
        tokens = tokens.to(table.device)
        x = table[tokens].to(self.dtype)
        if pos is None:
            rows = sinusoidal_positions(tokens.shape[1], self.cfg.d_model, device=table.device)
        else:
            rows = sinusoidal_rows(torch.tensor(pos, device=table.device), self.cfg.d_model)
        return x + rows.to(x.dtype)

    def new_caches(self, batch: int, length: int, device=None, cross: int | None = None) -> list:
        """Zeroed per-decoder-layer self-attention caches ``k``, ``v`` of
        ``(B, length, KV, D)`` (on ``device``, default the model's); prefill
        adds the cross-attention ``xk``, ``xv`` (``(B, S_enc, KV, D)``, the
        encoder states projected), which ``cross`` (= S_enc) allocates here
        too."""
        cfg = self.cfg
        kw = dict(dtype=self.dtype, device=self.device if device is None else device)
        lengths = {"k": length, "v": length}
        if cross is not None:
            lengths.update(xk=cross, xv=cross)
        return [{key: torch.zeros((batch, n, cfg.num_kv_heads, cfg.head_dim), **kw)
                 for key, n in lengths.items()} for _ in self.dec_layers]

    def _decode_stack(self, x, caches, enc_out, pos, use_kernel) -> torch.Tensor:
        """Decoder layers over x -> final-normed states; ``pos`` None is
        prefill (caches filled from x and ``enc_out``), an int a step at that
        cursor."""
        cfg = self.cfg
        for p, cache in zip(self.dec_layers, caches):
            q, k, v = attn_mod.qkv_project(p["self"], self._norm(p["ln1"], x), cfg)
            start = 0 if pos is None else pos
            cache["k"][:, start:start + q.shape[1]] = k
            cache["v"][:, start:start + q.shape[1]] = v
            if pos is None:
                out = attn_mod.attention(q, k, v, causal=True, use_kernel=use_kernel)
            else:
                out = attn_mod.decode_attention(q, cache["k"], cache["v"], pos)
            x = x + attn_mod.out_project(p["self"], out)

            hx = self._norm(p["lnx"], x)
            if pos is None:
                qx, xk, xv = attn_mod.qkv_project(p["cross"], hx, cfg, xkv=enc_out)
                cache["xk"], cache["xv"] = xk, xv
                outx = attn_mod.attention(qx, xk, xv, causal=False, use_kernel=use_kernel)
            else:  # the JAX package projects K and V of the step too, unused
                qx = attn_mod.qkv_project(p["cross"], hx, cfg)[0]
                outx = attn_mod.decode_attention(qx, cache["xk"], cache["xv"])
            x = self._mlp(p, x + attn_mod.out_project(p["cross"], outx))
        return self._norm(self.top["dec_final"], x)

    def _enc_block_train(self, p, x):
        q, k, v = attn_mod.qkv_project(p["attn"], self._norm(p["ln1"], x), self.cfg)
        out = attn_mod.train_attention(q, k, v, causal=False, cfg=self.cfg)
        return self._mlp(p, x + attn_mod.out_project(p["attn"], out))

    def _dec_block_train(self, p, x, enc_out):
        cfg = self.cfg
        q, k, v = attn_mod.qkv_project(p["self"], self._norm(p["ln1"], x), cfg)
        x = x + attn_mod.out_project(p["self"], attn_mod.train_attention(q, k, v, causal=True,
                                                                         cfg=cfg))
        qx, xk, xv = attn_mod.qkv_project(p["cross"], self._norm(p["lnx"], x), cfg, xkv=enc_out)
        outx = attn_mod.train_attention(qx, xk, xv, causal=False, cfg=cfg)
        return self._mlp(p, x + attn_mod.out_project(p["cross"], outx))

    def train_loss(self, batch: dict, params: dict | None = None):
        """-> (loss, {"loss", "aux_loss": 0}) on ``enc_embeds`` (B, S_enc,
        d), ``dec_tokens`` and ``targets`` (B, S), with the weights
        ``params`` (a flat dict; default: the model's own parameters)."""
        cfg = self.cfg
        tree = nest(dict(self.named_parameters()) if params is None else params)
        top = tree["top"]
        x = batch["enc_embeds"].to(self.dtype)
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model, device=x.device).to(x.dtype)
        for i in range(len(self.enc_layers)):
            x = remat(self._enc_block_train, cfg.remat)(tree["enc_layers"][str(i)], x)
        enc_out = self._norm(top["enc_final"], x)
        x = self.embed_decoder_tokens(batch["dec_tokens"], top=top)
        for i in range(len(self.dec_layers)):
            x = remat(self._dec_block_train, cfg.remat)(tree["dec_layers"][str(i)], x, enc_out)
        logits = self.unembed(self._norm(top["dec_final"], x), top)
        loss = cross_entropy_loss(logits, batch["targets"])
        return loss, {"loss": loss, "aux_loss": torch.zeros((), dtype=torch.float32,
                                                            device=loss.device)}

    @torch.inference_mode()
    def prefill(self, enc_embeds: torch.Tensor, dec_tokens: torch.Tensor, *,
                cache_len: int | None = None, use_kernel="auto"):
        """enc_embeds (B, S_enc, d), dec_tokens (B, S) -> (logits (B, V) at
        the last decoder position, caches of self-attention length
        ``cache_len`` (default S))."""
        enc_out = self.encode(enc_embeds, use_kernel)
        b, s = dec_tokens.shape
        caches = self.new_caches(b, s if cache_len is None else cache_len)
        x = self._decode_stack(self.embed_decoder_tokens(dec_tokens), caches, enc_out, None,
                               use_kernel)
        return self.unembed(x[:, -1:])[:, 0], caches

    @torch.inference_mode()
    def serve_step(self, tokens: torch.Tensor, pos: int, caches: list):
        """One decoder step: tokens (B, 1) at cursor ``pos`` -> (logits
        (B, 1, V), caches)."""
        pos = int(pos)
        x = self.embed_decoder_tokens(tokens, pos)
        return self.unembed(self._decode_stack(x, caches, None, pos, "auto")), caches


class MeshEncDecLM(GreedyDecoding, MeshLM):
    """:class:`EncDecLM` on a model mesh (the JAX ``encode`` /
    ``decode_stack`` / ``embed_decoder_tokens`` and ``_encdec_loss`` under
    the sharding rules): every position holds its shard of every weight,
    as ``param_specs`` lays it out.

    * ``prefill(enc_embeds, dec_tokens)`` -> (logits ``(B, V)`` gathered
      onto ``device``, the first position's, and one list of per-layer
      caches a position): the encoder's non-causal attention, the decoder's
      causal self-attention and its cross-attention over the encoder states
      through the flash kernel at the position's heads (one launch each a
      layer a position); each position's caches hold its blocks of ``k``,
      ``v``, ``xk`` and ``xv`` as ``cache_specs`` lays them out (the
      encoder's length whole where it does not divide over the sequence's
      axes: :func:`~repro_torch.models.transformer.cross_spec`);
    * ``serve_step(tokens, pos, caches)``: one decoder step, as
      :meth:`EncDecLM.serve_step`;
    * ``greedy(...)`` drives them, as :meth:`EncDecLM.greedy`;
    * ``train_loss(batch, shards)``: ``enc_embeds``, ``dec_tokens`` and
      ``targets``, the vocabulary-parallel cross-entropy of
      :class:`~repro_torch.models.model.MeshLM`, every attention through
      ``train_attention``, each layer under ``cfg.remat``; ``aux_loss`` 0.
    """

    final_norm = "top.dec_final"

    def new_caches(self, batch: int, length: int, device=None, cross: int | None = None) -> list:
        """Zeroed self-attention caches ``k``, ``v`` a decoder layer a
        position (on its device, or all on ``device``), one
        :class:`~repro_torch.models.transformer.CacheBlock` each: the block
        of ``(batch, length, KV, D)`` :meth:`cache_layout` gives the
        position; prefill adds the cross-attention's ``xk``, ``xv``, which
        ``cross`` (= S_enc) allocates here too."""
        cfg = self.cfg
        spec = self.cache_layout(batch, length)[0]["k"]
        whole = {"k": (batch, length), "v": (batch, length)}
        specs = {"k": spec, "v": spec}
        if cross is not None:
            whole.update(xk=(batch, cross), xv=(batch, cross))
            specs["xk"] = specs["xv"] = cross_spec(spec, cross, self.mesh)
        shapes = {key: self._block(whole[key] + (cfg.num_kv_heads, cfg.head_dim), specs[key])
                  for key in whole}
        return [[CacheBlock({key: torch.zeros(shape, dtype=self.dtype, device=dev)
                             for key, shape in shapes.items()}, specs)
                 for _ in range(cfg.decoder_layers)]
                for dev in (self.ctx.devices if device is None else [device] * self.ctx.n)]

    def _enc_layer(self, i: int, xs: list, use_kernel, train: bool) -> list:
        pre = f"enc_layers.{i}."
        hs = mesh_norm(self, pre + "ln1", xs)
        mix = mesh_attn(self, pre + "attn.", hs, None, None, None, use_kernel, causal=False,
                        train=train)
        xs = [x + y for x, y in zip(xs, mix)]
        ys = mesh_mlp(self, pre + "mlp.", mesh_norm(self, pre + "ln2", xs))
        return [x + y for x, y in zip(xs, ys)]

    def _dec_layer(self, i: int, xs: list, enc: list | None, caches, pos, use_kernel,
                   train: bool) -> list:
        pre = f"dec_layers.{i}."
        mix = mesh_attn(self, pre + "self.", mesh_norm(self, pre + "ln1", xs), None, caches,
                        pos, use_kernel, train=train)
        xs = [x + y for x, y in zip(xs, mix)]
        mix = mesh_attn(self, pre + "cross.", mesh_norm(self, pre + "lnx", xs), None, caches,
                        pos, use_kernel, causal=False, cross=True, xkv=enc, train=train)
        xs = [x + y for x, y in zip(xs, mix)]
        ys = mesh_mlp(self, pre + "mlp.", mesh_norm(self, pre + "ln2", xs))
        return [x + y for x, y in zip(xs, ys)]

    def encode(self, enc_embeds: list, use_kernel="auto", train: bool = False) -> list:
        """Each position's (B / n_batch, S_enc, d) frame embeddings -> its
        final-normed encoder states (replicated over ``model``)."""
        cfg = self.cfg
        xs = [x.to(self.dtype) + sinusoidal_positions(x.shape[1], cfg.d_model,
                                                      device=x.device).to(self.dtype)
              for x in enc_embeds]
        layer = remat(self._enc_layer, cfg.remat) if train else self._enc_layer
        for i in range(cfg.encoder_layers):
            xs = layer(i, xs, use_kernel, train)
        return mesh_norm(self, "top.enc_final", xs)

    def embed_decoder_tokens(self, tokens: list, pos: int | None = None) -> list:
        """Each position's token rows -> their vocabulary-parallel
        embeddings plus the sinusoidal rows of positions ``0 .. S-1``
        (``pos`` None) or of the decode cursor ``pos``."""
        d = self.cfg.d_model
        out = []
        for x in self._embed(tokens):
            if pos is None:
                rows = sinusoidal_positions(x.shape[1], d, device=x.device)
            else:
                rows = sinusoidal_rows(torch.tensor(pos, device=x.device), d)
            out.append(x + rows.to(x.dtype))
        return out

    def train_loss_positions(self, parts: list):
        """:meth:`EncDecLM.train_loss` on inputs already split (one dict a
        position, as :meth:`split_inputs` gives them) -> (loss, {"loss",
        "aux_loss": 0})."""
        cfg = self.cfg
        enc = self.encode([p["enc_embeds"] for p in parts], train=True)
        xs = self.embed_decoder_tokens([p["dec_tokens"] for p in parts])
        layer = remat(self._dec_layer, cfg.remat)
        for i in range(cfg.decoder_layers):
            xs = layer(i, xs, enc, None, None, None, True)
        loss = self._mean_nll(xs, [p["targets"] for p in parts])
        return loss, {"loss": loss, "aux_loss": torch.zeros_like(loss)}

    @torch.inference_mode()
    def prefill(self, enc_embeds: torch.Tensor, dec_tokens: torch.Tensor, *,
                cache_len: int | None = None, use_kernel="auto"):
        """:meth:`EncDecLM.prefill` on the mesh -> (logits (B, V) on
        ``device``, each position's caches)."""
        ctx = self.ctx
        b, s = dec_tokens.shape
        enc = self.encode(ctx.split_batch(enc_embeds), use_kernel)
        caches = self.new_caches(b, s if cache_len is None else cache_len)
        xs = self.embed_decoder_tokens(ctx.split_batch(dec_tokens))
        for i in range(self.cfg.decoder_layers):
            xs = self._dec_layer(i, xs, enc, [c[i] for c in caches], None, use_kernel, False)
        return self._logits([x[:, -1:] for x in xs])[:, 0], caches

    @torch.inference_mode()
    def serve_step(self, tokens: torch.Tensor, pos: int, caches: list):
        """:meth:`EncDecLM.serve_step` on the mesh -> (logits (B, 1, V) on
        ``device``, the caches with this step's K/V written at ``pos``)."""
        pos = int(pos)
        xs = self.embed_decoder_tokens(self.ctx.split_batch(tokens), pos)
        for i in range(self.cfg.decoder_layers):
            xs = self._dec_layer(i, xs, None, [c[i] for c in caches], pos, "auto", False)
        return self._logits(xs), caches
