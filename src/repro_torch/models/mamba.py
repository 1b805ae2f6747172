"""Mamba-2 mixer (state-space duality, SSD): chunked prefill and recurrent
decode (port of ``repro.models.mamba``).

Prefill runs the SSD algorithm of Mamba-2 [arXiv:2405.21060]: within each
chunk of Q positions a quadratic, attention-like product; across chunks a
recurrence over small (B, H, P, N) states, here a Python loop over the
S/Q chunks where the JAX package runs ``lax.scan``.  The dtype mix is the
JAX package's: the products in the model dtype, the decays in float32.
Decode is the exact one-token recurrence.  No TPU kernel exists for either;
both are plain PyTorch, and training differentiates the chunked SSD
through its Python loop.

As in the JAX package the in-projection is split per stream (z, x, B, C,
dt) and the depthwise causal convolution runs as three small convolutions
(x, B, C).  A layer's decode cache is ``{"state": (B, H, P, N),
"conv_x": (B, K-1, d_in), "conv_b", "conv_c": (B, K-1, N)}``: the recurrent
state and the last K-1 pre-convolution inputs of each stream.

:func:`mesh_mamba` is the mixer tensor parallel on a model mesh (the JAX
``mamba_apply`` under ``mamba_defs``' shardings): ``d_inner`` and the SSM
heads over ``model``, B and C whole on every position.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamDef


def mamba_dims(cfg):
    """-> (d_inner, SSM heads, groups); one B/C group shared by every head."""
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, d_in // cfg.ssm_headdim, 1


def mamba_defs(cfg) -> dict:
    d, n, k = cfg.d_model, cfg.ssm_state, cfg.ssm_conv
    d_in, h, g = mamba_dims(cfg)
    return {
        "in_z": ParamDef((d, d_in), ("fsdp", "ff"), scale=d ** -0.5),
        "in_x": ParamDef((d, d_in), ("fsdp", "ff"), scale=d ** -0.5),
        "in_b": ParamDef((d, g * n), ("fsdp", "none"), scale=d ** -0.5),
        "in_c": ParamDef((d, g * n), ("fsdp", "none"), scale=d ** -0.5),
        "in_dt": ParamDef((d, h), ("fsdp", "ssm_heads"), scale=d ** -0.5),
        "conv_x": ParamDef((k, d_in), ("none", "ff"), scale=k ** -0.5),
        "conv_b": ParamDef((k, g * n), ("none", "none"), scale=k ** -0.5),
        "conv_c": ParamDef((k, g * n), ("none", "none"), scale=k ** -0.5),
        "dt_bias": ParamDef((h,), ("ssm_heads",), init="zeros"),
        "a_log": ParamDef((h,), ("ssm_heads",), init="zeros"),
        "d_skip": ParamDef((h,), ("ssm_heads",), init="ones"),
        "norm": ParamDef((d_in,), ("ff",), init="ones"),
        "out": ParamDef((d_in, d), ("ff", "fsdp"), scale=d_in ** -0.5),
    }


def mamba_cache(cfg, batch: int, *, device, dtype) -> dict:
    """A zeroed decode cache of one mamba layer."""
    d_in, h, g = mamba_dims(cfg)
    n, k = cfg.ssm_state, cfg.ssm_conv

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    return {"state": zeros(batch, h, cfg.ssm_headdim, n),
            "conv_x": zeros(batch, k - 1, d_in),
            "conv_b": zeros(batch, k - 1, g * n),
            "conv_c": zeros(batch, k - 1, g * n)}


def _causal_conv(x: torch.Tensor, w: torch.Tensor, cache: torch.Tensor | None = None):
    """Depthwise causal convolution, x (B, S, C), w (K, C) -> (y, the new
    cache: the last K-1 inputs, or None without a cache)."""
    k = w.shape[0]
    if cache is not None:
        ctx = torch.cat([cache.to(x.dtype), x], dim=1)
        new_cache = ctx[:, -(k - 1):] if k > 1 else cache
    else:
        ctx = F.pad(x, (0, 0, k - 1, 0))
        new_cache = None
    s = x.shape[1]
    y = torch.zeros_like(x)
    for j in range(k):  # y[t] = sum_j w[j] * ctx[t + j]
        y = y + ctx[:, j:j + s, :] * w[j].to(x.dtype)
    return y, new_cache


def _cumsum(a: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum`` along ``dim``.  Where deterministic algorithms are on
    and ``a`` lies on the card (the training command line's setting),
    ``torch.cumsum`` of floats has no deterministic kernel and raises: the
    same sums then run as a product with a lower-triangular matrix of ones,
    in another order (float32 rounding apart)."""
    if not (a.is_cuda and torch.are_deterministic_algorithms_enabled()):
        return torch.cumsum(a, dim=dim)
    n = a.shape[dim]
    ones = torch.ones((n, n), dtype=a.dtype, device=a.device).tril()
    return (a.movedim(dim, -1) @ ones.T).movedim(-1, dim)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., Q) -> (..., Q, Q): ``out[q, t] = sum(a[t+1 .. q])`` for
    ``t <= q``, -inf above the diagonal."""
    q = a.shape[-1]
    cs = _cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, -torch.inf)


def ssd_chunked(x, dt, a, b, c, *, chunk: int, initial_state=None):
    """SSD over the sequence: ``state[t] = exp(a dt[t]) state[t-1] +
    dt[t] b[t] x[t]``, ``y[t] = c[t] . state[t]``.

    x (B, S, H, P), dt (B, S, H) positive float32, a (H,) negative float32,
    b and c (B, S, H, N) -> (y (B, S, H, P), final state (B, H, P, N)).
    S must be a multiple of ``min(chunk, S)``, as the JAX package asserts.
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"SSD prefill: sequence length {s} is not a multiple of the "
                         f"chunk {q}")
    nc = s // q

    adt = a[None, None, :] * dt  # (B, S, H), negative
    xdt = x * dt[..., None].to(x.dtype)
    xc = xdt.reshape(bsz, nc, q, h, p)
    bc = b.reshape(bsz, nc, q, h, n)
    cc = c.reshape(bsz, nc, q, h, n)
    ac = adt.reshape(bsz, nc, q, h)

    # Within a chunk: quadratic, like attention.
    decay = torch.exp(_segsum(ac.movedim(-1, -2)))  # (B, NC, H, Q, Q)
    scores = torch.einsum("bcqhn,bcthn->bchqt", cc, bc)
    y_diag = torch.einsum("bchqt,bcthp->bcqhp", (scores * decay).to(x.dtype), xc)

    # Each chunk's state contribution.
    cum = _cumsum(ac, dim=2)  # (B, NC, Q, H)
    total = cum[:, :, -1:, :]
    decay_to_end = torch.exp(total - cum)
    states = torch.einsum("bcqhn,bcqhp->bchpn",
                          bc * decay_to_end[..., None].to(bc.dtype), xc)

    # Across chunks: the state entering each chunk.
    chunk_decay = torch.exp(total[:, :, 0, :])  # (B, NC, H)
    carry = (initial_state if initial_state is not None
             else torch.zeros((bsz, h, p, n), dtype=x.dtype, device=x.device))
    entering = []
    for i in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None].to(carry.dtype) + states[:, i]
    prev_states = torch.stack(entering, dim=1)  # (B, NC, H, P, N)

    decay_from_start = torch.exp(cum)
    y_off = torch.einsum("bcqhn,bchpn->bcqhp",
                         cc * decay_from_start[..., None].to(cc.dtype), prev_states)
    return (y_diag + y_off).reshape(bsz, s, h, p), carry


def ssd_recurrent_step(state, x, dt, a, b, c):
    """One token: state (B, H, P, N), x (B, 1, H, P), dt (B, 1, H), a (H,),
    b and c (B, 1, H, N) -> (y (B, 1, H, P), the new state)."""
    adt = torch.exp(a[None, :] * dt[:, 0])  # (B, H)
    upd = torch.einsum("bhn,bhp->bhpn", b[:, 0] * dt[:, 0, :, None].to(b.dtype), x[:, 0])
    new_state = state * adt[:, :, None, None].to(state.dtype) + upd
    y = torch.einsum("bhn,bhpn->bhp", c[:, 0], new_state)[:, None]
    return y, new_state


def _gated_rmsnorm(y, z, w, eps: float) -> torch.Tensor:
    """Mamba-2's output norm, ``RMSNorm(y * silu(z)) * w``, in float32."""
    g = y.to(torch.float32) * F.silu(z.to(torch.float32))
    var = (g * g).mean(dim=-1, keepdim=True)
    return (g * torch.rsqrt(var + eps)).to(y.dtype) * w.to(y.dtype)


def mamba_apply(p, xres: torch.Tensor, *, cfg, cache: dict | None = None,
                collect: bool = False):
    """The Mamba-2 mixer, xres (B, S, d) -> (y (B, S, d), cache or None).

    ``cache`` (decode, S = 1): one recurrent step from it; the new cache is
    returned.  Without one (prefill), ``collect=True`` returns the final
    state and the last K-1 pre-convolution inputs as a fresh decode cache.
    """
    bsz, s, _ = xres.shape
    d_in, h, _ = mamba_dims(cfg)
    n, hd = cfg.ssm_state, cfg.ssm_headdim
    decode = cache is not None
    dt_ = xres.dtype

    z = xres @ p["in_z"].to(dt_)
    xs = xres @ p["in_x"].to(dt_)
    bs = xres @ p["in_b"].to(dt_)
    cs = xres @ p["in_c"].to(dt_)
    dt_raw = xres @ p["in_dt"].to(dt_)
    pre = (xs, bs, cs)  # the pre-convolution streams feed a prefill's cache

    xs, cache_x = _causal_conv(xs, p["conv_x"], cache["conv_x"] if decode else None)
    bs, cache_b = _causal_conv(bs, p["conv_b"], cache["conv_b"] if decode else None)
    cs, cache_c = _causal_conv(cs, p["conv_c"], cache["conv_c"] if decode else None)
    xs, bs, cs = F.silu(xs), F.silu(bs), F.silu(cs)

    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"].to(torch.float32))
    a = -torch.exp(p["a_log"].to(torch.float32))

    xh = xs.reshape(bsz, s, h, hd)
    # One B/C group: broadcast across every SSM head.
    bh = bs[:, :, None, :].expand(bsz, s, h, n)
    ch = cs[:, :, None, :].expand(bsz, s, h, n)
    if decode:
        y, new_state = ssd_recurrent_step(cache["state"], xh, dt, a, bh, ch)
    else:
        y, new_state = ssd_chunked(xh, dt, a, bh, ch, chunk=cfg.ssm_chunk)

    y = y + xh * p["d_skip"].to(y.dtype)[None, None, :, None]
    y = _gated_rmsnorm(y.reshape(bsz, s, d_in), z, p["norm"], cfg.norm_eps)
    out = y @ p["out"].to(y.dtype)
    if decode:
        return out, {"state": new_state, "conv_x": cache_x, "conv_b": cache_b,
                     "conv_c": cache_c}
    if collect:
        k = cfg.ssm_conv
        return out, {"state": new_state, **{name: t[:, -(k - 1):] for name, t in
                                            zip(("conv_x", "conv_b", "conv_c"), pre)}}
    return out, None


def mesh_mamba(m, pre: str, hs: list, caches: list | None, pos: int | None) -> list:
    """The Mamba-2 mixer ``pre`` of the meshed model ``m`` on each
    position's normed input ``hs`` (B / n_batch, S, d), replicated over
    ``model`` -> each position's output, psummed over ``model``.  Where the
    residual is sequence-sharded (``ctx.seq``) ``hs`` are the positions'
    slices, gathered over it before the input projections (the causal conv
    and the SSD need the whole sequence), and the ``out`` partials are
    reduce-scattered back onto the slices (each position keeps its slice
    of a replicated output where ``d_inner`` does not divide).

    ``in_z``, ``in_x`` and ``in_dt`` are column parallel, ``conv_x`` and
    ``norm`` hold the position's channels, ``out`` its rows (row parallel,
    the partials summed in mesh order); ``in_b``, ``in_c``, ``conv_b`` and
    ``conv_c`` are whole on every position (one group, ``N`` columns).
    Where the heads divide by the model extent each position runs the SSD
    on its ``H / tp`` heads.  Where only ``d_inner`` divides (the rules drop
    each mapping on its own) a position's channels are not whole heads: the
    convolved ``x`` is gathered over ``model``, every position runs every
    head (as GSPMD does), and each keeps its channels of the SSD's output.
    Where ``d_inner`` does not divide either, every position computes the
    whole mixer.  The gated norm's mean runs over the whole ``d_inner``: each
    position's float32 sum of squares, psummed over ``model``, over
    ``d_inner``.

    ``caches`` holds each position's cache of the layer (None: training):
    ``state`` of its heads (every head where they do not divide),
    ``conv_x`` of its channels, ``conv_b`` and ``conv_c`` whole, the layout
    of JAX's ``_cache_specs``; ``pos`` None is prefill (the caches
    replaced by the prompt's), an int a decode step.
    """
    cfg, ctx = m.cfg, m.ctx
    ax = ctx.model_axis
    d_in, h, _ = mamba_dims(cfg)
    n, hd, k = cfg.ssm_state, cfg.ssm_headdim, cfg.ssm_conv
    decode = caches is not None and pos is not None
    chans = ax is not None and m.spec(pre + "in_x")[1] == ax  # d_inner over model
    heads = ax is not None and m.spec(pre + "in_dt")[1] == ax  # the SSM heads over model
    ws = m.weights(pre[:-1])
    hs = ctx.gather_seq(hs)  # the conv and the SSD read the whole sequence
    proj = [{s: x @ p["in_" + s].to(x.dtype) for s in ("z", "x", "b", "c", "dt")}
            for x, p in zip(hs, ws)]
    conv, tails = [], []
    for i, (pr, p) in enumerate(zip(proj, ws)):
        out, tail = {}, {}
        for s in ("x", "b", "c"):
            y, tail["conv_" + s] = _causal_conv(pr[s], p["conv_" + s],
                                                caches[i]["conv_" + s] if decode else None)
            out[s] = F.silu(y)
        conv.append(out)
        tails.append(tail)
    xs = [c["x"] for c in conv]
    if chans and not heads:  # channels not whole heads: every head on every position
        xs = ctx.all_gather(xs, ax, -1)
    width = d_in // ctx.tp
    outs = []
    for i, (x, c, pr, p) in enumerate(zip(xs, conv, proj, ws)):
        bsz, s, _ = x.shape
        dt = F.softplus(pr["dt"].to(torch.float32) + p["dt_bias"].to(torch.float32))
        a = -torch.exp(p["a_log"].to(torch.float32))
        hl = x.shape[-1] // hd
        xh = x.reshape(bsz, s, hl, hd)
        bh = c["b"][:, :, None, :].expand(bsz, s, hl, n)
        ch = c["c"][:, :, None, :].expand(bsz, s, hl, n)
        if decode:
            y, state = ssd_recurrent_step(caches[i]["state"], xh, dt, a, bh, ch)
        else:
            y, state = ssd_chunked(xh, dt, a, bh, ch, chunk=cfg.ssm_chunk)
        y = (y + xh * p["d_skip"].to(y.dtype)[None, None, :, None]).reshape(bsz, s, hl * hd)
        if chans and not heads:  # keep this position's channels
            j = ctx.model_index[i]
            y = y[..., j * width:(j + 1) * width]
        outs.append((y, state))
        if caches is not None:
            caches[i].update(tails[i] if decode else
                             {"conv_" + s: pr[s][:, -(k - 1):] for s in ("x", "b", "c")})
            caches[i]["state"] = state
    gs = [y.to(torch.float32) * F.silu(pr["z"].to(torch.float32))
          for (y, _), pr in zip(outs, proj)]
    if chans:
        var = [t / d_in for t in ctx.psum([(g * g).sum(dim=-1, keepdim=True) for g in gs], ax)]
    else:
        var = [(g * g).mean(dim=-1, keepdim=True) for g in gs]
    partial = []
    for g, v, (y, _), p in zip(gs, var, outs, ws):
        normed = (g * torch.rsqrt(v + cfg.norm_eps)).to(y.dtype) * p["norm"].to(y.dtype)
        partial.append(normed @ p["out"].to(y.dtype))
    return ctx.reduce_partials(partial, ax) if chans else ctx.seq_slices(partial)
