"""Plain PyTorch versions of the kernels in this package.

Each function is the semantic ground truth its CUDA kernel is held against
(on the card by ``chip_smoke.py`` and the ``cuda``-marked tests) and what the
dispatcher in :mod:`repro_torch.kernels.ops` runs for a tensor on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.core import contingency as _contingency

_EPS = 1e-12


def contingency_tables(
    X: torch.Tensor, y: torch.Tensor, num_values: int, num_classes: int
) -> torch.Tensor:
    """(M, F) int, (M,) int -> (F, V, C) int32 contingency tables.

    Out-of-range entries (padding, negatives) contribute zero counts.
    """
    return _contingency.batched_counts(
        X, y, num_values, num_classes, block=max(1, min(64, X.shape[1]))
    )


def conditional_tables(
    X: torch.Tensor, xj: torch.Tensor, y: torch.Tensor, num_values: int,
    num_classes: int,
) -> torch.Tensor:
    """(M, F), (M,), (M,) -> (F, V, V, C) int32 class-conditioned pair tables."""
    return _contingency.conditional_counts(
        X, xj, y, num_values, num_values, num_classes,
        block=max(1, min(64, X.shape[1])),
    )


def mi_scores(counts: torch.Tensor) -> torch.Tensor:
    """(..., V, C) counts -> (...) float32 mutual information in nats.

    The total is clamped to at least 1 and zero cells add 0; the sums run
    over the class axis first, then over the value axis.
    """
    counts = counts.to(torch.float32)
    total = torch.clamp_min(counts.sum(dim=(-1, -2), keepdim=True), 1.0)
    p = counts / total
    px = p.sum(dim=-1, keepdim=True)  # (F, V, 1)
    py = p.sum(dim=-2, keepdim=True)  # (F, 1, C)
    ratio = p / torch.clamp_min(px * py, _EPS)
    terms = torch.where(
        p > 0, p * torch.log(torch.clamp_min(ratio, _EPS)), torch.zeros_like(p)
    )
    return terms.sum(dim=-1).sum(dim=-1)


def bin_codes(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """(B, N) floats x (N, E) sorted edges -> (B, N) int32 bin codes.

    ``code[b, n] = searchsorted(edges[n], X[b, n], side="right")``, the
    number of edges ``<= X[b, n]``; comparisons in float32 to match the
    host encoder (``QuantileBinner.transform``) and the kernel bit for bit.
    One batched ``torch.searchsorted`` over the feature-major transpose:
    no ``(B, N, E)`` compare tensor is ever built.
    """
    X = X.to(torch.float32)
    if X.numel() == 0 or edges.shape[-1] == 0:
        return torch.zeros(X.shape, dtype=torch.int32, device=X.device)
    e = edges.to(device=X.device, dtype=torch.float32).contiguous()
    codes = torch.searchsorted(e, X.T.contiguous(), right=True)  # (N, B)
    return codes.to(torch.int32).T.contiguous()


def standardize_rows(X: torch.Tensor) -> torch.Tensor:
    """Zero-mean unit-variance rows (two-pass: mean, then mean squared
    deviation); the standard deviation is clamped at 1e-12, so a constant
    row maps to all zeros."""
    X = X.to(torch.float32)
    mu = X.mean(dim=-1, keepdim=True)
    xc = X - mu
    sd = torch.sqrt((xc * xc).mean(dim=-1, keepdim=True))
    return xc / torch.clamp_min(sd, _EPS)


def pearson_corr(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """(F, M), (T, M) -> (F, T) float32 Pearson correlation of rows."""
    return standardize_rows(X) @ standardize_rows(Y).T / X.shape[-1]


def cor2mi(corr: torch.Tensor) -> torch.Tensor:
    """Gaussian MI approximation from correlation (paper Listing 8)."""
    r2 = torch.clamp(corr * corr, 0.0, 1.0 - 1e-6)
    return -0.5 * torch.log1p(-r2)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool
) -> torch.Tensor:
    """(B, S, H, D) x (B, T, KV, D) -> (B, S, H, D) GQA softmax attention.

    Query head ``h`` attends KV head ``h // (H / KV)``.  Scores, softmax and
    the product with V in float32, the output in q's dtype.  With ``causal``
    query ``i`` sees keys ``<= i + T - S`` (``tril(k=T-S)``); masked scores
    are ``-1e30``, so a row with no visible key averages V uniformly
    instead of producing NaN.
    """
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d).to(torch.float32) * (d ** -0.5)
    sc = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32))
    if causal:
        mask = torch.ones((s, t), dtype=torch.bool, device=q.device).tril(t - s)
        sc = sc.masked_fill(~mask, -1e30)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))
    return out.reshape(b, s, h, d).to(q.dtype)
