"""Dispatch between the CUDA kernels and their plain versions.

``use_kernel`` decides on the device of the tensor it is given:

  * ``"auto"`` — a CUDA tensor runs the kernel, a CPU tensor the plain
    PyTorch version.
  * ``True``  — the kernel; a CPU tensor raises (there is no interpreter
    for a CUDA kernel).
  * ``False`` — the plain version, wherever the tensor lies.

A CUDA tensor never falls back to the plain version under ``"auto"``: a
kernel that fails to build or launch raises.

A ``meta`` tensor (the dry run, :mod:`repro_torch.launch.dryrun`) takes the
kernel's branch under ``"auto"``: each wrapper gives a shape-only result and
charges the kernel's operations and bytes to the open cost counter
(:mod:`repro_torch.analysis.op_analysis`), as it charges them at each launch
on the card; ``True`` raises there as on the CPU.  A wrapper runs in a
``kernel_region``, so its own tensor operations are the kernel's and are
not counted as ops.

The contingency, MI and correlation calls go through custom operators
(``torch.ops.repro_torch.*``) that run the kernel on a CUDA tensor and the
plain version on a CPU tensor, and carry a ``torch.func.vmap`` rule: a
batch of candidates folds into the kernel's feature (or table) axis, so a
vmapped call is one launch, not one per candidate.  This is what lets a
:class:`~repro_torch.core.scores.CustomScore` built from the scores'
``relevance`` / ``redundancy`` reach the kernels.
"""

from __future__ import annotations

import torch

from repro_torch.analysis.op_analysis import kernel_region
from repro_torch.kernels import ref
from repro_torch.kernels.binning import bin_codes_cuda
from repro_torch.kernels.contingency import (
    conditional_tables_cuda,
    contingency_tables_cuda,
)
from repro_torch.kernels.flash_attention import check_no_grad, flash_attention_cuda
from repro_torch.kernels.mi_score import mi_scores_cuda
from repro_torch.kernels.pearson import pearson_corr_cuda


def check_use_kernel(use_kernel) -> None:
    if use_kernel is not True and use_kernel is not False and use_kernel != "auto":
        raise ValueError(
            f"use_kernel must be True, False or 'auto'; got {use_kernel!r}"
        )


def _forced_plain(use_kernel, t: torch.Tensor) -> bool:
    """-> whether the call is forced to the plain version; raises for
    ``use_kernel=True`` on a CPU tensor."""
    check_use_kernel(use_kernel)
    if use_kernel is True and not t.is_cuda:
        raise ValueError(
            f"use_kernel=True needs a CUDA tensor; got one on {t.device}"
        )
    return use_kernel is False


def _decide(use_kernel, t: torch.Tensor) -> bool:
    """-> whether to run the kernel (its ``meta`` branch on a meta tensor)."""
    return not _forced_plain(use_kernel, t) and (t.is_cuda or t.is_meta)


# -- custom operators with a vmap rule --------------------------------------

@torch.library.custom_op(
    "repro_torch::contingency_tables", mutates_args=(),
    schema="(Tensor X, Tensor y, int num_values, int num_classes) -> Tensor",
)
def _contingency_op(X, y, num_values, num_classes):
    if X.is_meta:
        return contingency_tables_cuda(X, y, num_values, num_classes)
    if not X.is_cuda:
        return ref.contingency_tables(X, y, num_values, num_classes)
    # The kernel reads integer codes.  Float values and targets (a custom
    # score's float32 class and selected rows) become int32 codes, -1 where
    # the plain version's equality test would count nothing.
    if X.dtype.is_floating_point:
        X = _int_codes(X, num_values)
    if y.dtype.is_floating_point:
        y = _int_codes(y, num_classes)
    return contingency_tables_cuda(X, y, num_values, num_classes)


def _int_codes(t: torch.Tensor, n: int) -> torch.Tensor:
    ok, v = _codes(t, n)
    return torch.where(ok, v, -1)


def _codes(t: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (in [0, n), the values as integers).  Compared before any cast, so
    a wide value cannot wrap into range; a float counts only if integral,
    as the plain version's equality test counts it."""
    if t.dtype.is_floating_point:
        ok = (t >= 0) & (t < n) & (t == t.trunc())
        return ok, torch.where(ok, t, 0).to(torch.int32)
    wide = torch.int64 if t.dtype == torch.int64 else torch.int32
    t = t.to(wide)
    return (t >= 0) & (t < n), t


@_contingency_op.register_vmap
def _contingency_vmap(info, in_dims, X, y, num_values, num_classes):
    """Batched X (candidates as feature columns) against one y: the batch
    folds into the feature axis, a view of X where its layout allows.
    Batched y: the value and target fuse into one code ``x * C + t`` (-1 out
    of range) counted against a single class, ``V * C`` values a column.
    Either way one launch for the whole batch."""
    xd, yd = in_dims[0], in_dims[1]
    B = info.batch_size
    if yd is None:
        x = X.movedim(xd, 1)  # (M, B, F)
        out = _contingency_op(x.flatten(1), y, num_values, num_classes)
        return out.unflatten(0, (B, x.shape[2])), 0
    x = X.movedim(xd, 1) if xd is not None else X.unsqueeze(1).expand(-1, B, -1)
    okx, xv = _codes(x, num_values)
    okt, tv = _codes(y.movedim(yd, 1).unsqueeze(-1), num_classes)  # (M, B, 1)
    code = torch.where(okx & okt, xv * num_classes + tv, -1).to(torch.int32)
    m, f = x.shape[0], x.shape[2]
    zero = torch.zeros((m,), dtype=torch.int32, device=x.device)
    out = _contingency_op(code.flatten(1), zero, num_values * num_classes, 1)
    return out.reshape(B, f, num_values, num_classes), 0


@torch.library.custom_op(
    "repro_torch::mi_scores", mutates_args=(), schema="(Tensor counts) -> Tensor",
)
def _mi_op(counts):
    if counts.is_cuda or counts.is_meta:
        return mi_scores_cuda(counts)
    return ref.mi_scores(counts)


@_mi_op.register_vmap
def _mi_vmap(info, in_dims, counts):
    """The batch becomes the leading table axis: (B, F, V, C) is read in
    place; deeper stacks flatten to (A, B, V, C) first."""
    x = counts.movedim(in_dims[0], 0)
    lead = x.shape[:-2]
    if x.dim() > 4:
        x = x.flatten(0, x.dim() - 4)
    return _mi_op(x).reshape(lead), 0


@torch.library.custom_op(
    "repro_torch::pearson_corr", mutates_args=(), schema="(Tensor X, Tensor Y) -> Tensor",
)
def _pearson_op(X, Y):
    if X.is_cuda or X.is_meta:
        return pearson_corr_cuda(X, Y)
    return ref.pearson_corr(X, Y)


@_pearson_op.register_vmap
def _pearson_vmap(info, in_dims, X, Y):
    """A batched side folds into its row axis (one launch); both sides
    batched (no built-in score does that) take one launch per element."""
    xd, yd = in_dims
    B = info.batch_size
    if yd is None:
        x = X.movedim(xd, 0)
        return _pearson_op(x.flatten(0, 1), Y).unflatten(0, (B, x.shape[1])), 0
    if xd is None:
        y = Y.movedim(yd, 0)
        return _pearson_op(X, y.flatten(0, 1)).unflatten(1, (B, y.shape[1])), 1
    return torch.stack([_pearson_op(X.select(xd, i), Y.select(yd, i)) for i in range(B)]), 0


def contingency_tables(
    X: torch.Tensor, y: torch.Tensor, num_values: int, num_classes: int,
    use_kernel="auto",
) -> torch.Tensor:
    """(M, F), (M,) -> (F, V, C) int32 contingency tables."""
    if _forced_plain(use_kernel, X):
        return ref.contingency_tables(X, y, num_values, num_classes)
    return _contingency_op(X, y, num_values, num_classes)


def conditional_tables(
    X: torch.Tensor, xj: torch.Tensor, y: torch.Tensor, num_values: int,
    num_classes: int, use_kernel="auto",
) -> torch.Tensor:
    """(M, F), (M,), (M,) -> (F, V, V, C) int32 class-conditioned tables."""
    if _decide(use_kernel, X):
        with kernel_region():
            return conditional_tables_cuda(X, xj, y, num_values, num_classes)
    return ref.conditional_tables(X, xj, y, num_values, num_classes)


def mi_scores(counts: torch.Tensor, use_kernel="auto") -> torch.Tensor:
    """(F, V, C) or (A, B, V, C) counts -> (F,) or (A, B) float32 MI (nats)."""
    if _forced_plain(use_kernel, counts):
        return ref.mi_scores(counts)
    return _mi_op(counts)


def mi_tables(X: torch.Tensor, y: torch.Tensor, num_values: int, num_classes: int,
              use_kernel="auto") -> torch.Tensor:
    """Fused convenience: (M, F), (M,) -> (F,) MI of every column against
    ``y`` (nats), the counts then the MI through the dispatcher."""
    counts = contingency_tables(X, y, num_values, num_classes, use_kernel)
    return mi_scores(counts, use_kernel)


def bin_codes(X: torch.Tensor, edges: torch.Tensor, use_kernel="auto") -> torch.Tensor:
    """(B, N) floats x (N, E) sorted edges -> (B, N) int32 bin codes."""
    if _decide(use_kernel, X):
        with kernel_region():
            return bin_codes_cuda(X, edges)
    return ref.bin_codes(X, edges)


def pearson_corr(X: torch.Tensor, Y: torch.Tensor, use_kernel="auto") -> torch.Tensor:
    """(F, M), (T, M) -> (F, T) float32 row correlations."""
    if _forced_plain(use_kernel, X):
        return ref.pearson_corr(X, Y)
    return _pearson_op(X, Y)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
    use_kernel="auto",
) -> torch.Tensor:
    """(B, S, H, D) x (B, T, KV, D) -> (B, S, H, D) GQA softmax attention.
    Forward only: raises when grad mode is on and an input requires a
    gradient, on every device (the plain version stands in for the kernel)."""
    check_no_grad(q, k, v)
    if _decide(use_kernel, q):
        with kernel_region():
            return flash_attention_cuda(q, k, v, causal=causal)
    return ref.flash_attention(q, k, v, causal=causal)
