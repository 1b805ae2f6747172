"""Feature-score functions for mRMR — discrete mutual information and the
paper's Pearson-based approximation for continuous data.

A score function is an object with two batched primitives —

  * ``relevance(cands, cls)``   -> per-candidate f(x_k; c)
  * ``redundancy(cands, other)``-> per-candidate f(x_k; x_j) for ONE j

from which the engines assemble the mRMR objective through a criterion
(:mod:`repro_torch.core.criteria`).  Both take candidates in feature-major
layout ``(F, M)``, the alternative encoding's row-per-feature storage.

Every MI value here is finalized by the MI kernel
(:mod:`repro_torch.kernels.mi_score`) on a CUDA tensor and by its plain
version on the CPU; every contingency count by the contingency kernel; and
every in-memory Pearson correlation by the correlation kernel
(:mod:`repro_torch.kernels.pearson`).

:class:`CustomScore` is the paper's Listing-7 interface: a user
``get_result`` scores one candidate completely, vmapped over candidates
(a chunk of them one launch of each kernel it reaches), and the engines
recompute it at every pick.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Literal, Union

import torch

from repro_torch.core import contingency
from repro_torch.core.contingency import OOR
from repro_torch.kernels import ops
from repro_torch.kernels.ref import cor2mi, standardize_rows

_EPS = 1e-12


# ---------------------------------------------------------------------------
# Mutual information from contingency tables
# ---------------------------------------------------------------------------

def mi_from_counts(counts: torch.Tensor, use_kernel="auto") -> torch.Tensor:
    """Mutual information (nats) from contingency tables.

    Args:
      counts: (..., V, C) non-negative counts (int32 or float).
    Returns:
      (...,) float32 MI. Zero cells contribute zero (lim p->0 of p log p).
    """
    lead, (v, c) = counts.shape[:-2], counts.shape[-2:]
    if counts.dim() not in (3, 4):  # the kernel reads one or two leading axes in place
        counts = counts.reshape(-1, v, c)
    return ops.mi_scores(counts, use_kernel).reshape(lead)


def cmi_from_counts(counts: torch.Tensor, use_kernel="auto") -> torch.Tensor:
    """Conditional mutual information (nats) from 3-way count tables.

    ``I(x; w | y) = sum_c p(y=c) * I(x; w | y=c)``: per-class MI of each
    class slice, weighted by the empirical class mass.  Empty class slices
    contribute zero.

    Args:
      counts: (..., V, W, C) non-negative counts — the layout
        :func:`repro_torch.core.contingency.conditional_counts` produces.
    Returns:
      (...,) float32 conditional MI in nats.
    """
    # (..., C) per-class MI of the class-major view, which the kernel reads
    # in place.
    per_class = mi_from_counts(counts.movedim(-1, -3), use_kernel)
    cls_mass = counts.sum(dim=(-3, -2)).to(torch.float32)  # (..., C)
    total = torch.clamp_min(cls_mass.sum(dim=-1, keepdim=True), 1.0)
    return (per_class * cls_mass / total).sum(dim=-1)


def entropy_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """Shannon entropy (nats) of a histogram (..., K)."""
    counts = counts.to(torch.float32)
    total = torch.clamp_min(counts.sum(dim=-1, keepdim=True), 1.0)
    p = counts / total
    terms = torch.where(
        p > 0, p * torch.log(torch.clamp_min(p, _EPS)), torch.zeros_like(p)
    )
    return -terms.sum(dim=-1)


# ---------------------------------------------------------------------------
# Pearson correlation (batched, feature-major)
# ---------------------------------------------------------------------------

def pearson_rows(
    cands: torch.Tensor, other: torch.Tensor, use_kernel="auto"
) -> torch.Tensor:
    """Pearson correlation of each row of ``cands`` (F, M) with ``other``.

    ``other`` is (M,) or (T, M); result is (F,) or (F, T) float32.  Runs the
    correlation kernel on a CUDA tensor (``use_kernel``, as in
    :mod:`repro_torch.kernels.ops`).
    """
    squeeze = other.dim() == 1
    corr = ops.pearson_corr(cands, other[None] if squeeze else other, use_kernel)
    return corr[:, 0] if squeeze else corr


# ---------------------------------------------------------------------------
# Score-function objects
# ---------------------------------------------------------------------------

class ScoreFn:
    """Base interface.

    ``incremental_safe`` marks scores of the mRMR additive form, for which
    the engines may carry a running redundancy fold instead of recomputing
    it (the paper's baseline).  Scores computed from block-wise sufficient
    statistics set ``supports_streaming`` and implement ``init_state`` /
    ``accumulate`` / ``finalize`` — the paper's map+combine / reduce /
    score evaluation factored onto the score object.
    ``supports_conditional`` marks scores with a class-conditioned pair
    statistic (needed by JMI/CMIM and the other conditional criteria);
    ``supports_state_merge`` scores whose statistics merge across row
    partitions by plain addition.
    """

    incremental_safe: bool = True
    supports_streaming: bool = False
    supports_conditional: bool = False
    supports_state_merge: bool = False

    def relevance(self, cands: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def redundancy(self, cands: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def redundancy_terms(
        self, cands: torch.Tensor, other: torch.Tensor,
        cls: torch.Tensor | None = None, *, conditional: bool = False,
    ) -> dict:
        """``{"marginal": (F,), "conditional": (F,) | None}`` — the pairwise
        score of every candidate against ``other`` and, with
        ``conditional=True``, the same statistic conditioned on ``cls``."""
        if conditional:
            raise ValueError(
                f"{type(self).__name__} has no class-conditioned pair "
                "statistic (supports_conditional=False); conditional "
                "criteria like JMI/CMIM need MIScore"
            )
        return dict(marginal=self.redundancy(cands, other), conditional=None)

    def init_state(self, n_features: int, target_kind: str = "class"):
        raise NotImplementedError(
            f"{type(self).__name__} does not support streaming fits"
        )

    def accumulate(self, state, X_block, target, valid=None):
        raise NotImplementedError(
            f"{type(self).__name__} does not support streaming fits"
        )

    def finalize(self, state) -> torch.Tensor:
        raise NotImplementedError(
            f"{type(self).__name__} does not support streaming fits"
        )


@dataclasses.dataclass(frozen=True)
class MIScore(ScoreFn):
    """Exact discrete mutual information (the paper's mRMR score).

    ``num_values`` (``d_v``) / ``num_classes`` (``d_c``) follow the paper:
    the union of categorical values over all features, and over the class.
    Categories must live in ``[0, d)``: out-of-range values (including
    negatives) count nothing — the selector validates this and raises.
    ``use_kernel="auto"`` counts and finalizes through the CUDA kernels for
    tensors on the card and the plain versions for tensors on the CPU;
    ``True`` forces the kernels (a CPU tensor raises), ``False`` forces the
    plain versions (the blocked one-hot count, ``block`` features at a time).
    """

    num_values: int = 2
    num_classes: int = 2
    block: int = 64
    use_kernel: Union[bool, Literal["auto"]] = "auto"

    supports_streaming = True
    supports_conditional = True
    # int32 contingency counts over disjoint row partitions sum exactly.
    supports_state_merge = True

    def __post_init__(self):
        ops.check_use_kernel(self.use_kernel)

    def tables(self, X_cols: torch.Tensor, tgt: torch.Tensor, vy: int) -> torch.Tensor:
        """(M, F) column-layout int32 contingency tables against one target."""
        if self.use_kernel is False:
            return contingency.batched_counts(
                X_cols, tgt, self.num_values, vy, block=self.block
            )
        return ops.contingency_tables(
            X_cols, tgt, self.num_values, vy, use_kernel=self.use_kernel
        )

    def mi(self, counts: torch.Tensor) -> torch.Tensor:
        return mi_from_counts(counts, self.use_kernel)

    def terms_from_conditional(self, counts: torch.Tensor) -> dict:
        """(F, V, V, C) 3-way counts -> both redundancy terms: the marginal
        table is the class-sum, so one count yields both."""
        return dict(
            marginal=self.mi(counts.sum(dim=-1, dtype=torch.int32)),
            conditional=cmi_from_counts(counts, self.use_kernel),
        )

    def relevance(self, cands: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
        # Feature-major candidates -> (M, F) column view for the kernel
        # (a stride swap; the kernel reads either layout in place).
        return self.mi(self.tables(cands.T, cls, self.num_classes))

    def redundancy(self, cands: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
        return self.mi(self.tables(cands.T, other, self.num_values))

    def conditional_tables(
        self, X_cols: torch.Tensor, xj: torch.Tensor, cls: torch.Tensor
    ) -> torch.Tensor:
        """(M, F) columns -> (F, V, V, C) class-conditioned pair tables."""
        if self.use_kernel is False:
            return contingency.conditional_counts(
                X_cols, xj, cls, self.num_values, self.num_values,
                self.num_classes, block=self.block,
            )
        return ops.conditional_tables(
            X_cols, xj, cls, self.num_values, self.num_classes,
            use_kernel=self.use_kernel,
        )

    def redundancy_conditional(
        self, cands: torch.Tensor, other: torch.Tensor, cls: torch.Tensor
    ) -> torch.Tensor:
        """Per-candidate ``I(x_k; other | cls)`` (feature-major cands)."""
        return cmi_from_counts(self.conditional_tables(cands.T, other, cls), self.use_kernel)

    def redundancy_terms(
        self, cands: torch.Tensor, other: torch.Tensor,
        cls: torch.Tensor | None = None, *, conditional: bool = False,
    ) -> dict:
        if not conditional:
            return dict(marginal=self.redundancy(cands, other), conditional=None)
        return self.terms_from_conditional(
            self.conditional_tables(cands.T, other, cls)
        )

    # -- streaming: per-pair contingency tables, summed block-by-block ----

    def init_state(self, n_features: int, target_kind: str = "class") -> torch.Tensor:
        # int32 running counts, exact to ~2.1B observations per cell.
        # "feature_cond" carries the class axis fused into the target slot;
        # finalize_conditional unflattens it.
        vy = {
            "class": self.num_classes,
            "feature": self.num_values,
            "feature_cond": self.num_values * self.num_classes,
        }[target_kind]
        return torch.zeros((n_features, self.num_values, vy), dtype=torch.int32)

    def accumulate(
        self, state: torch.Tensor, X_block: torch.Tensor, target: torch.Tensor,
        valid=None,
    ) -> torch.Tensor:
        """Add one block's counts to ``state`` IN PLACE (and return it)."""
        tgt = target.to(torch.int32)
        if valid is not None:
            # An out-of-range target counts nothing, so padded rows vanish
            # from the tables without touching X.
            tgt = torch.where(valid, tgt, torch.full_like(tgt, OOR))
        state += self.tables(X_block, tgt, state.shape[-1])
        return state

    def finalize(self, state: torch.Tensor) -> torch.Tensor:
        return self.mi(state)

    def finalize_conditional(self, state: torch.Tensor) -> dict:
        """Reduce a ``"feature_cond"`` state to both redundancy terms."""
        n, v, vc = state.shape
        counts = state.reshape(n, v, vc // self.num_classes, self.num_classes)
        return self.terms_from_conditional(counts)


@dataclasses.dataclass(frozen=True)
class PearsonMIScore(ScoreFn):
    """Listing-8 score: MI approximated via Pearson correlation.

    Works for continuous data (alternative encoding only, as in the paper).
    In memory, every relevance and redundancy vector is one call of the
    correlation kernel (``use_kernel`` as for :class:`MIScore`).  Streams as
    running moments — sum, sum-of-squares and cross-products — so one
    block-wise pass recovers the exact full-dataset correlation.
    """

    use_kernel: Union[bool, Literal["auto"]] = "auto"

    supports_streaming = True

    def __post_init__(self):
        ops.check_use_kernel(self.use_kernel)

    def feature_rows(self, X_rows: torch.Tensor) -> torch.Tensor:
        """One feature-major float32 copy of ``X_rows`` (N, M) per fit.

        The correlation kernel reads rows contiguous along M; the
        alternative engine hands a transposed view, which would otherwise
        be copied on every call.  A contiguous float32 input is returned
        as is.
        """
        if X_rows.dtype == torch.float32 and X_rows.is_contiguous():
            return X_rows
        out = torch.empty(X_rows.shape, dtype=torch.float32, device=X_rows.device)
        return out.copy_(X_rows)

    def relevance(self, cands: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
        return cor2mi(pearson_rows(cands, cls.to(torch.float32), self.use_kernel))

    def redundancy(self, cands: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
        return cor2mi(pearson_rows(cands, other.to(torch.float32), self.use_kernel))

    # -- streaming: running moments -------------------------------------

    def init_state(self, n_features: int, target_kind: str = "class") -> dict:
        z = torch.zeros((n_features,), dtype=torch.float32)
        s = torch.zeros((), dtype=torch.float32)
        # mu_x / mu_t: per-column shifts frozen from the first block.  The
        # moments are accumulated on SHIFTED data — cov/var are
        # shift-invariant, but naive uncentered f32 sums cancel
        # catastrophically when |mean| >> std (sxx ~ n·mu² swamps the
        # signal), so the shift keeps the sums near the origin.
        return dict(n=s, mu_x=z, mu_t=s.clone(), sx=z.clone(), sxx=z.clone(),
                    sxt=z.clone(), st=s.clone(), stt=s.clone())

    def accumulate(
        self, state: dict, X_block: torch.Tensor, target: torch.Tensor,
        valid=None,
    ) -> dict:
        """One block's moments added to ``state``; returns a new dict."""
        X = X_block.to(torch.float32)
        t = target.to(torch.float32)
        if valid is not None:
            w = valid.to(torch.float32)
            n = w.sum()
        else:
            w = torch.ones((X.shape[0],), dtype=torch.float32, device=X.device)
            n = torch.tensor(float(X.shape[0]), dtype=torch.float32, device=X.device)
        denom = torch.clamp_min(n, 1.0)
        first = state["n"] == 0
        mu_x = torch.where(first, (X * w[:, None]).sum(dim=0) / denom, state["mu_x"])
        mu_t = torch.where(first, (t * w).sum() / denom, state["mu_t"])
        # Shift, then zero padded rows: they drop out of every sum and only
        # n carries the true observation count.
        Xs = (X - mu_x) * w[:, None]
        ts = (t - mu_t) * w
        return dict(
            n=state["n"] + n,
            mu_x=mu_x,
            mu_t=mu_t,
            sx=state["sx"] + Xs.sum(dim=0),
            sxx=state["sxx"] + (Xs * Xs).sum(dim=0),
            sxt=state["sxt"] + (Xs * ts[:, None]).sum(dim=0),
            st=state["st"] + ts.sum(),
            stt=state["stt"] + (ts * ts).sum(),
        )

    def finalize(self, state: dict) -> torch.Tensor:
        n = torch.clamp_min(state["n"], 1.0)
        cov = state["sxt"] - state["sx"] * state["st"] / n
        var_x = state["sxx"] - state["sx"] * state["sx"] / n
        var_t = state["stt"] - state["st"] * state["st"] / n
        corr = cov / torch.sqrt(torch.clamp_min(var_x * var_t, _EPS))
        return cor2mi(torch.clamp(corr, -1.0, 1.0))


# Candidates a vmapped ``get_result`` call scores at once are chosen so that
# a chunk holds about this many elements of the (candidates, selected rows,
# observations) product: a vmapped redundancy count fuses each candidate's
# values with the selected rows into a tensor of that size, never one for
# all candidates.
_CUSTOM_CHUNK_ELEMS = 1 << 24


@dataclasses.dataclass(frozen=True)
class CustomScore(ScoreFn):
    """Adapter for the paper's Listing-7 ``getResult`` interface.

    ``get_result(variable (M,), class (M,), selected (L, M), n_selected)``
    must return the *complete* feature score for one candidate (``selected``
    float32, its first ``n_selected`` rows filled; ``n_selected`` a 0-d
    int32 tensor).  An arbitrary user score need not decompose into
    relevance and redundancy, so this takes the paper's recompute-every-pick
    path on the reference and alternative engines, and it cannot stream.

    As in the JAX package (which ``vmap``s it), ``get_result`` is written
    for one candidate and mapped over all of them: here with
    ``torch.func.vmap``, a chunk of candidates per call (about
    ``_CUSTOM_CHUNK_ELEMS`` elements of candidates x rows x observations),
    so it must be built from vmappable torch operations (no ``.item()``, no
    data-dependent shapes).  The scores' ``relevance`` / ``redundancy`` are:
    their contingency, MI and correlation calls batch a chunk into one
    kernel launch (:mod:`repro_torch.kernels.ops`).
    """

    get_result: Callable

    incremental_safe = False

    def __post_init__(self):
        # Fail here, not as an opaque TypeError inside the vmapped call.
        if not callable(self.get_result):
            raise TypeError(
                "CustomScore requires a callable get_result(variable, cls, "
                f"selected, n_selected); got {self.get_result!r}"
            )

    def full_score(
        self, cands: torch.Tensor, cls: torch.Tensor, selected: torch.Tensor,
        n_selected,
    ) -> torch.Tensor:
        """(F, M), (M,), (L, M), () -> (F,) float32 full scores."""
        f, m = cands.shape
        n_sel = torch.as_tensor(n_selected, dtype=torch.int32, device=cands.device)
        per_cand = max(1, m * (selected.shape[0] + 1))
        chunk = max(1, _CUSTOM_CHUNK_ELEMS // per_cand)
        fn = torch.func.vmap(self.get_result, in_dims=(0, None, None, None))
        return torch.cat([
            fn(cands[i:i + chunk], cls, selected, n_sel).to(torch.float32)
            for i in range(0, f, chunk)
        ])


def mrmr_custom_score(score: ScoreFn) -> CustomScore:
    """Express a relevance/redundancy score through the Listing-7 interface
    (used to validate the custom path against the built-in path)."""

    def get_result(v, cls, selected, n_selected):
        rel = score.relevance(v[None], cls)[0]
        red = score.redundancy(selected, v)  # (L,) scores vs each selected row
        mask = torch.arange(selected.shape[0], device=selected.device) < n_selected
        red_sum = torch.where(mask, red, 0.0).sum()
        return rel - red_sum / torch.clamp_min(n_selected, 1).to(torch.float32)

    return CustomScore(get_result=get_result)


__all__ = [
    "CustomScore",
    "MIScore",
    "PearsonMIScore",
    "ScoreFn",
    "cmi_from_counts",
    "cor2mi",
    "entropy_from_counts",
    "mi_from_counts",
    "mrmr_custom_score",
    "pearson_rows",
    "standardize_rows",
]
