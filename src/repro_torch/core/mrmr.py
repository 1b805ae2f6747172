"""mRMR greedy engines on one device — the reference and the paper's two
encodings.

The paper distributes mRMR two ways, keyed by data layout (Section III/IV):

* **conventional** — rows are observations.  Scoring = contingency tables
  of every feature against one target column (the mapper/combiner/reducer
  collapsed into one count).  Discrete data, MI score only.
* **alternative** — rows are features.  The class vector and the selected
  features are broadcast; scoring is local to each feature row.

Both run here unsharded on one device, as a host loop over the greedy
picks with the selected set kept as a mask.  ``incremental=True`` carries
the criterion's running fold state (each pick scores candidates against
only the newly selected feature — O(N·L) pair scores);
``incremental=False`` is the paper-faithful recomputation (O(N·L²)); a
:class:`~repro_torch.core.scores.CustomScore` always recomputes, on the
reference and alternative engines, and reports a NaN relevance.  The
incremental loop skips the fold after the last pick, whose result no pick
would read, so a fit of L features counts L contingency passes
(1 relevance + L-1 redundancy).

Argmax ties go to the lowest feature id (``torch.argmax`` returns the
first maximum), and selected features are masked with ``-inf``.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import torch

from repro_torch.core import contingency
from repro_torch.core.criteria import Criterion, resolve_criterion
from repro_torch.core.scores import CustomScore, MIScore, ScoreFn

_NEG_INF = float("-inf")


@dataclasses.dataclass
class MRMRResult:
    """Selection report: order, objective trajectory, relevance, provenance.

    ``selected[l]`` (int32) is the feature picked at iteration ``l`` and
    ``gains[l]`` (float32) the criterion objective it was picked at.
    ``relevance`` (float32) is the per-feature relevance vector from the
    fit's first scoring pass.  ``criterion`` and ``engine`` name what
    produced the result; ``io`` is the streaming engine's I/O ledger
    (``None`` for in-memory engines).  The JSON form is the JAX package's
    (``repro.core.mrmr.MRMRResult``): either reads the other's.
    """

    selected: torch.Tensor
    gains: torch.Tensor
    relevance: torch.Tensor | None = None
    criterion: str = ""
    engine: str = ""
    io: dict | None = None

    def to_json(self) -> str:
        """Serialise to a strict-JSON string; non-finite floats are encoded
        as the strings "nan"/"inf"/"-inf"."""

        def enc(a):
            if a is None:
                return None
            if isinstance(a, torch.Tensor):
                a = a.detach().cpu().numpy()
            x = np.asarray(a)
            if np.issubdtype(x.dtype, np.floating):
                return [
                    float(v) if math.isfinite(v) else repr(float(v))
                    for v in x.tolist()
                ]
            return x.tolist()

        return json.dumps(
            dict(
                version=1,
                selected=enc(self.selected),
                gains=enc(self.gains),
                relevance=enc(self.relevance),
                criterion=self.criterion,
                engine=self.engine,
                io=self.io,
            )
        )

    @classmethod
    def from_json(cls, payload: str) -> "MRMRResult":
        """Rebuild a result serialised by :meth:`to_json` (CPU tensors)."""
        d = json.loads(payload)

        def dec(vals, dtype):
            if vals is None:
                return None
            return torch.tensor(
                [float(v) if isinstance(v, str) else v for v in vals],
                dtype=dtype,
            )

        return cls(
            selected=dec(d["selected"], torch.int32),
            gains=dec(d["gains"], torch.float32),
            relevance=dec(d.get("relevance"), torch.float32),
            criterion=d.get("criterion", ""),
            engine=d.get("engine", ""),
            io=d.get("io"),
        )


def check_conditional_support(score: ScoreFn, crit: Criterion) -> None:
    """Conditional criteria (JMI/CMIM/...) need a score whose pair
    statistic decomposes per class; fail before any counting."""
    if crit.needs_conditional_redundancy and not getattr(
        score, "supports_conditional", False
    ):
        raise ValueError(
            f"criterion {crit.name!r} needs class-conditioned pair "
            f"statistics I(x_k; x_j | y), but {type(score).__name__} has "
            "no conditional decomposition; score with MIScore"
        )


def _check_custom_criterion(score: ScoreFn, crit: Criterion) -> None:
    """A CustomScore computes the complete objective itself (Listing 7), so
    it bypasses the criterion fold; any other criterion than the default
    would be silently ignored — fail instead."""
    if isinstance(score, CustomScore) and crit.name != "mid":
        raise ValueError(
            f"criterion {crit.name!r} cannot be combined with CustomScore: "
            "a custom get_result computes the complete objective itself "
            "(paper Listing 7); use the default 'mid' criterion"
        )


def _custom_greedy(X_rows, y, num_select, score: CustomScore):
    """The paper's recompute loop for a CustomScore: every pick scores all
    candidates with ``full_score`` against the class and the float32 rows
    of the features picked so far.  Returns ``(selected, gains, relevance)``
    with a NaN relevance (a custom score has no relevance/redundancy
    split)."""
    n, m = X_rows.shape
    dev = X_rows.device
    sel_rows = torch.zeros((num_select, m), dtype=torch.float32, device=dev)
    mask = torch.zeros((n,), dtype=torch.bool, device=dev)
    gains = torch.zeros((num_select,), dtype=torch.float32, device=dev)
    selected: list = []
    for l in range(num_select):
        g = score.full_score(X_rows, y, sel_rows, l)
        g = torch.where(mask, _NEG_INF, g)
        k = int(torch.argmax(g))
        mask[k] = True
        gains[l] = g[k]
        selected.append(k)
        sel_rows[l] = X_rows[k].to(torch.float32)
    rel = torch.full((n,), float("nan"), dtype=torch.float32, device=dev)
    return torch.tensor(selected, dtype=torch.int32, device=dev), gains, rel


def _greedy(rel, num_select, crit: Criterion, incremental: bool, terms_of):
    """The greedy loop every in-memory engine shares.

    ``terms_of(k)`` -> the criterion's redundancy terms of every candidate
    against feature ``k``.  Returns ``(selected int32, gains float32)`` on
    the relevance vector's device.
    """
    n, dev = rel.shape[0], rel.device
    mask = torch.zeros((n,), dtype=torch.bool, device=dev)
    gains = torch.zeros((num_select,), dtype=torch.float32, device=dev)
    selected: list = []
    fold = crit.needs_redundancy
    state = crit.init_state(n, dev) if incremental and fold else None
    for l in range(num_select):
        if not fold:
            g = crit.objective(rel, crit.init_state(n, dev), l)
        elif incremental:
            g = crit.objective(rel, state, l)
        else:
            cs = crit.init_state(n, dev)
            for j, kj in enumerate(selected):
                cs = crit.update(cs, terms_of(kj), j)
            g = crit.objective(rel, cs, l)
        g = torch.where(mask, _NEG_INF, g)
        k = int(torch.argmax(g))
        mask[k] = True
        gains[l] = g[k]
        selected.append(k)
        if incremental and fold and l + 1 < num_select:
            state = crit.update(state, terms_of(k), l)
    return torch.tensor(selected, dtype=torch.int32, device=dev), gains


def _feature_major(X_rows, y, num_select, score, crit, incremental):
    _check_custom_criterion(score, crit)
    check_conditional_support(score, crit)
    if isinstance(score, CustomScore):
        return _custom_greedy(X_rows, y, num_select, score)
    cond = crit.needs_redundancy and crit.needs_conditional_redundancy

    def terms_of(k):
        return score.redundancy_terms(X_rows, X_rows[k], y, conditional=cond)

    rel = score.relevance(X_rows, y)
    sel, gains = _greedy(rel, num_select, crit, incremental, terms_of)
    return sel, gains, rel.to(torch.float32)


# ---------------------------------------------------------------------------
# single-device reference engine (feature-major)
# ---------------------------------------------------------------------------

def mrmr_reference(
    X_rows: torch.Tensor,
    y: torch.Tensor,
    num_select: int,
    score: ScoreFn,
    *,
    incremental: bool = True,
    criterion: Criterion | str = "mid",
) -> MRMRResult:
    """mRMR on one device. ``X_rows`` is feature-major (N, M)."""
    crit = resolve_criterion(criterion)
    sel, gains, rel = _feature_major(X_rows, y, num_select, score, crit, incremental)
    return MRMRResult(sel, gains, relevance=rel, criterion=crit.name,
                      engine="reference")


# ---------------------------------------------------------------------------
# conventional encoding: observations as rows, contingency counts
# ---------------------------------------------------------------------------

def mrmr_conventional(
    X: torch.Tensor,  # (M, N) conventional layout
    y: torch.Tensor,  # (M,)
    num_select: int,
    score: MIScore,
    *,
    incremental: bool = True,
    criterion: Criterion | str = "mid",
) -> MRMRResult:
    """The paper's conventional-encoding job on one device.

    Every scoring pass is one contingency count of all N features against
    one target column — the contingency kernel on the card (exact int32,
    no one-hot), the blocked one-hot count with ``use_kernel=False``.
    """
    if not isinstance(score, MIScore):
        raise ValueError(
            "conventional encoding works with discrete MI only (paper §IV.B); "
            "use the alternative encoding for other scores"
        )
    crit = resolve_criterion(criterion)
    v, c = score.num_values, score.num_classes
    n = X.shape[1]

    def terms_of(k):
        tgt = X[:, k]
        if not crit.needs_conditional_redundancy:
            return dict(marginal=score.mi(score.tables(X, tgt, v)), conditional=None)
        fused = contingency.fuse_targets(tgt, y, v, c)
        cnt = score.tables(X, fused, v * c).reshape(n, v, v, c)
        return score.terms_from_conditional(cnt)

    rel = score.mi(score.tables(X, y, c))
    sel, gains = _greedy(rel, num_select, crit, incremental, terms_of)
    return MRMRResult(sel, gains, relevance=rel, criterion=crit.name,
                      engine="conventional")


# ---------------------------------------------------------------------------
# alternative encoding: features as rows, any score
# ---------------------------------------------------------------------------

def mrmr_alternative(
    X_rows: torch.Tensor,  # (N, M) alternative layout (rows = features)
    y: torch.Tensor,
    num_select: int,
    score: ScoreFn,
    *,
    incremental: bool = True,
    criterion: Criterion | str = "mid",
) -> MRMRResult:
    """The paper's alternative-encoding job: row-per-feature scoring
    against the broadcast class and selected rows.  ``X_rows`` may be a
    transposed view of a conventional matrix: the kernel reads it in
    place."""
    crit = resolve_criterion(criterion)
    sel, gains, rel = _feature_major(X_rows, y, num_select, score, crit, incremental)
    return MRMRResult(sel, gains, relevance=rel, criterion=crit.name,
                      engine="alternative")


__all__ = [
    "MRMRResult",
    "check_conditional_support",
    "mrmr_alternative",
    "mrmr_conventional",
    "mrmr_reference",
]
