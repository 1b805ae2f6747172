"""Composable greedy selection criteria — the fold the engines share.

The paper implements one greedy objective, the mRMR difference form
(Eq. 1): relevance minus mean pairwise redundancy.  The family of greedy
information-theoretic criteria (MID, MIQ, max-relevance, JMI, CMIM, MIFS,
CIFE, ICAP) shares the same relevance/redundancy statistics and differs
only in how the per-candidate redundancy terms fold into an objective.  A
:class:`Criterion` captures that fold as three float32 tensor hooks:

  * ``init_state(n, device)`` — zeroed per-candidate fold state for ``n``
    candidates: a dict of ``(n,)`` tensors (or empty).
  * ``update(state, terms, l)`` — fold the redundancy terms of the ``l``-th
    selected feature (0-based).  ``terms`` is ``{"marginal": (n,),
    "conditional": (n,) | None}`` (what
    :meth:`repro_torch.core.scores.ScoreFn.redundancy_terms` returns); use
    :func:`marginal_terms` / :func:`conditional_terms` to unpack.
  * ``objective(rel, state, l)`` — ``(n,)`` objective given the relevance
    vector and a state holding ``l`` folded selections (``l`` a Python int).

``needs_redundancy = False`` (max-relevance) lets engines skip redundancy
scoring entirely — the streaming engine then runs ONE pass over the source.
``needs_conditional_redundancy = True`` (JMI, CMIM, CIFE, ICAP) makes every
engine count class-conditioned pair tables alongside the marginal ones.

Register your own with :func:`register_criterion`::

    @register_criterion
    @dataclasses.dataclass(frozen=True)
    class PenalisedMID(Criterion):
        name = "mid2x"
        def init_state(self, n, device=None):
            return dict(red_sum=torch.zeros(n, device=device))
        def update(self, state, terms, l):
            return dict(red_sum=state["red_sum"] + marginal_terms(terms))
        def objective(self, rel, state, l):
            return rel - 2.0 * state["red_sum"] / float(max(l, 1))
"""

from __future__ import annotations

import dataclasses

import torch

# Quotient-form floor, in nats: mean redundancy below this counts as "no
# redundancy" and the candidate ranks by pure relevance (rel / eps).  It
# makes the first pick a relevance argmax and keeps float32 rounding noise
# (~1e-7 nats) from ranking near-independent candidates.
_QUOTIENT_EPS = 1e-4


def marginal_terms(terms) -> torch.Tensor:
    """The ``(n,)`` marginal redundancy vector from a terms dict (or a bare
    tensor, for hand-rolled folds)."""
    if isinstance(terms, dict):
        return terms["marginal"]
    return terms


def conditional_terms(terms) -> torch.Tensor:
    """The ``(n,)`` class-conditioned redundancy vector from a terms dict.

    Only present when the criterion declares
    ``needs_conditional_redundancy = True``; anything else fails loudly.
    """
    if isinstance(terms, dict) and terms.get("conditional") is not None:
        return terms["conditional"]
    raise ValueError(
        "redundancy terms carry no conditional component; a criterion "
        "reading conditional_terms(...) must declare "
        "needs_conditional_redundancy = True so the engines compute "
        "class-conditioned pair statistics"
    )


def _zeros(n: int, device) -> torch.Tensor:
    return torch.zeros((n,), dtype=torch.float32, device=device)


def _mean_denom(l) -> float:
    return float(max(int(l), 1))


class Criterion:
    """A greedy selection objective as a float32 tensor fold.

    Subclasses set ``name`` (the registry key, reported in
    ``MRMRResult.criterion``) and implement the three hooks.
    """

    name: str = ""
    needs_redundancy: bool = True
    needs_conditional_redundancy: bool = False

    def init_state(self, n: int, device=None):
        """Zeroed fold state for ``n`` candidate features."""
        raise NotImplementedError

    def update(self, state, terms, l):
        """Fold selection ``l``'s redundancy ``terms`` (0-based)."""
        raise NotImplementedError

    def objective(self, rel: torch.Tensor, state, l) -> torch.Tensor:
        """``(n,)`` objective after ``l`` selections have been folded."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_CRITERIA: dict = {}


def register_criterion(criterion, name: str | None = None):
    """Register a :class:`Criterion` under its ``name`` (or ``name=``).

    Accepts an instance or a zero-arg class (usable as a class decorator);
    returns its argument unchanged.  Later registrations of a name win.
    """
    crit = criterion() if isinstance(criterion, type) else criterion
    key = name or crit.name
    if not key:
        raise ValueError("criterion has no name; set .name or pass name=")
    if crit.name != key:
        object.__setattr__(crit, "name", key)
    _CRITERIA[key] = crit
    return criterion


def resolve_criterion(criterion) -> Criterion:
    """Name or instance -> Criterion instance (None -> the paper's mid)."""
    if criterion is None:
        return _CRITERIA["mid"]
    if isinstance(criterion, Criterion):
        return criterion
    try:
        return _CRITERIA[criterion]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown criterion {criterion!r}; registered: "
            f"{sorted(_CRITERIA)} (register_criterion adds more)"
        ) from None


def available_criteria() -> tuple:
    return tuple(sorted(_CRITERIA))


# ---------------------------------------------------------------------------
# built-ins
# ---------------------------------------------------------------------------

@register_criterion
@dataclasses.dataclass(frozen=True)
class MIDCriterion(Criterion):
    """Mutual-information difference — the paper's mRMR objective (Eq. 1):
    ``g_k = rel_k - red_sum_k / max(l, 1)``."""

    name = "mid"

    def init_state(self, n: int, device=None):
        return dict(red_sum=_zeros(n, device))

    def update(self, state, terms, l):
        return dict(red_sum=state["red_sum"] + marginal_terms(terms))

    def objective(self, rel, state, l):
        return rel - state["red_sum"] / _mean_denom(l)


@register_criterion
@dataclasses.dataclass(frozen=True)
class MIQCriterion(Criterion):
    """Mutual-information quotient: ``g_k = rel_k / max(mean_red_k, eps)``,
    mean redundancy floored at 1e-4 nats."""

    name = "miq"

    def init_state(self, n: int, device=None):
        return dict(red_sum=_zeros(n, device))

    def update(self, state, terms, l):
        return dict(red_sum=state["red_sum"] + marginal_terms(terms))

    def objective(self, rel, state, l):
        red_mean = state["red_sum"] / _mean_denom(l)
        return rel / torch.clamp_min(red_mean, _QUOTIENT_EPS)


@register_criterion
@dataclasses.dataclass(frozen=True)
class MaxRelCriterion(Criterion):
    """Max-relevance baseline: ``g_k = rel_k``, no redundancy at all."""

    name = "maxrel"
    needs_redundancy = False

    def init_state(self, n: int, device=None):
        return {}

    def update(self, state, terms, l):
        return state

    def objective(self, rel, state, l):
        return rel


@register_criterion
@dataclasses.dataclass(frozen=True)
class JMICriterion(Criterion):
    """Joint mutual information:
    ``g_k = rel_k + mean_j [I(x_k; x_j | y) - I(x_k; x_j)]``."""

    name = "jmi"
    needs_conditional_redundancy = True

    def init_state(self, n: int, device=None):
        return dict(gap_sum=_zeros(n, device))

    def update(self, state, terms, l):
        gap = conditional_terms(terms) - marginal_terms(terms)
        return dict(gap_sum=state["gap_sum"] + gap)

    def objective(self, rel, state, l):
        return rel + state["gap_sum"] / _mean_denom(l)


@register_criterion
@dataclasses.dataclass(frozen=True)
class CMIMCriterion(Criterion):
    """Conditional mutual information maximisation:
    ``g_k = min_j I(x_k; y | x_j) = rel_k + min_j gap_kj``; pure relevance
    with an empty selected set."""

    name = "cmim"
    needs_conditional_redundancy = True

    def init_state(self, n: int, device=None):
        return dict(worst_gap=torch.full((n,), float("inf"), dtype=torch.float32, device=device))

    def update(self, state, terms, l):
        gap = conditional_terms(terms) - marginal_terms(terms)
        return dict(worst_gap=torch.minimum(state["worst_gap"], gap))

    def objective(self, rel, state, l):
        return rel if int(l) == 0 else rel + state["worst_gap"]


@register_criterion
@dataclasses.dataclass(frozen=True)
class MIFSCriterion(Criterion):
    """Mutual information feature selection (Battiti, beta = 1):
    ``g_k = rel_k - sum_j I(x_k; x_j)``."""

    name = "mifs"

    def init_state(self, n: int, device=None):
        return dict(red_sum=_zeros(n, device))

    def update(self, state, terms, l):
        return dict(red_sum=state["red_sum"] + marginal_terms(terms))

    def objective(self, rel, state, l):
        return rel - state["red_sum"]


@register_criterion
@dataclasses.dataclass(frozen=True)
class CIFECriterion(Criterion):
    """Conditional infomax feature extraction:
    ``g_k = rel_k + sum_j [I(x_k; x_j | y) - I(x_k; x_j)]``."""

    name = "cife"
    needs_conditional_redundancy = True

    def init_state(self, n: int, device=None):
        return dict(gap_sum=_zeros(n, device))

    def update(self, state, terms, l):
        gap = conditional_terms(terms) - marginal_terms(terms)
        return dict(gap_sum=state["gap_sum"] + gap)

    def objective(self, rel, state, l):
        return rel + state["gap_sum"]


@register_criterion
@dataclasses.dataclass(frozen=True)
class ICAPCriterion(Criterion):
    """Interaction capping:
    ``g_k = rel_k - sum_j max(0, I(x_k; x_j) - I(x_k; x_j | y))``."""

    name = "icap"
    needs_conditional_redundancy = True

    def init_state(self, n: int, device=None):
        return dict(cap_sum=_zeros(n, device))

    def update(self, state, terms, l):
        capped = torch.clamp_min(
            marginal_terms(terms) - conditional_terms(terms), 0.0
        )
        return dict(cap_sum=state["cap_sum"] + capped)

    def objective(self, rel, state, l):
        return rel - state["cap_sum"]


__all__ = [
    "CIFECriterion",
    "CMIMCriterion",
    "Criterion",
    "ICAPCriterion",
    "JMICriterion",
    "MIDCriterion",
    "MIFSCriterion",
    "MIQCriterion",
    "MaxRelCriterion",
    "available_criteria",
    "conditional_terms",
    "marginal_terms",
    "register_criterion",
    "resolve_criterion",
]
