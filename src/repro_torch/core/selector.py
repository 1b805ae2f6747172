"""The front-door selection API: ``MRMRSelector`` / ``SelectionPlan``.

1. **Planning** — ``plan_selection`` implements the paper's §III rule on one
   device: tall/narrow data -> conventional encoding, wide/short ->
   alternative (non-MI scores always alternative).  Continuous data takes
   the paper's Pearson score (``PearsonMIScore``) on the alternative
   encoding, or, with ``bins=``, quantile codes and exact MI.
2. **Engines** — a registry mapping encoding names to fit functions
   (``reference`` / ``conventional`` / ``alternative`` here, ``streaming``
   in :mod:`repro_torch.core.streaming`).
3. **The selector** — ``MRMRSelector.fit(X, y)`` resolves the score and
   the plan, lands the data on the device and hands off to the engine.
   Inputs are always observations × features; layout changes are views.

    >>> from repro_torch import MRMRSelector
    >>> sel = MRMRSelector(num_select=10).fit(X, y)   # on the card
    >>> X_reduced = sel.transform(X)                  # selection order

The selector runs on ``device="cuda"`` unless told otherwise and raises
when no card is present; it never falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import mrmr as mrmr_mod
from repro_torch.core.criteria import Criterion, resolve_criterion
from repro_torch.core.mrmr import MRMRResult
from repro_torch.core.scores import MIScore, PearsonMIScore, ScoreFn
from repro_torch.data.binning import BinnedSource, _as_class_labels
from repro_torch.data.sources import ArraySource, DataSource
from repro_torch.device import resolve_device
from repro_torch.dist import multihost
from repro_torch.dist.meshes import factor_mesh
from repro_torch.dist.streaming import effective_block_obs, resolve_prefetch
from repro_torch.kernels import ops

# Paper §III aspect-ratio rule: beyond these ratios one axis dominates and
# single-axis sharding wins; between them (and with enough devices or hosts
# and data) the 2-D grid removes both memory walls at once.  The multi-host
# shard rule (repro_torch.dist.multihost.resolve_host_shards) reads them.
TALL_RATIO = 4.0      # obs/feat >= this -> conventional (observation-sharded)
WIDE_RATIO = 0.25     # obs/feat <= this -> alternative (feature-sharded)
GRID_MIN_DIM = 512    # both dims at least this before a grid pays off
GRID_MIN_DEVICES = 4  # a 2-D grid needs at least a 2x2 factorisation


def check_num_select(num_select, n_features: int) -> None:
    """Shared fit-time bounds check: ``1 <= num_select <= num_features``."""
    if not 1 <= int(num_select) <= n_features:
        raise ValueError(
            f"num_select={num_select} out of range: need "
            f"1 <= num_select <= num_features ({n_features})"
        )


@dataclasses.dataclass(frozen=True)
class SelectionPlan:
    """Resolved strategy for one ``fit`` on one device.

    ``score=None`` means "resolve from the data at fit time";
    ``criterion`` is a registered name or a
    :class:`~repro_torch.core.criteria.Criterion` instance.
    """

    encoding: str                     # reference|conventional|alternative|streaming
    incremental: bool = True          # running criterion fold vs recompute
    score: ScoreFn | None = None      # score spec (None = auto from data)
    block_obs: int = 65536            # streaming: observations per block
    prefetch: int = 2                 # streaming: blocks staged ahead
    criterion: object = "mid"         # greedy objective (name or Criterion)
    batch_candidates: int = 1         # streaming: redundancy vectors per pass
    device: str = "cuda"              # where the engine runs
    bins: int | None = None           # quantile-binned fit: codes per
                                      # feature (None = data used as given)
    spill_dir: str | None = None      # streaming: encoded-block spill cache
                                      # directory (None = off)
    spill_budget_bytes: int | None = None  # LRU byte budget for spill_dir
    readahead: int = 0                # streaming: raw blocks read across
                                      # pass boundaries (0 = off)
    hosts: int = 1                    # streaming: torch.distributed processes
                                      # sharing the fit (1 = single-host)


def _grid_worthwhile(m: int, n: int, n_dev: int) -> bool:
    """§III both-large gate: enough devices (or hosts) for a 2-D
    factorisation, both dims big enough to shard, and no axis dominant
    enough for 1-D to win."""
    aspect = m / max(n, 1)
    return (
        n_dev >= GRID_MIN_DEVICES
        and min(m, n) >= GRID_MIN_DIM
        and WIDE_RATIO < aspect < TALL_RATIO
    )


def _grid_factor(m: int, n: int, n_dev: int) -> tuple | None:
    """The (obs, feat) factorisation when a 2-D grid pays off for an (m, n)
    dataset over ``n_dev`` devices or hosts, else None (grid not worthwhile,
    or the count only factors 1-D)."""
    if not _grid_worthwhile(m, n, n_dev):
        return None
    # Weight the split by the aspect ratio: a taller dataset gets more
    # observation shards.
    od, fd = factor_mesh(n_dev, bias=max(m / max(n, 1), 1e-6))
    return None if min(od, fd) == 1 else (od, fd)


def _axes(axes) -> tuple:
    """Mesh axis names as a tuple (a bare string names one axis)."""
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _check_single_device(devices=None, obs_axes=("data",), feat_axes=("model",)) -> None:
    """Refuse the JAX package's mesh knobs beyond one device: ``devices`` of
    ``None`` or 1 and the default axis names plan what one device runs; any
    other value raises ``NotImplementedError`` naming the knob (the mesh
    engines are not yet ported)."""
    unported = dict(
        devices=devices not in (None, 1),
        obs_axes=_axes(obs_axes) != ("data",),
        feat_axes=_axes(feat_axes) != ("model",),
    )
    for knob, is_set in unported.items():
        if is_set:
            raise NotImplementedError(
                f"{knob}=... beyond one device is not yet ported to repro_torch"
            )


def plan_selection(
    shape: tuple,
    devices=None,
    score: ScoreFn | None = None,
    *,
    obs_axes=("data",),
    feat_axes=("model",),
    incremental: bool = True,
    block: int = 64,
    criterion: Criterion | str = "mid",
    device="cuda",
) -> SelectionPlan:
    """Pick the encoding for a dataset shape (paper §III, one device).

    The signature is the JAX package's, with the port's ``device`` last.

    Args:
      shape: (observations, features) of the conventional-orientation input.
      devices: the device budget; ``None`` or 1 (one device) only.
      score: the score spec.  Non-MI scores force the alternative encoding
        (the only layout that supports arbitrary scores, §IV.D).
      obs_axes, feat_axes: mesh axis names; only the defaults (no mesh).
      block: accepted for the JAX signature; the kernels pick their own
        tiling (the plain count's block is ``MIScore.block``).
      device: where the plan runs.
    """
    _check_single_device(devices, obs_axes, feat_axes)
    criterion = resolve_criterion(criterion)
    m, n = int(shape[0]), int(shape[1])
    mi_ok = score is None or isinstance(score, MIScore)
    tall = m / max(n, 1) >= 1.0
    encoding = "conventional" if mi_ok and tall else "alternative"
    return SelectionPlan(
        encoding=encoding, incremental=incremental, score=score,
        criterion=criterion, device=str(device),
    )


# ---------------------------------------------------------------------------
# engine registry
# ---------------------------------------------------------------------------

# name -> fit(X, y, *, num_select, plan) -> MRMRResult, with X in
# conventional orientation (observations × features) on the plan's device.
_ENGINES: dict = {}


def register_engine(name: str) -> Callable:
    """Register a selection engine under an encoding name (decorator)."""

    def deco(fn):
        _ENGINES[name] = fn
        return fn

    return deco


def get_engine(name: str):
    try:
        return _ENGINES[name]
    except KeyError:
        raise ValueError(
            f"unknown encoding {name!r}; registered: {sorted(_ENGINES)}"
        ) from None


def available_encodings() -> tuple:
    return tuple(sorted(_ENGINES))


@register_engine("reference")
def _fit_reference(X, y, *, num_select, plan) -> MRMRResult:
    return mrmr_mod.mrmr_reference(
        X.T, y, num_select, plan.score, incremental=plan.incremental,
        criterion=plan.criterion,
    )


@register_engine("conventional")
def _fit_conventional(X, y, *, num_select, plan) -> MRMRResult:
    return mrmr_mod.mrmr_conventional(
        X, y, num_select, plan.score, incremental=plan.incremental,
        criterion=plan.criterion,
    )


@register_engine("alternative")
def _fit_alternative(X, y, *, num_select, plan) -> MRMRResult:
    # Feature-major storage as a transposed VIEW: the contingency kernel
    # reads it in place.  A score that wants its own row layout (Pearson:
    # rows contiguous along M) gets one copy per fit here.
    X_rows = X.T
    feature_rows = getattr(plan.score, "feature_rows", None)
    if feature_rows is not None:
        X_rows = feature_rows(X_rows)
    return mrmr_mod.mrmr_alternative(
        X_rows, y, num_select, plan.score, incremental=plan.incremental,
        criterion=plan.criterion,
    )


# ---------------------------------------------------------------------------
# the selector
# ---------------------------------------------------------------------------

def _resolve_hosts(hosts) -> int:
    """The process count a fit spans: ``None``/1 one process, ``"auto"``
    the ``torch.distributed`` world size (1 when no process group is up),
    an int as given (a mismatch with the process group fails in the
    collectives)."""
    if hosts in (None, 1):
        return 1
    if hosts == "auto":
        return multihost.process_count()
    h = int(hosts)
    if h < 1:
        raise ValueError(f"hosts must be >= 1 or 'auto', got {hosts!r}")
    return h


@dataclasses.dataclass
class MRMRSelector:
    """mRMR feature selection, scikit-learn style, on one device.

    ``fit(X, y)`` -> self with ``selected_`` / ``gains_`` / ``scores_`` /
    ``ranking_`` / ``plan_`` / ``result_``; ``transform(X)`` returns the
    selected columns in selection order.  ``X`` is always (observations ×
    features).  A :class:`~repro_torch.data.sources.DataSource` passed
    alone runs the ``"streaming"`` engine block by block.

    The fields are the JAX package's, in its order (a positional call
    means the same in both), with the port's ``device`` after them.

    Args:
      num_select: L, number of features to pick (``1 <= L <= features``).
      score: a ``ScoreFn``; None resolves exact MI with cardinalities
        inferred from discrete data, and ``PearsonMIScore`` for continuous
        data (or, with ``bins=``, MI sized from the bin config).
      encoding: "auto" (paper §III rule) or one of ``available_encodings()``.
      incremental: False reproduces the paper's per-iteration redundancy
        recomputation; True carries the criterion's running fold state.
      block: accepted for the JAX signature; the kernels pick their own
        tiling (the plain count's block is ``MIScore.block``).
      block_obs: observations per streaming block.
      prefetch: streaming host blocks staged ahead ("auto": 2 on CUDA).
      criterion: the greedy objective — a registered name or a Criterion.
      bins: discretise continuous features into this many equal-frequency
        bins (one streaming quantile-sketch pass on the host, memoised by
        the data's fingerprint) and select with exact discrete MI.  Ignored
        for discrete data and for an explicit non-MI score; the resolved
        ``plan_.bins`` records what ran.  Streaming fits encode each block
        on the card; in-memory fits encode the whole matrix on the card once.
      batch_candidates: streaming redundancy vectors speculated per pass.
      spill_dir: streaming fits only — directory of the encoded-block
        spill cache (:class:`repro_torch.data.block_cache.BlockCacheSource`):
        pass 1 spills each parsed or encoded block as ``.npy`` chunks,
        passes 2..L replay them memmapped (a binned source spills its int
        codes).  ``spill_budget_bytes`` bounds the directory (LRU).
      readahead: streaming fits only — raw blocks a reader thread holds
        ahead across pass boundaries (0 = off; positive replaces
        ``prefetch``).
      hosts: streaming fits only — run the fit across this many
        ``torch.distributed`` processes (``"auto"`` = the world size after
        :func:`repro_torch.dist.multihost.init_multihost`, 1 with no process
        group).  The §III rule then applies across processes: each reads
        only its block/column ranges, per-pass statistics merge with
        explicit gloo collectives, and every process returns the identical
        result.  One device per process.  ``None``/1 is one process.
      device: where the fit runs; "cuda" (the default) raises without a
        card, "cpu" runs the plain PyTorch versions.
      mesh: not yet ported; and ``devices``, ``obs_axes``, ``feat_axes``
        only as one device (None or 1, the default axes).  Any other value
        raises ``NotImplementedError`` naming the knob.
    """

    num_select: int
    score: ScoreFn | None = None
    encoding: str = "auto"
    mesh: object = None
    devices: object = None
    obs_axes: tuple | str = ("data",)
    feat_axes: tuple | str = ("model",)
    incremental: bool = True
    block: int = 64
    block_obs: int = 65536
    prefetch: int | str = "auto"
    criterion: Criterion | str = "mid"
    bins: int | None = None
    batch_candidates: int = 1
    spill_dir: str | None = None
    spill_budget_bytes: int | None = None
    readahead: int = 0
    hosts: int | str | None = None
    device: str = "cuda"

    selected_: np.ndarray | None = None
    gains_: np.ndarray | None = None
    scores_: np.ndarray | None = None
    ranking_: np.ndarray | None = None
    result_: MRMRResult | None = None
    n_features_in_: int | None = None
    plan_: SelectionPlan | None = None

    def __post_init__(self):
        _check_single_device(self.devices, self.obs_axes, self.feat_axes)
        if self.mesh is not None:
            raise NotImplementedError(
                "MRMRSelector(mesh=...) is not yet ported to repro_torch"
            )
        _resolve_hosts(self.hosts)  # validate now; "auto" resolves at fit
        self._device = resolve_device(self.device)

    def _resolve_score(self, X: torch.Tensor, y: torch.Tensor) -> ScoreFn:
        if self.score is not None:
            return self.score
        if X.dtype.is_floating_point:
            return PearsonMIScore()
        if int(X.min()) < 0 or int(y.min()) < 0:
            # Negative categories count nothing, so those observations would
            # silently vanish from the MI counts — fail instead.
            raise ValueError(
                "negative category values in discrete data: contingency "
                "counts drop them silently; remap categories to 0..K-1 "
                "before fitting"
            )
        return MIScore(num_values=int(X.max()) + 1, num_classes=int(y.max()) + 1)

    def _resolve_source_score(self, source: DataSource) -> ScoreFn:
        if self.score is not None:
            return self.score
        st = source.stats(self.block_obs)  # scan honours the memory knob
        if st.discrete:
            return MIScore(num_values=st.num_values, num_classes=st.num_classes)
        return PearsonMIScore()

    @staticmethod
    def _continuous_mi_error(what: str) -> ValueError:
        return ValueError(
            f"MIScore needs discrete categories but {what} holds continuous "
            "values: pass bins= to quantile-discretise on the fly — "
            "MRMRSelector(num_select=..., bins=32) — or score with "
            "PearsonMIScore()"
        )

    def _bins_apply(self) -> bool:
        """Whether ``bins=`` is set and the fit is headed down the discrete
        MI path (score None or MI)."""
        return self.bins is not None and (
            self.score is None or isinstance(self.score, MIScore)
        )

    def _maybe_bin_source(self, source: DataSource) -> DataSource:
        """Wrap a continuous source for on-the-fly discretisation when
        ``bins=`` applies.  Discrete sources and explicit non-MI scores pass
        through untouched."""
        if not self._bins_apply() or isinstance(source, BinnedSource):
            return source
        if self._source_is_discrete(source):
            return source
        return BinnedSource(source, self.bins, fit_block_obs=self.block_obs)

    def _source_is_discrete(self, source: DataSource) -> bool:
        """Discrete-vs-continuous routing, free when the source's
        ``feature_dtype`` is statically known (no ``iter_blocks`` pass)."""
        dt = source.feature_dtype
        if dt is not None:
            return not np.issubdtype(dt, np.floating)
        return source.stats(self.block_obs).discrete

    def _bin_score(self, binned: BinnedSource) -> ScoreFn:
        """Score for a binned fit: auto-sized MI, or the user's MIScore
        checked against the code range (codes land in [0, bins))."""
        if self.score is None:
            return MIScore(
                num_values=binned.bins,
                num_classes=binned.stats().num_classes,
            )
        if isinstance(self.score, MIScore) and self.score.num_values < binned.bins:
            raise ValueError(
                f"score num_values={self.score.num_values} < bins="
                f"{binned.bins}: bin codes in [0, {binned.bins}) would "
                "count nothing; drop the explicit score or set "
                "num_values >= bins"
            )
        return self.score

    def _encode_in_memory(self, X: torch.Tensor, y: torch.Tensor):
        """The in-memory binned fit's encode -> ``(codes, labels, score,
        bins)`` on the device.

        The sketch pass runs on the host over the same
        :class:`BinnedSource` the streaming path builds, so the edges (and
        hence the selection) are the streaming path's; a device-resident X
        is copied to the host for it.  X is then encoded on the card by the
        bin-code kernel, bitwise the codes ``QuantileBinner.transform``
        gives, without a pass of host ``searchsorted`` per column.
        """
        # The sketch reads float32 (bf16 widens exactly; numpy has none).
        X_host = X.cpu()
        if X_host.dtype == torch.bfloat16:
            X_host = X_host.to(torch.float32)
        X_host, y_host = X_host.numpy(), y.cpu().numpy()
        binned = BinnedSource(
            ArraySource(X_host, y_host), self.bins, fit_block_obs=self.block_obs
        )
        score = self._bin_score(binned)  # the sketch pass, or its memo
        edges = torch.from_numpy(binned.binner.edges_).to(self._device)
        codes = ops.bin_codes(
            X.to(device=self._device, dtype=torch.float32), edges,
            getattr(score, "use_kernel", "auto"),
        )
        labels = torch.from_numpy(_as_class_labels(y_host)).to(self._device)
        return codes, labels, score, binned.bins

    def _finish_fit(self, res: MRMRResult, plan: SelectionPlan,
                    n_features: int) -> "MRMRSelector":
        # An engine registered from outside may leave its provenance empty:
        # fill both names in from the plan that drove the fit.
        if not res.engine:
            res = dataclasses.replace(res, engine=plan.encoding)
        if not res.criterion:
            res = dataclasses.replace(
                res, criterion=resolve_criterion(plan.criterion).name
            )
        self.selected_ = res.selected.cpu().numpy()
        self.gains_ = res.gains.cpu().numpy()
        self.scores_ = None if res.relevance is None else res.relevance.cpu().numpy()
        ranking = np.full((n_features,), len(self.selected_) + 1, np.int32)
        ranking[self.selected_] = np.arange(1, len(self.selected_) + 1)
        self.ranking_ = ranking
        self.n_features_in_ = int(n_features)
        self.result_ = res
        self.plan_ = plan
        return self

    def get_support(self, indices: bool = False) -> np.ndarray:
        """Selected-feature mask, or ascending indices with ``indices=True``."""
        if self.selected_ is None or self.n_features_in_ is None:
            raise RuntimeError("fit() first")
        mask = np.zeros((self.n_features_in_,), bool)
        mask[self.selected_] = True
        return np.flatnonzero(mask) if indices else mask

    def _fit_source(self, source: DataSource) -> "MRMRSelector":
        if self.encoding not in ("auto", "streaming"):
            raise ValueError(
                f"encoding {self.encoding!r} needs in-memory arrays; "
                "DataSource inputs run the 'streaming' engine"
            )
        check_num_select(self.num_select, source.num_features)
        source = self._maybe_bin_source(source)
        if isinstance(source, BinnedSource):
            score = self._bin_score(source)
        else:
            score = self._resolve_source_score(source)
            if isinstance(score, MIScore) and not self._source_is_discrete(source):
                # Explicit MI on float blocks would truncate them to
                # categories inside the count — fail actionably here.
                raise self._continuous_mi_error("the source")
        crit = resolve_criterion(self.criterion)
        mrmr_mod.check_conditional_support(score, crit)
        q = int(self.batch_candidates)
        if q < 1:
            raise ValueError(f"batch_candidates must be >= 1, got {q}")
        if int(self.readahead) < 0:
            raise ValueError(f"readahead must be >= 0, got {self.readahead}")
        plan = SelectionPlan(
            encoding="streaming",
            block_obs=effective_block_obs(self.block_obs),
            prefetch=resolve_prefetch(self.prefetch, self._device),
            score=score, criterion=crit, batch_candidates=q,
            device=str(self._device),
            bins=source.bins if isinstance(source, BinnedSource) else None,
            spill_dir=self.spill_dir,
            spill_budget_bytes=self.spill_budget_bytes,
            readahead=int(self.readahead),
            hosts=_resolve_hosts(self.hosts),
        )
        res = get_engine("streaming")(
            source, None, num_select=self.num_select, plan=plan
        )
        return self._finish_fit(res, plan, source.num_features)

    def fit(self, X, y=None) -> "MRMRSelector":
        """X: (observations, features) array + y: (observations,) targets,
        or a ``DataSource`` alone (targets come from its blocks)."""
        if not isinstance(X, DataSource) and self.encoding == "streaming" and y is not None:
            X, y = ArraySource(X, y), None
        if isinstance(X, DataSource):
            if y is not None:
                raise ValueError("y comes from the DataSource; call fit(source) alone")
            return self._fit_source(X)
        if y is None:
            raise ValueError(
                "y is required for array inputs (only DataSource fits "
                "carry their own targets)"
            )
        if _resolve_hosts(self.hosts) > 1:
            raise ValueError(
                "hosts > 1 runs the streaming engine: pass a DataSource, "
                "or arrays with encoding='streaming'"
            )
        X = torch.as_tensor(X)
        y = torch.as_tensor(y)
        if X.dim() != 2 or y.dim() != 1 or y.shape[0] != X.shape[0]:
            raise ValueError(f"bad shapes X{tuple(X.shape)} y{tuple(y.shape)}")
        check_num_select(self.num_select, X.shape[1])
        if X.dtype.is_complex:
            raise ValueError("complex features are not supported")
        plan_bins = None
        if self._bins_apply() and X.dtype.is_floating_point:
            X, y, score, plan_bins = self._encode_in_memory(X, y)
        else:
            X, y = X.to(self._device), y.to(self._device)
            if X.dtype == torch.bool:
                X = X.view(torch.uint8)  # same bytes, a dtype the kernel reads
            score = self._resolve_score(X, y)
            if isinstance(score, MIScore) and X.dtype.is_floating_point:
                # The counts would truncate float columns to categories.
                raise self._continuous_mi_error("X")
        # Discrete MI needs integral class labels; every other score keeps
        # continuous targets intact.
        y = y.to(torch.int32 if isinstance(score, MIScore) else torch.float32)
        crit = resolve_criterion(self.criterion)
        mrmr_mod.check_conditional_support(score, crit)
        if self.encoding == "auto":
            plan = plan_selection(
                X.shape, score=score, incremental=self.incremental,
                criterion=crit, device=self._device,
            )
        else:
            plan = SelectionPlan(
                encoding=self.encoding,
                incremental=self.incremental, score=score, criterion=crit,
                device=str(self._device),
            )
        plan = dataclasses.replace(plan, bins=plan_bins)
        res = get_engine(plan.encoding)(X, y, num_select=self.num_select, plan=plan)
        return self._finish_fit(res, plan, X.shape[1])

    def transform(self, X):
        """Selected columns of ``X``, ordered by selection rank (a
        ``DataSource`` streams through block by block)."""
        if self.selected_ is None:
            raise RuntimeError("fit() first")
        if isinstance(X, DataSource):
            return np.concatenate(
                [blk[:, self.selected_] for blk, _ in X.iter_blocks(self.block_obs)]
            )
        if isinstance(X, torch.Tensor):
            return X[:, torch.as_tensor(self.selected_, dtype=torch.long, device=X.device)]
        return np.asarray(X)[:, self.selected_]

    def fit_transform(self, X, y=None):
        return self.fit(X, y).transform(X)


__all__ = [
    "MRMRSelector",
    "SelectionPlan",
    "available_encodings",
    "check_num_select",
    "get_engine",
    "plan_selection",
    "register_engine",
]
