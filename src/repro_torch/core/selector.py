"""The front-door selection API: ``MRMRSelector`` / ``SelectionPlan``.

1. **Planning** — ``plan_selection`` implements the paper's §III rule:
   tall/narrow data -> conventional encoding (observations sharded),
   wide/short -> alternative (features sharded; non-MI scores always),
   both large on at least ``GRID_MIN_DEVICES`` devices -> the 2-D grid, and
   factors the devices into a mesh shape.  Continuous data takes the
   paper's Pearson score (``PearsonMIScore``) on the alternative encoding,
   or, with ``bins=``, quantile codes and exact MI.
2. **Engines** — a registry mapping encoding names to fit functions
   (``reference`` / ``conventional`` / ``alternative`` / ``grid`` here,
   ``streaming`` in :mod:`repro_torch.core.streaming`); a plan's ``mesh``
   says where the shards go.
3. **The selector** — ``MRMRSelector.fit(X, y)`` resolves the score, the
   plan and the mesh, lands the data on the device and hands off to the
   engine.  Inputs are always observations × features; layout changes are
   views.

    >>> from repro_torch import MRMRSelector
    >>> sel = MRMRSelector(num_select=10).fit(X, y)   # on the card
    >>> X_reduced = sel.transform(X)                  # selection order

The selector runs on ``device="cuda"`` unless told otherwise and raises
when no card is present; it never falls back to the CPU.  ``devices=None``
is every local device of that kind: all the cards (one on a one-card
machine, so one-device plans), the CPU once.  A ``mesh=`` or a device list
may repeat a device, to run the mesh engines on one card.
"""

from __future__ import annotations

import dataclasses
import math
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
from repro_torch.dist.meshes import (
    Mesh,
    check_mesh_kind,
    factor_mesh,
    local_devices,
    make_mesh,
)
from repro_torch.dist.sharding import axes_tuple as _axes_tuple
from repro_torch.dist.streaming import effective_block_obs, resolve_prefetch
from repro_torch.kernels import ops
from repro_torch.runtime import tracing

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
    """Resolved strategy for one ``fit``.

    ``score=None`` means "resolve from the data at fit time";
    ``criterion`` is a registered name or a
    :class:`~repro_torch.core.criteria.Criterion` instance.
    ``mesh_shape`` aligns with ``obs_axes + feat_axes``; empty means run
    unsharded.  ``mesh`` is the mesh the selector resolved for the engine.
    """

    encoding: str                     # reference|conventional|alternative|grid|streaming
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
    obs_axes: tuple = ()              # mesh axes sharding observations
    feat_axes: tuple = ()             # mesh axes sharding features
    mesh_shape: tuple = ()            # extents, aligned with mesh_axes
    mesh: Mesh | None = None          # where the shards run (None = unsharded)

    @property
    def mesh_axes(self) -> tuple:
        return self.obs_axes + self.feat_axes

    @property
    def num_shards(self) -> int:
        return math.prod(self.mesh_shape) if self.mesh_shape else 1


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


def _device_count(devices, device="cuda") -> int:
    """The device budget: every local device of ``device``'s kind for
    ``None``, a mesh's positions, an int as given, a list's length."""
    if devices is None:
        return len(local_devices(device))
    if isinstance(devices, Mesh):
        return devices.size
    if isinstance(devices, int):
        return devices
    return len(devices)


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
    """Pick encoding + mesh for a dataset shape (paper §III).

    The signature is the JAX package's, with the port's ``device`` last.

    Args:
      shape: (observations, features) of the conventional-orientation input.
      devices: device budget — an int, a device list, a ``Mesh`` (planning
        is then constrained to its axes), or None for every local device of
        ``device``'s kind.  One device never plans a grid.
      score: the score spec.  Non-MI scores force the alternative encoding
        (the only layout that supports arbitrary scores, §IV.D).
      obs_axes, feat_axes: mesh axis names for observation / feature
        sharding.
      block: accepted for the JAX signature; the kernels pick their own
        tiling (the plain count's block is ``MIScore.block``).
      device: where the plan runs.
    """
    criterion = resolve_criterion(criterion)
    m, n = int(shape[0]), int(shape[1])
    obs_axes, feat_axes = _axes_tuple(obs_axes), _axes_tuple(feat_axes)
    n_dev = _device_count(devices, device)
    mesh = devices if isinstance(devices, Mesh) else None
    if mesh is not None:
        obs_axes = tuple(a for a in obs_axes if a in mesh.shape)
        feat_axes = tuple(a for a in feat_axes if a in mesh.shape)

    mi_ok = score is None or isinstance(score, MIScore)
    aspect = m / max(n, 1)
    can_grid = (
        mi_ok
        and _grid_worthwhile(m, n, n_dev)
        and (mesh is None or (obs_axes and feat_axes))
    )
    if not mi_ok:
        encoding = "alternative"
    elif can_grid:
        encoding = "grid"
    elif aspect >= 1.0:
        encoding = "conventional"
    else:
        encoding = "alternative"

    common = dict(incremental=incremental, score=score, criterion=criterion,
                  device=str(device))
    if n_dev <= 1 and mesh is None:
        # One device: the encoding still follows the shape (the engines run
        # unsharded), so plans are stable as the fleet scales.
        if encoding == "grid":
            encoding = "conventional" if aspect >= 1.0 else "alternative"
        return SelectionPlan(encoding=encoding, **common)

    if mesh is not None:
        if encoding == "conventional" and not obs_axes:
            encoding = "alternative" if feat_axes else "reference"
        if encoding == "alternative" and not feat_axes:
            # Only MI scores may reroute to the conventional engine; any
            # other score falls back to the score-agnostic reference.
            encoding = "conventional" if (obs_axes and mi_ok) else "reference"
        if encoding == "reference":
            return SelectionPlan("reference", **common)
        if encoding == "conventional":
            feat_axes = ()
        elif encoding == "alternative":
            obs_axes = ()
        return SelectionPlan(
            encoding, obs_axes=obs_axes, feat_axes=feat_axes,
            mesh_shape=tuple(mesh.shape[a] for a in obs_axes + feat_axes), **common,
        )

    if encoding == "grid":
        gf = _grid_factor(m, n, n_dev)
        if gf is None:  # prime device count: the grid degenerates
            encoding = "conventional" if aspect >= 1.0 else "alternative"
        else:
            return SelectionPlan(
                "grid", obs_axes=obs_axes[:1] or ("data",),
                feat_axes=feat_axes[:1] or ("model",), mesh_shape=gf, **common,
            )
    if encoding == "conventional":
        return SelectionPlan("conventional", obs_axes=obs_axes[:1] or ("data",),
                             mesh_shape=(n_dev,), **common)
    return SelectionPlan("alternative", feat_axes=feat_axes[:1] or ("model",),
                         mesh_shape=(n_dev,), **common)


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


# Engines read ``plan.mesh``: None runs on the data's device, a mesh shards
# the data over the plan's axes (the padding is the engines' own: padded
# observations carry an out-of-range category and count nothing, padded
# feature columns are zero and never picked).

@register_engine("reference")
def _fit_reference(X, y, *, num_select, plan) -> MRMRResult:
    return mrmr_mod.mrmr_reference(
        X.T, y, num_select, plan.score, incremental=plan.incremental,
        criterion=plan.criterion,
    )


@register_engine("conventional")
def _fit_conventional(X, y, *, num_select, plan) -> MRMRResult:
    return mrmr_mod.mrmr_conventional(
        X, y, num_select, plan.score, mesh=plan.mesh, obs_axes=plan.obs_axes,
        incremental=plan.incremental, criterion=plan.criterion,
    )


@register_engine("alternative")
def _fit_alternative(X, y, *, num_select, plan) -> MRMRResult:
    # Feature-major storage as a transposed VIEW: the contingency kernel
    # reads it in place.  A score that wants its own row layout (Pearson:
    # rows contiguous along M) gets one copy per fit here, or one a shard.
    X_rows = X.T
    feature_rows = getattr(plan.score, "feature_rows", None)
    if feature_rows is not None and plan.mesh is None:
        X_rows = feature_rows(X_rows)
    return mrmr_mod.mrmr_alternative(
        X_rows, y, num_select, plan.score, mesh=plan.mesh, feat_axes=plan.feat_axes,
        incremental=plan.incremental, criterion=plan.criterion,
    )


@register_engine("grid")
def _fit_grid(X, y, *, num_select, plan) -> MRMRResult:
    if plan.mesh is None:
        raise ValueError("grid encoding requires a mesh")
    return mrmr_mod.mrmr_grid(
        X, y, num_select, plan.score, mesh=plan.mesh, obs_axes=plan.obs_axes,
        feat_axes=plan.feat_axes, incremental=plan.incremental,
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
    """mRMR feature selection, scikit-learn style, on one device or a mesh.

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
        result.  Each process may shard its blocks over a local device mesh
        on the observation axes (``devices=``).  ``None``/1 is one process.
      device: where the fit runs; "cuda" (the default) raises without a
        card, "cpu" runs the plain PyTorch versions.  A mesh's devices are
        of the same kind.
      mesh: a :class:`~repro_torch.dist.meshes.Mesh` to run on; None lets
        the planner build one from ``devices``.
      devices: the device budget for planning (an int, a device list, or
        None for every local device of ``device``'s kind).  Ignored when
        ``mesh`` is given.
      obs_axes / feat_axes: mesh axis names for observation / feature
        sharding (intersected with the mesh's axes).

    Streamed fits follow the same §III rule: tall sources shard blocks over
    ``obs_axes``, wide ones shard blocks *and the per-pair statistics
    state* over ``feat_axes``, both-large ones run the 2-D grid; a ``mesh``
    overrides the rule with whatever axes it carries.
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
    mesh_: Mesh | None = None

    def __post_init__(self):
        _resolve_hosts(self.hosts)  # validate now; "auto" resolves at fit
        self._device = resolve_device(self.device)
        if isinstance(self.mesh, Mesh):
            check_mesh_kind(self.mesh, self._device)

    def _resolve_plan(self, shape: tuple, score: ScoreFn) -> SelectionPlan:
        """The in-memory plan: the §III rule for ``encoding="auto"``, else the
        asked encoding on the mesh (or the device budget's mesh)."""
        crit = resolve_criterion(self.criterion)
        if self.encoding == "auto":
            devices = self.mesh if self.mesh is not None else self.devices
            return plan_selection(
                shape, devices, score, obs_axes=self.obs_axes,
                feat_axes=self.feat_axes, incremental=self.incremental,
                block=self.block, criterion=crit, device=self._device,
            )
        obs, feat = _axes_tuple(self.obs_axes), _axes_tuple(self.feat_axes)
        if self.mesh is not None:
            obs = tuple(a for a in obs if a in self.mesh.shape)
            feat = tuple(a for a in feat if a in self.mesh.shape)
        axes = {
            "reference": ((), ()),
            "conventional": (obs, ()),
            "alternative": ((), feat),
            "grid": (obs, feat),
        }.get(self.encoding, (obs, feat))
        if self.mesh is not None:
            shape_of = tuple(self.mesh.shape[a] for a in axes[0] + axes[1])
        else:
            # No mesh given: build one from the device budget, so an
            # explicitly asked encoding still shards.
            n_dev = _device_count(self.devices, self._device)
            m, n = shape
            if self.encoding == "grid":
                # One device runs the degenerate 1x1 grid, as JAX does.
                axes = (axes[0][:1] or ("data",), axes[1][:1] or ("model",))
                shape_of = (factor_mesh(n_dev, bias=max(m / max(n, 1), 1e-6))
                            if n_dev > 1 else (1, 1))
            elif n_dev <= 1 or self.encoding == "reference":
                axes, shape_of = ((), ()), ()
            elif self.encoding == "conventional":
                axes, shape_of = (axes[0][:1] or ("data",), ()), (n_dev,)
            elif self.encoding == "alternative":
                axes, shape_of = ((), axes[1][:1] or ("model",)), (n_dev,)
            else:  # a registered engine runs unsharded unless given a mesh
                shape_of = ()
        return SelectionPlan(
            encoding=self.encoding, obs_axes=axes[0], feat_axes=axes[1],
            mesh_shape=shape_of, incremental=self.incremental, score=score,
            criterion=crit, device=str(self._device),
        )

    def _resolve_mesh(self, plan: SelectionPlan) -> Mesh | None:
        """The mesh the engine runs on: the user's (when the plan shards), or
        one of ``plan.mesh_shape`` over the device budget."""
        if self.mesh is not None:
            return self.mesh if plan.mesh_axes else None
        if not plan.mesh_shape:
            return None
        devices = self.devices
        if devices is None or isinstance(devices, int):
            devices = local_devices(self._device)
        mesh = make_mesh(plan.mesh_shape, plan.mesh_axes, devices=devices)
        check_mesh_kind(mesh, self._device)
        return mesh

    def _resolve_score(self, X: torch.Tensor, y: torch.Tensor) -> ScoreFn:
        if self.score is not None:
            return self.score
        if X.dtype.is_floating_point:
            return PearsonMIScore()

        def read(t):
            return int(tracing.host_read("validate", t))

        with tracing.span("mrmr.validate"):
            if read(X.min()) < 0 or read(y.min()) < 0:
                # Negative categories count nothing, so those observations
                # would silently vanish from the MI counts — fail instead.
                raise ValueError(
                    "negative category values in discrete data: contingency "
                    "counts drop them silently; remap categories to 0..K-1 "
                    "before fitting"
                )
            return MIScore(num_values=read(X.max()) + 1, num_classes=read(y.max()) + 1)

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
        self.mesh_ = plan.mesh
        # An engine registered from outside may leave its provenance empty:
        # fill both names in from the plan that drove the fit.
        if not res.engine:
            res = dataclasses.replace(res, engine=plan.encoding)
        if not res.criterion:
            res = dataclasses.replace(
                res, criterion=resolve_criterion(plan.criterion).name
            )
        with tracing.span("mrmr.finish"):
            self.selected_ = tracing.host_read("finish", res.selected).numpy()
            self.gains_ = tracing.host_read("finish", res.gains).numpy()
            self.scores_ = (None if res.relevance is None
                            else tracing.host_read("finish", res.relevance).numpy())
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
        mrmr_mod.check_conditional_support(score, resolve_criterion(self.criterion))
        plan = self._resolve_stream_plan(source, score)
        plan = dataclasses.replace(
            plan, bins=source.bins if isinstance(source, BinnedSource) else None,
            mesh=self._resolve_mesh(plan),
        )
        res = get_engine("streaming")(
            source, None, num_select=self.num_select, plan=plan
        )
        return self._finish_fit(res, plan, source.num_features)

    def _resolve_stream_plan(self, source: DataSource, score: ScoreFn) -> SelectionPlan:
        """Streaming layout per the paper's §III rule: tall shards blocks over
        observations, wide shards blocks AND statistics over features,
        both-large runs the 2-D grid.  A user mesh overrides the rule: the
        obs/feat axes it carries are used (both present -> 2-D).

        With ``hosts > 1`` the rule applies across processes
        (:func:`~repro_torch.dist.multihost.resolve_host_shards`) and the
        device layout is per process: blocks shard over its LOCAL devices on
        the observation axes only, since device feature-sharding would pad
        the statistics width past the exact shard width and break the
        cross-host alignment of the states."""
        m, n = source.num_obs, source.num_features
        aspect = m / max(n, 1)
        obs, feat = _axes_tuple(self.obs_axes), _axes_tuple(self.feat_axes)
        hosts = _resolve_hosts(self.hosts)
        if hosts > 1:
            if self.mesh is not None:
                raise ValueError(
                    "hosts > 1 plans the per-host device mesh from local "
                    "devices; pass devices= instead of mesh="
                )
            n_dev = _device_count(self.devices, self._device)
            obs, feat, shape = ((), (), ()) if n_dev <= 1 else (obs[:1] or ("data",), (), (n_dev,))
        elif self.mesh is not None:
            obs = tuple(a for a in obs if a in self.mesh.shape)
            feat = tuple(a for a in feat if a in self.mesh.shape)
            if not obs and not feat:
                # Running unsharded on a user's mesh would betray the device
                # budget; streaming has no engine to reroute to, so fail.
                raise ValueError(
                    f"mesh axes {tuple(self.mesh.shape)} share no axis with "
                    f"obs_axes {_axes_tuple(self.obs_axes)} or feat_axes "
                    f"{_axes_tuple(self.feat_axes)}; streaming shards "
                    "blocks over observation and/or feature axes"
                )
            shape = tuple(self.mesh.shape[a] for a in obs + feat)
        else:
            n_dev = _device_count(self.devices, self._device)
            gf = _grid_factor(m, n, n_dev)
            if n_dev <= 1:
                obs, feat, shape = (), (), ()
            elif aspect >= TALL_RATIO or (gf is None and aspect >= 1.0):
                obs, feat, shape = obs[:1] or ("data",), (), (n_dev,)
            elif gf is None:
                obs, feat, shape = (), feat[:1] or ("model",), (n_dev,)
            else:
                obs, feat, shape = obs[:1] or ("data",), feat[:1] or ("model",), gf
        q = int(self.batch_candidates)
        if q < 1:
            raise ValueError(f"batch_candidates must be >= 1, got {q}")
        if int(self.readahead) < 0:
            raise ValueError(f"readahead must be >= 0, got {self.readahead}")
        # The EFFECTIVE block size: the placer rounds blocks up to the
        # observation extent, and plan_ reports what runs.
        block_obs = effective_block_obs(
            self.block_obs, math.prod(shape[: len(obs)]) if obs else 1
        )
        return SelectionPlan(
            encoding="streaming", obs_axes=obs, feat_axes=feat, mesh_shape=shape,
            block_obs=block_obs, prefetch=resolve_prefetch(self.prefetch, self._device),
            score=score, criterion=resolve_criterion(self.criterion),
            batch_candidates=q, device=str(self._device),
            spill_dir=self.spill_dir, spill_budget_bytes=self.spill_budget_bytes,
            readahead=int(self.readahead), hosts=hosts,
        )

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
        with tracing.span(tracing.FIT):
            return self._fit_arrays(X, y)

    def _fit_arrays(self, X, y) -> "MRMRSelector":
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
        mrmr_mod.check_conditional_support(score, resolve_criterion(self.criterion))
        plan = self._resolve_plan(tuple(X.shape), score)
        plan = dataclasses.replace(plan, bins=plan_bins, mesh=self._resolve_mesh(plan))
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
