"""mRMR greedy engines — the reference and the paper's two encodings, on
one device or on a :class:`~repro_torch.dist.meshes.Mesh`.

The paper distributes mRMR two ways, keyed by data layout (Section III/IV):

* **conventional** — rows are observations, sharded over ``obs_axes``.
  Scoring = contingency tables of every feature against one target column
  (the mapper/combiner), summed across shards (the reducer).  Discrete
  data, MI score only.
* **alternative** — rows are features, sharded over ``feat_axes``.  The
  class vector and the selected features are broadcast; scoring is local
  to each feature row, any score.
* **grid** (beyond the paper) — observations AND features sharded on a 2-D
  mesh: counts summed over the observation axes, the argmax over the
  feature axes.

Without a mesh each runs unsharded on one device.  On a mesh, as the JAX
package's ``shard_map`` bodies do, each shard lives on its position's
device; the kernels run once per shard, and the cross-shard sums and the
distributed argmax are explicit (one host sync a pick, as on one device).
Counts are exact integers and equal tables give bit-equal MI, so a mesh fit
selects and scores bitwise what the one-device fit does.

The greedy loop runs on the host over the picks, with the selected set
kept as per-shard masks.  ``incremental=True`` carries the criterion's
running fold state (each pick scores candidates against only the newly
selected feature — O(N·L) pair scores); ``incremental=False`` is the
paper-faithful recomputation (O(N·L²)); a
:class:`~repro_torch.core.scores.CustomScore` always recomputes, on the
reference and alternative engines, and reports a NaN relevance.  The
incremental loop skips the fold after the last pick, whose result no pick
would read, so a fit of L features counts L contingency passes
(1 relevance + L-1 redundancy).

Argmax ties go to the lowest feature id on every layout, and selected
features are masked with ``-inf``.
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
from repro_torch.dist.meshes import check_mesh_kind
from repro_torch.dist.sharding import axes_tuple, grid_devices, psum, shard_window

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


# ---------------------------------------------------------------------------
# the greedy loop over feature groups
# ---------------------------------------------------------------------------

def _distributed_argmax(gs: list, offsets: list):
    """Global ``(id, best)`` over per-group objective slices ``gs`` (group
    ``j`` holds global ids ``offsets[j]...``).  Ties break toward the
    smallest global id, so the pick does not depend on the layout.

    One group is ``torch.argmax`` (the first maximum) and one host sync,
    ``best`` staying on the device.  Several groups stack each group's
    ``(best, id)`` on the first group's device and read them once: still one
    sync a pick.  Float32 objectives and int ids are exact in float64.
    """
    if len(gs) == 1:
        a = int(torch.argmax(gs[0]))
        return a + offsets[0], gs[0][a]
    dev = gs[0].device
    rows = []
    for g, off in zip(gs, offsets):
        a = torch.argmax(g)
        rows.append(torch.stack([g[a].to(torch.float64), (a + off).to(torch.float64)]).to(dev))
    host = torch.stack(rows).cpu().numpy()
    best = host[:, 0].max()
    k = int(host[host[:, 0] >= best, 1].min())
    return k, float(best)


def _owner(k: int, offsets: list) -> int:
    """Index of the group holding global id ``k``."""
    return max(j for j, off in enumerate(offsets) if off <= k)


def _masks(sizes: list, offsets: list, devices: list, n_features: int) -> list:
    """Per-group selected-masks, padded ids (``>= n_features``) set from the
    start: they never win the argmax."""
    return [
        torch.arange(off, off + s, device=d) >= n_features
        for s, off, d in zip(sizes, offsets, devices)
    ]


def _greedy(rels: list, num_select, crit: Criterion, incremental: bool, terms_of,
            offsets=(0,), n_features=None):
    """The greedy loop every in-memory engine shares, over feature groups.

    ``rels[j]`` is group ``j``'s relevance slice on its device, holding
    global ids ``offsets[j]...``; one device is one group.  ``terms_of(k)``
    -> every group's redundancy terms against feature ``k``.  The fold runs
    per group on its own slice.  Returns ``(selected int32, gains float32)``
    on the first group's device.
    """
    devs = [r.device for r in rels]
    sizes = [r.shape[0] for r in rels]
    n_features = sum(sizes) if n_features is None else n_features
    masks = _masks(sizes, offsets, devs, n_features)
    gains = torch.zeros((num_select,), dtype=torch.float32, device=devs[0])
    selected: list = []
    fold = crit.needs_redundancy

    def fresh():
        return [crit.init_state(s, d) for s, d in zip(sizes, devs)]

    states = fresh() if incremental and fold else None
    for l in range(num_select):
        if not fold:
            cs = fresh()
        elif incremental:
            cs = states
        else:
            cs = fresh()
            for j, kj in enumerate(selected):
                cs = [crit.update(c, t, j) for c, t in zip(cs, terms_of(kj))]
        gs = [torch.where(m, _NEG_INF, crit.objective(r, c, l))
              for r, c, m in zip(rels, cs, masks)]
        k, best = _distributed_argmax(gs, list(offsets))
        j = _owner(k, offsets)
        masks[j][k - offsets[j]] = True
        gains[l] = best
        selected.append(k)
        if incremental and fold and l + 1 < num_select:
            states = [crit.update(s, t, l) for s, t in zip(states, terms_of(k))]
    return torch.tensor(selected, dtype=torch.int32, device=devs[0]), gains


def _custom_greedy(X_parts: list, y_parts: list, offsets: list, n_features: int,
                   num_select, score: CustomScore, fetch_row):
    """The paper's recompute loop for a CustomScore, over feature groups:
    every pick scores each group's candidates with ``full_score`` against
    the class and the float32 rows picked so far (kept on every group's
    device; ``fetch_row(k)`` reads row ``k`` from its owner).  Returns
    ``(selected, gains, relevance)`` with a NaN relevance (a custom score
    has no relevance/redundancy split)."""
    m = X_parts[0].shape[1]
    devs = [x.device for x in X_parts]
    sel_rows = [torch.zeros((num_select, m), dtype=torch.float32, device=d) for d in devs]
    masks = _masks([x.shape[0] for x in X_parts], offsets, devs, n_features)
    gains = torch.zeros((num_select,), dtype=torch.float32, device=devs[0])
    selected: list = []
    for l in range(num_select):
        gs = [torch.where(mk, _NEG_INF, score.full_score(x, yv, sr, l))
              for x, yv, sr, mk in zip(X_parts, y_parts, sel_rows, masks)]
        k, best = _distributed_argmax(gs, offsets)
        j = _owner(k, offsets)
        masks[j][k - offsets[j]] = True
        gains[l] = best
        selected.append(k)
        row = fetch_row(k).to(torch.float32)
        for sr in sel_rows:
            sr[l] = row.to(sr.device)
    rel = torch.full((n_features,), float("nan"), dtype=torch.float32, device=devs[0])
    return torch.tensor(selected, dtype=torch.int32, device=devs[0]), gains, rel


# ---------------------------------------------------------------------------
# shard placement
# ---------------------------------------------------------------------------

def _oor_fill(dtype: torch.dtype, num_values: int):
    """A value of ``dtype`` outside ``[0, num_values)`` — padded observations
    carry it and count nothing (the JAX engines' out-of-range category) —
    or None where the dtype holds none (uint8 at 256 values)."""
    if dtype.is_floating_point or torch.iinfo(dtype).min < 0:
        return -1
    top = torch.iinfo(dtype).max
    return top if top >= num_values else None


def _obs_shards(x: torch.Tensor, extent: int, num_values: int) -> list:
    """``x`` split over ``extent`` observation shards (axis 0), padded rows
    out of range; a dtype with no out-of-range value widens to int32."""
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    fill = _oor_fill(x.dtype, num_values)
    if fill is None:
        x, fill = x.to(torch.int32), -1
    w = -(-x.shape[0] // extent)
    return [shard_window(x, 0, i, w, fill) for i in range(extent)]


def _mesh_grid(mesh, obs_axes, feat_axes, device) -> list:
    """The (observation shard, feature shard) device grid of ``mesh`` (None
    without one).  The mesh's positions must be of the kind of ``device``,
    where the data lies: no shard leaves the card for the CPU, or the
    reverse."""
    if mesh is None:
        return None
    check_mesh_kind(mesh, device)
    return grid_devices(mesh, axes_tuple(obs_axes), axes_tuple(feat_axes))


def _feature_groups(X_rows, y, grid, fill=0):
    """Feature-major ``X_rows`` split into row shards ``[(rows_j, y_j)]`` on
    the feature axis of ``grid`` (its first observation row; the class is
    replicated, the paper's broadcast ``v_class``), padded rows ``fill``;
    with their global id offsets."""
    devs = grid[0] if grid is not None else [X_rows.device]
    w = -(-X_rows.shape[0] // len(devs))
    parts = [(shard_window(X_rows, 0, j, w, fill).to(d), y.to(d)) for j, d in enumerate(devs)]
    return parts, [j * w for j in range(len(devs))]


def _feature_major(X_rows, y, num_select, score, crit, incremental, grid=None,
                   n_features=None):
    """The reference and alternative engines: feature rows in groups (one
    on one device), any score.  Returns ``(selected, gains, relevance)``."""
    _check_custom_criterion(score, crit)
    check_conditional_support(score, crit)
    n_features = X_rows.shape[0] if n_features is None else int(n_features)
    parts, offsets = _feature_groups(X_rows, y, grid)
    feature_rows = getattr(score, "feature_rows", None)
    if grid is not None and feature_rows is not None:
        # One layout copy a shard (the one-device engine takes it per fit).
        parts = [(feature_rows(x), yv) for x, yv in parts]

    def fetch_row(k):
        j = _owner(k, offsets)
        return parts[j][0][k - offsets[j]]

    if isinstance(score, CustomScore):
        return _custom_greedy([x for x, _ in parts], [yv for _, yv in parts], offsets,
                              n_features, num_select, score, fetch_row)
    cond = crit.needs_redundancy and crit.needs_conditional_redundancy

    def terms_of(k):
        row = fetch_row(k)
        return [score.redundancy_terms(x, row.to(x.device), yv, conditional=cond)
                for x, yv in parts]

    rels = [score.relevance(x, yv) for x, yv in parts]
    sel, gains = _greedy(rels, num_select, crit, incremental, terms_of, offsets, n_features)
    rel = torch.cat([r.to(rels[0].device) for r in rels])[:n_features]
    return sel, gains, rel.to(torch.float32)


def _tiled_counts(X, y, num_select, score: MIScore, crit, incremental, grid=None,
                  n_features=None):
    """The conventional and grid engines: (observations × features) tiles,
    one count a tile a pass, summed over the observation shards of each
    feature group, then MI once a group.

    Without a grid this is one tile: the paper's conventional job on one
    device.  A conditional criterion fuses the class into each tile's
    target locally (its rows of the class), so the 3-way counts ride the
    same single sum as the marginal ones.
    """
    v, c = score.num_values, score.num_classes
    if grid is None:
        grid, tiles, ys, offsets = [[X.device]], [[X]], [[y]], [0]
        n_loc = X.shape[1]
    else:
        po, pf = len(grid), len(grid[0])
        n_loc = -(-X.shape[1] // pf)
        rows, yrows = _obs_shards(X, po, v), _obs_shards(y, po, c)
        tiles = [[shard_window(rows[i], 1, j, n_loc, 0).to(grid[i][j]) for j in range(pf)]
                 for i in range(po)]
        ys = [[yrows[i].to(grid[i][j]) for j in range(pf)] for i in range(po)]
        offsets = [j * n_loc for j in range(pf)]
    n_features = X.shape[1] if n_features is None else int(n_features)
    heads = grid[0]  # each feature group's sum lands on its first position

    def counts_vs(targets, vy) -> list:
        """Per feature group: the tiles' counts summed over observation
        shards (``targets[i][j]``: tile (i, j)'s target)."""
        return [psum([score.tables(tiles[i][j], targets[i][j], vy)
                      for i in range(len(tiles))], heads[j])
                for j in range(len(heads))]

    def terms_of(k):
        j0 = _owner(k, offsets)
        cols = [tiles[i][j0][:, k - offsets[j0]] for i in range(len(tiles))]
        targets = [[col.to(d) for d in row] for col, row in zip(cols, grid)]
        if not crit.needs_conditional_redundancy:
            return [dict(marginal=score.mi(cnt), conditional=None)
                    for cnt in counts_vs(targets, v)]
        fused = [[contingency.fuse_targets(t, yv, v, c) for t, yv in zip(trow, yrow)]
                 for trow, yrow in zip(targets, ys)]
        return [score.terms_from_conditional(cnt.reshape(n_loc, v, v, c))
                for cnt in counts_vs(fused, v * c)]

    rels = [score.mi(cnt) for cnt in counts_vs(ys, c)]
    sel, gains = _greedy(rels, num_select, crit, incremental, terms_of, offsets, n_features)
    rel = torch.cat([r.to(rels[0].device) for r in rels])[:n_features]
    return sel, gains, rel


def _check_mi_only(score, encoding: str) -> None:
    if not isinstance(score, MIScore):
        raise ValueError(
            f"{encoding} encoding works with discrete MI only (paper §IV.B); "
            "use the alternative encoding for other scores"
        )


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
# conventional encoding: observations as rows (sharded), contingency counts
# ---------------------------------------------------------------------------

def mrmr_conventional(
    X: torch.Tensor,  # (M, N) conventional layout
    y: torch.Tensor,  # (M,)
    num_select: int,
    score: MIScore,
    *,
    mesh=None,
    obs_axes=("data",),
    incremental: bool = True,
    criterion: Criterion | str = "mid",
) -> MRMRResult:
    """The paper's conventional-encoding job.

    Every scoring pass is one contingency count of all N features against
    one target column — the contingency kernel on the card (exact int32,
    no one-hot), the blocked one-hot count with ``use_kernel=False``.  On a
    ``mesh`` the observations shard over ``obs_axes`` (padded rows out of
    range, counting nothing): one count a shard a pass on its device, the
    shards' tables summed on the first position (the MapReduce reduce),
    then one MI launch.
    """
    _check_mi_only(score, "conventional")
    crit = resolve_criterion(criterion)
    grid = _mesh_grid(mesh, obs_axes, (), X.device)
    sel, gains, rel = _tiled_counts(X, y, num_select, score, crit, incremental, grid)
    return MRMRResult(sel, gains, relevance=rel, criterion=crit.name,
                      engine="conventional")


# ---------------------------------------------------------------------------
# alternative encoding: features as rows (sharded), any score
# ---------------------------------------------------------------------------

def mrmr_alternative(
    X_rows: torch.Tensor,  # (N, M) alternative layout (rows = features)
    y: torch.Tensor,
    num_select: int,
    score: ScoreFn,
    *,
    mesh=None,
    feat_axes=("model",),
    incremental: bool = True,
    n_features: int | None = None,
    criterion: Criterion | str = "mid",
) -> MRMRResult:
    """The paper's alternative-encoding job: row-per-feature scoring
    against the broadcast class and selected rows.  ``X_rows`` may be a
    transposed view of a conventional matrix: the kernel reads it in
    place.  On a ``mesh`` the feature rows shard over ``feat_axes`` (padded
    to equal shards; ids ``>= n_features`` never picked): each shard scores
    its own rows on its device, the argmax is distributed, and the picked
    row goes from its owner to every shard."""
    crit = resolve_criterion(criterion)
    grid = _mesh_grid(mesh, (), feat_axes, X_rows.device)
    sel, gains, rel = _feature_major(X_rows, y, num_select, score, crit, incremental,
                                     grid, n_features)
    return MRMRResult(sel, gains, relevance=rel, criterion=crit.name,
                      engine="alternative")


# ---------------------------------------------------------------------------
# grid encoding (beyond the paper): observations AND features sharded
# ---------------------------------------------------------------------------

def mrmr_grid(
    X: torch.Tensor,  # (M, N) conventional layout, sharded both ways
    y: torch.Tensor,
    num_select: int,
    score: MIScore,
    *,
    mesh,
    obs_axes=("data",),
    feat_axes=("model",),
    incremental: bool = True,
    n_features: int | None = None,
    criterion: Criterion | str = "mid",
) -> MRMRResult:
    """2-D sharded mRMR: (observation × feature) tiles on ``mesh``, counts
    summed over ``obs_axes``, the argmax over ``feat_axes``."""
    _check_mi_only(score, "grid")
    if mesh is None:
        raise ValueError("grid encoding requires a mesh")
    crit = resolve_criterion(criterion)
    grid = _mesh_grid(mesh, obs_axes, feat_axes, X.device)
    sel, gains, rel = _tiled_counts(X, y, num_select, score, crit, incremental, grid,
                                    n_features)
    return MRMRResult(sel, gains, relevance=rel, criterion=crit.name, engine="grid")


__all__ = [
    "MRMRResult",
    "check_conditional_support",
    "mrmr_alternative",
    "mrmr_conventional",
    "mrmr_grid",
    "mrmr_reference",
]
