"""Streaming discretisation — mergeable quantile sketches + binned sources.

MI scoring needs discrete inputs, but the paper's target traffic (and most
real numeric-tabular data) is continuous.  This module is the front stage
that bridges the two at streaming scale, the same shape as Spark ITFS's
mandatory distributed-discretisation step and sklearn's histogram-GBDT
``_BinMapper`` (subsample -> quantile -> map), but built on this repo's
block protocol so it never materialises the dataset:

1. :class:`QuantileSketch` — a per-feature KLL-style sketch of bounded
   memory: levelled buffers of capacity ``k`` where a full buffer sorts,
   keeps every other element at doubled weight and promotes it one level
   up.  ``update`` ingests ``(B, N)`` observation-blocks (all features
   sketched at once, vectorised); ``merge`` combines sketches built on
   different blocks or shards, so the one cheap stats pass MapReduces the
   same way the scoring passes do.  Ingestion compacts at exact capacity
   boundaries, which makes the sketch a pure function of the row stream —
   identical for every ``block_obs``, like every other source-derived
   quantity in this repo.
2. :class:`QuantileBinner` — ``fit(source)`` runs that one pass (also
   validating the target holds discrete class labels) and cuts
   ``bins - 1`` interior edges at equal-frequency quantiles;
   ``transform`` maps floats to int codes in ``[0, bins)`` via
   ``searchsorted(side="right")``.
3. :class:`BinnedSource` — any float :class:`~repro_torch.data.sources.
   DataSource` wrapped to yield int codes on the fly inside
   ``iter_blocks``, making it consumable by every discrete engine.  Its
   ``fingerprint()`` derives from the base source's fingerprint × the bin
   config (never the fitted edges — those are a pure function of both),
   so the selection service's result cache distinguishes ``bins=16`` from
   ``bins=64`` and binned from pre-discretised data for free.  The binner
   fit is lazy and memoised across instances by that fingerprint, so a
   fresh wrapper over already-sketched content costs zero I/O.

Everything here is numpy-only, and a copy of the JAX package's
``repro.data.binning`` with the same arithmetic, so fitted edges are
bitwise those of the JAX binner for the same data and configuration.  The
device half — the bin-code kernel (:mod:`repro_torch.kernels.binning`) —
is wired up by :mod:`repro_torch.core.streaming`, which encodes each raw
float block on the card ahead of the contingency count whenever a
:class:`BinnedSource` streams through an MI fit, and by the selector's
in-memory binned fit, which encodes the whole matrix on the card once.

    >>> from repro_torch.data.binning import BinnedSource
    >>> src = BinnedSource(NpySource("X.npy", "y.npy"), bins=32)
    >>> MRMRSelector(num_select=10).fit(src)        # or just bins=32 on
    ...                                             # the selector
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Iterator

import numpy as np

from repro_torch.data.sources import Block, DataSource, SourceStats

# Fitted-binner memo, keyed by the BinnedSource fingerprint (base × bin
# config): the selection service builds a fresh wrapper per request, and
# re-running the sketch pass on already-sketched content would cost a full
# pass of I/O each time.  Bounded LRU, same shape as sources._STATS_MEMO.
_BINNER_MEMO: OrderedDict = OrderedDict()
_BINNER_MEMO_CAP = 64
_BINNER_LOCK = threading.Lock()


def clear_binner_memo() -> None:
    """Drop every memoised fitted binner (tests / changed files)."""
    with _BINNER_LOCK:
        _BINNER_MEMO.clear()


def _as_class_labels(y: np.ndarray) -> np.ndarray:
    """Validate + cast a target block to int32 class labels.

    ``bins=`` discretises *features* only: a float target must already
    hold integral class labels (CSV parsers commonly emit ``1.0``); a
    genuinely continuous target has no MI class axis to count against.
    """
    y = np.asarray(y)
    if np.issubdtype(y.dtype, np.integer) or y.dtype == np.bool_:
        yi = y.astype(np.int32)
    else:
        yi = np.floor(y).astype(np.int64)
        if not np.array_equal(yi, y):
            raise ValueError(
                "bins= discretises features only, but the target holds "
                "non-integral values: MI needs discrete class labels "
                "(remap / round the target to 0..K-1 before fitting)"
            )
        yi = yi.astype(np.int32)
    if yi.size and int(yi.min()) < 0:
        raise ValueError(
            "negative class labels in target: one-hot contingency counts "
            "drop them silently; remap classes to 0..K-1 before fitting"
        )
    return yi


class QuantileSketch:
    """Mergeable per-feature quantile sketch (KLL-style, numpy-only).

    Level ``h`` holds at most ``k`` values per feature, each standing for
    ``2**h`` observations.  A full level sorts per-feature, keeps every
    other element (per-feature random parity, deterministic in ``seed``
    and the compaction index) and promotes the survivors one level up at
    doubled weight — total memory is ``O(k · log(n/k))`` values per
    feature regardless of stream length, with rank error ``O(log(n/k)/k)``.

    Ingestion fills level 0 to *exactly* ``k`` before each compaction, so
    the sketch state is a pure function of the row stream — the same
    block-size independence every ``DataSource`` guarantees.
    """

    def __init__(self, num_features: int, k: int = 512, seed: int = 0):
        if num_features < 1:
            raise ValueError(f"num_features must be >= 1, got {num_features}")
        if k < 8 or k % 2:
            raise ValueError(f"sketch capacity k must be even and >= 8, got {k}")
        self.num_features = int(num_features)
        self.k = int(k)
        self.seed = int(seed)
        self.count = 0          # total (weighted) rows ingested
        self._bufs: list = []   # level h: (k, num_features) float32
        self._fill: list = []   # rows used per level
        self._ncompact: list = []  # compactions per level (rng stream key)

    def _ensure_level(self, h: int) -> None:
        while len(self._bufs) <= h:
            self._bufs.append(
                np.empty((self.k, self.num_features), np.float32)
            )
            self._fill.append(0)
            self._ncompact.append(0)

    def _compact(self, h: int) -> None:
        """Sort a FULL level, promote every other element at weight 2x."""
        srt = np.sort(self._bufs[h], axis=0)  # per-feature (column) sort
        rng = np.random.default_rng((self.seed, h, self._ncompact[h]))
        self._ncompact[h] += 1
        # Independent parity per feature: unbiased survivor choice without
        # correlating the error across columns.
        off = rng.integers(0, 2, size=self.num_features)
        rows = off[None, :] + 2 * np.arange(self.k // 2)[:, None]
        survivors = np.take_along_axis(srt, rows, axis=0)
        self._fill[h] = 0
        self._ingest_rows(h + 1, survivors)

    def _ingest_rows(self, h: int, rows: np.ndarray) -> None:
        """Append rows to level ``h``, compacting at exact capacity
        boundaries (the block-size-independence invariant)."""
        self._ensure_level(h)
        pos, total = 0, rows.shape[0]
        while pos < total:
            take = min(self.k - self._fill[h], total - pos)
            buf, fill = self._bufs[h], self._fill[h]
            buf[fill : fill + take] = rows[pos : pos + take]
            self._fill[h] += take
            pos += take
            if self._fill[h] == self.k:
                self._compact(h)

    def update(self, X_block: np.ndarray) -> "QuantileSketch":
        """Ingest one ``(B, num_features)`` observation-block."""
        X = np.asarray(X_block)
        if X.ndim != 2 or X.shape[1] != self.num_features:
            raise ValueError(
                f"block shape {X.shape} does not match "
                f"num_features={self.num_features}"
            )
        X = X.astype(np.float32, copy=False)
        if not np.isfinite(X).all():
            raise ValueError(
                "non-finite feature values (nan/inf): quantile sketches "
                "have no ordering for them; clean or impute first"
            )
        self._ingest_rows(0, X)
        self.count += X.shape[0]
        return self

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold another sketch (same geometry) into this one — the reduce
        step when shards sketch their partitions independently."""
        if (
            other.num_features != self.num_features
            or other.k != self.k
        ):
            raise ValueError(
                f"cannot merge sketches of different geometry: "
                f"({self.num_features}, k={self.k}) vs "
                f"({other.num_features}, k={other.k})"
            )
        for h in range(len(other._bufs)):
            fill = other._fill[h]
            if fill:
                self._ingest_rows(h, other._bufs[h][:fill])
        self.count += other.count
        return self

    def quantiles(self, qs) -> np.ndarray:
        """``(num_features, len(qs))`` approximate quantile values.

        Rank semantics: the returned value for quantile ``q`` is the
        smallest stored value whose cumulative (weighted) rank reaches
        ``q * count``.
        """
        qs = np.atleast_1d(np.asarray(qs, np.float64))
        if self.count == 0:
            raise ValueError("empty sketch: update() with data first")
        vals, weights = [], []
        for h in range(len(self._bufs)):
            fill = self._fill[h]
            if fill:
                vals.append(self._bufs[h][:fill])
                weights.append(np.full((fill,), 1 << h, np.int64))
        v = np.concatenate(vals, axis=0)        # (T, n)
        w = np.concatenate(weights)             # (T,)
        order = np.argsort(v, axis=0, kind="stable")
        sv = np.take_along_axis(v, order, axis=0)
        cum = np.cumsum(w[order], axis=0)       # (T, n); cum[-1] == count
        targets = np.clip(qs, 0.0, 1.0) * self.count
        out = np.empty((self.num_features, len(qs)), np.float32)
        last = sv.shape[0] - 1
        for j in range(self.num_features):
            idx = np.searchsorted(cum[:, j], targets, side="left")
            out[j] = sv[np.minimum(idx, last), j]
        return out

    @property
    def levels(self) -> int:
        return len(self._bufs)


@dataclasses.dataclass
class QuantileBinner:
    """Equal-frequency discretiser: one sketch pass -> ``bins - 1`` edges.

    ``fit(source)`` streams the source once through a
    :class:`QuantileSketch` (validating the target is discrete on the
    same pass, so ``BinnedSource.stats()`` costs no extra I/O), then cuts
    interior edges at quantiles ``i / bins``.  ``transform`` encodes a
    float block to int32 codes in ``[0, bins)`` — ``searchsorted(edges,
    x, side="right")``, ties to the upper bin.  Edges and comparisons are
    float32, matching ``repro_torch.kernels.binning`` bit-for-bit so host and
    device encodes of the same block always agree.

    Duplicate edges (heavy ties) simply leave some bins empty — harmless
    for contingency counting.
    """

    bins: int
    sketch_k: int = 512
    seed: int = 0

    # fitted: edges_ (num_features, bins - 1) float32, num_classes_,
    # n_obs_, sketch_

    def __post_init__(self):
        if self.bins < 2:
            raise ValueError(f"bins must be >= 2, got {self.bins}")

    @property
    def fitted(self) -> bool:
        return getattr(self, "edges_", None) is not None

    def fit(self, source: DataSource, block_obs: int = 65536) -> "QuantileBinner":
        """One streaming pass: sketch every feature, validate the target."""
        sketch = QuantileSketch(
            source.num_features, k=self.sketch_k, seed=self.seed
        )
        y_max, n_obs = 0, 0
        for X_blk, y_blk in source.iter_blocks(block_obs):
            labels = _as_class_labels(y_blk)
            sketch.update(X_blk)
            if labels.size:
                y_max = max(y_max, int(labels.max()))
            n_obs += X_blk.shape[0]
        qs = np.arange(1, self.bins) / self.bins
        # maximum.accumulate guards monotonicity against f32 rounding of
        # near-equal quantiles; normally a no-op.
        self.edges_ = np.maximum.accumulate(sketch.quantiles(qs), axis=1)
        self.num_classes_ = y_max + 1
        self.n_obs_ = n_obs
        self.sketch_ = sketch
        return self

    def transform(self, X_block: np.ndarray) -> np.ndarray:
        """(B, N) floats -> (B, N) int32 codes in ``[0, bins)``."""
        if not self.fitted:
            raise RuntimeError("fit() the binner before transform()")
        X = np.asarray(X_block, np.float32)
        out = np.empty(X.shape, np.int32)
        for j in range(X.shape[1]):
            out[:, j] = np.searchsorted(self.edges_[j], X[:, j], side="right")
        return out

    def encode_column(self, j: int, col: np.ndarray) -> np.ndarray:
        """Encode one feature column (the streaming engine's redundancy
        target) without touching the rest of the block."""
        return np.searchsorted(
            self.edges_[j], np.asarray(col, np.float32), side="right"
        ).astype(np.int32)


class BinnedSource(DataSource):
    """A float source wearing int codes: on-the-fly quantile discretisation.

    Wraps any :class:`~repro_torch.data.sources.DataSource` whose blocks hold
    continuous features; ``iter_blocks`` yields the binner's int32 codes
    (and the validated int class labels), so every discrete engine —
    in-memory or streaming — consumes it unchanged.  The binner fit (one
    sketch pass over the base) is lazy: constructing the wrapper is free,
    and the fitted binner is memoised across instances by fingerprint.

    ``fingerprint()`` = base fingerprint × ``(bins, sketch_k, seed)``:
    distinct bin configs never collide in the selection service's result
    cache, and the identity never needs the edges (they are a pure
    function of base content + config).

    ``stats()`` is I/O-free once the binner is fitted: codes are discrete
    with exactly ``bins`` values, and the class count was recorded on the
    sketch pass.
    """

    def __init__(
        self,
        base: DataSource,
        bins: int | None = None,
        *,
        binner: QuantileBinner | None = None,
        sketch_k: int = 512,
        seed: int = 0,
        fit_block_obs: int = 65536,
    ):
        if not isinstance(base, DataSource):
            raise TypeError(
                f"BinnedSource wraps a DataSource, got {type(base).__name__}"
            )
        if isinstance(base, BinnedSource):
            raise ValueError("base source is already binned")
        if (bins is None) == (binner is None):
            raise ValueError("pass exactly one of bins= or binner=")
        self.base = base
        self._binner = (
            binner
            if binner is not None
            else QuantileBinner(int(bins), sketch_k=sketch_k, seed=seed)
        )
        self.bins = self._binner.bins
        self._fit_block_obs = int(fit_block_obs)

    @property
    def num_obs(self) -> int:
        return self.base.num_obs

    @property
    def num_features(self) -> int:
        return self.base.num_features

    @property
    def binner(self) -> QuantileBinner:
        """The fitted binner — running the sketch pass on first access,
        or reusing a memoised fit for this fingerprint (zero I/O)."""
        if self._binner.fitted:
            return self._binner
        fp = self.fingerprint()
        with _BINNER_LOCK:
            memo = _BINNER_MEMO.get(fp)
            if memo is not None:
                _BINNER_MEMO.move_to_end(fp)
        if memo is not None:
            self._binner = memo
            return memo
        self._binner.fit(self.base, block_obs=self._fit_block_obs)
        with _BINNER_LOCK:
            _BINNER_MEMO[fp] = self._binner
            _BINNER_MEMO.move_to_end(fp)
            while len(_BINNER_MEMO) > _BINNER_MEMO_CAP:
                _BINNER_MEMO.popitem(last=False)
        return self._binner

    def iter_blocks(self, block_obs: int) -> Iterator[Block]:
        binner = self.binner
        for X_blk, y_blk in self.base.iter_blocks(block_obs):
            yield binner.transform(X_blk), _as_class_labels(y_blk)

    def iter_shard_blocks(
        self,
        block_obs: int,
        obs_range: "tuple | None" = None,
        col_range: "tuple | None" = None,
    ) -> Iterator[Block]:
        # Shard the RAW window through the base (its direct-slicing override
        # stays in effect), then encode only the window's columns with the
        # GLOBAL edges: the binner fit is a pure function of the whole base
        # stream, so every host cuts identical edges and a shard's codes
        # equal a full-source encode bit for bit.
        binner = self.binner
        clo, _ = col_range if col_range is not None else (0, self.num_features)
        for X_blk, y_blk in self.base.iter_shard_blocks(
            block_obs, obs_range, col_range
        ):
            codes = np.empty(X_blk.shape, np.int32)
            for idx in range(X_blk.shape[1]):
                codes[:, idx] = binner.encode_column(clo + idx, X_blk[:, idx])
            yield codes, _as_class_labels(y_blk)

    @property
    def feature_dtype(self) -> np.dtype:
        return np.dtype(np.int32)  # transform() emits int32 codes

    def stats(self, block_obs: int = 65536) -> SourceStats:
        # No scan needed: codes are [0, bins) by construction and the
        # class count was recorded during the sketch pass.
        return SourceStats(
            discrete=True,
            num_values=self.bins,
            num_classes=self.binner.num_classes_,
        )

    def _fingerprint_update(self, h) -> None:
        h.update(b"binned|")
        h.update(self.base.fingerprint().encode())
        h.update(
            repr(
                (self._binner.bins, self._binner.sketch_k, self._binner.seed)
            ).encode()
        )


def fit_binned(
    source: DataSource,
    bins: int,
    *,
    block_obs: int = 65536,
    sketch_k: int = 512,
    seed: int = 0,
) -> BinnedSource:
    """Wrap + eagerly fit: ``BinnedSource`` with the sketch pass done."""
    binned = BinnedSource(
        source, bins, sketch_k=sketch_k, seed=seed, fit_block_obs=block_obs
    )
    binned.binner  # force the (memoised) sketch pass now
    return binned


__all__ = [
    "BinnedSource",
    "QuantileBinner",
    "QuantileSketch",
    "clear_binner_memo",
    "fit_binned",
]
