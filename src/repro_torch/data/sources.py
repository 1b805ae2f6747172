"""Out-of-core dataset ingestion — the ``DataSource`` protocol (numpy only).

A source knows its global geometry (``num_obs`` × ``num_features``) and
yields observation-blocks — host-side numpy arrays ``(X_block (B, N),
y_block (B,))`` in conventional orientation with ``B <= block_obs`` — whose
concatenation is the full dataset, in a deterministic order that does not
depend on the requested block size.  The streaming engine
(:mod:`repro_torch.core.streaming`) consumes blocks and accumulates
per-score sufficient statistics on the device, so peak device memory is
bounded by the block size, never by ``num_obs``.

Sources here: in-memory arrays (:class:`ArraySource`), memmapped ``.npy``
files (:class:`NpySource`), CSV files (:class:`CSVSource`), Parquet files
and in-memory Arrow tables (:class:`ParquetSource` / :class:`ArrowSource`,
which need pyarrow, imported only when one is built) and the paper's
synthetic generator (:class:`CorralSource`); :class:`ShardSource` is one
host's window of any of them (``iter_shard_blocks``, the multi-host map
step).  Blocks are bitwise those of
the JAX package's sources (``repro.data.sources``) for the same data and
any ``block_obs``, and so are the fingerprints.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import os
import threading
from collections import OrderedDict
from typing import Iterator, Tuple

import numpy as np

Block = Tuple[np.ndarray, np.ndarray]

# Internal generation granularity of synthetic sources: fixed, so the
# emitted dataset is identical for every requested block_obs.
_GEN_CHUNK = 8192

# Cross-instance stats memo, keyed by source fingerprint: a fresh source
# on the same file reuses the scan instead of paying a pass of I/O.
_STATS_MEMO: OrderedDict = OrderedDict()
_STATS_MEMO_CAP = 256
_STATS_LOCK = threading.Lock()


def clear_stats_memo() -> None:
    """Drop every memoised ``stats()`` scan (tests / changed files)."""
    with _STATS_LOCK:
        _STATS_MEMO.clear()


@dataclasses.dataclass(frozen=True)
class SourceStats:
    """Streaming-scan metadata used to auto-resolve a score function."""

    discrete: bool      # X and y both integral -> exact-MI territory
    num_values: int     # d_v: 1 + max feature category (0 if continuous)
    num_classes: int    # d_c: 1 + max class label (0 if continuous)


def _rechunked(chunks: Iterator[Block], block_obs: int) -> Iterator[Block]:
    """Re-slice an (X, y) chunk stream into blocks of exactly ``block_obs``
    rows (the final block may be ragged)."""
    pend_x, pend_y, have = [], [], 0
    for X, y in chunks:
        pend_x.append(X)
        pend_y.append(y)
        have += X.shape[0]
        if have >= block_obs:
            Xc, yc = np.concatenate(pend_x), np.concatenate(pend_y)
            lo = 0
            while have - lo >= block_obs:
                yield Xc[lo : lo + block_obs], yc[lo : lo + block_obs]
                lo += block_obs
            pend_x, pend_y = [Xc[lo:]], [yc[lo:]]
            have -= lo
    if have:
        yield np.concatenate(pend_x), np.concatenate(pend_y)


class DataSource:
    """Base class: geometry + deterministic observation-block iteration."""

    @property
    def num_obs(self) -> int:
        raise NotImplementedError

    @property
    def num_features(self) -> int:
        raise NotImplementedError

    def iter_blocks(self, block_obs: int) -> Iterator[Block]:
        """Yield ``(X (B, N), y (B,))`` numpy blocks, ``B <= block_obs``,
        concatenating to the full dataset in a block-size-independent order."""
        raise NotImplementedError

    @property
    def feature_dtype(self) -> "np.dtype | None":
        """Static dtype of the feature blocks, when knowable without I/O
        (``None`` otherwise): a floating hint means continuous."""
        return None

    def fingerprint(self) -> str:
        """Content address of this source (hex sha256, memoised).

        File-backed sources hash ``(path, size, mtime_ns)``; synthetic
        sources their generating parameters; the base implementation hashes
        the block stream (one pass; in-memory sources only).
        """
        cached = getattr(self, "_fingerprint", None)
        if cached is not None:
            return cached
        h = hashlib.sha256()
        h.update(
            f"{type(self).__name__}:{self.num_obs}x{self.num_features}:".encode()
        )
        self._fingerprint_update(h)
        fp = h.hexdigest()
        object.__setattr__(self, "_fingerprint", fp)  # frozen-dataclass safe
        return fp

    def _fingerprint_update(self, h) -> None:
        """Subclass hook: feed identity into the hash.  Default: full
        content (dtypes + bytes of every block)."""
        for X, y in self.iter_blocks(65536):
            h.update(str(X.dtype).encode())
            h.update(np.ascontiguousarray(X).tobytes())
            h.update(str(y.dtype).encode())
            h.update(np.ascontiguousarray(y).tobytes())

    def iter_shard_blocks(
        self,
        block_obs: int,
        obs_range: "tuple | None" = None,
        col_range: "tuple | None" = None,
    ) -> Iterator[Block]:
        """Yield blocks covering only ``rows[obs_range] × cols[col_range]``
        — the multi-host map step, where each host walks its own shard.

        The default walks :meth:`iter_blocks` and slices, stopping once past
        the row window (a host holding the first half of a row-ordered file
        never reads the second half); array-backed sources override it with
        direct slicing that touches only the window's bytes.  Blocks are
        re-chunked to exactly ``block_obs`` rows, so shard streams do not
        depend on the producer's chunking.
        """
        olo, ohi = obs_range if obs_range is not None else (0, self.num_obs)
        clo, chi = col_range if col_range is not None else (0, self.num_features)
        whole_cols = (clo, chi) == (0, self.num_features)

        def windowed() -> Iterator[Block]:
            off = 0
            it = self.iter_blocks(block_obs)
            try:
                for X, y in it:
                    n = X.shape[0]
                    if off >= ohi:
                        break
                    lo, hi = max(olo - off, 0), min(ohi - off, n)
                    if lo < hi:
                        Xs = X[lo:hi] if whole_cols else X[lo:hi, clo:chi]
                        yield np.ascontiguousarray(Xs), y[lo:hi]
                    off += n
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()  # release file handles promptly (CSVSource)

        yield from _rechunked(windowed(), block_obs)

    def stats(self, block_obs: int = 65536) -> SourceStats:
        """One streaming pass of metadata (memoised per instance and by
        :meth:`fingerprint`): dtype regime + the ``d_v`` / ``d_c`` counts."""
        cached = getattr(self, "_stats", None)
        if cached is not None:
            return cached
        fp = self.fingerprint()
        with _STATS_LOCK:
            memo = _STATS_MEMO.get(fp)
            if memo is not None:
                _STATS_MEMO.move_to_end(fp)
        if memo is not None:
            object.__setattr__(self, "_stats", memo)
            return memo
        x_max = y_max = 0
        x_min = y_min = 0
        discrete = True
        for X, y in self.iter_blocks(block_obs):
            discrete = discrete and (
                np.issubdtype(X.dtype, np.integer) or X.dtype == np.bool_
            ) and (np.issubdtype(y.dtype, np.integer) or y.dtype == np.bool_)
            if not discrete:
                break  # dtype settles it; don't burn a full pass of I/O
            x_max = max(x_max, int(X.max(initial=0)))
            y_max = max(y_max, int(y.max(initial=0)))
            x_min = min(x_min, int(X.min(initial=0)))
            y_min = min(y_min, int(y.min(initial=0)))
        if discrete and (x_min < 0 or y_min < 0):
            # A negative category counts nothing, so the observation would
            # silently vanish from every contingency table.
            raise ValueError(
                "negative category values in discrete source "
                f"(min feature value {x_min}, min target value {y_min}): "
                "contingency counts drop them silently; remap "
                "categories to 0..K-1 before fitting"
            )
        st = SourceStats(
            discrete=discrete,
            num_values=x_max + 1 if discrete else 0,
            num_classes=y_max + 1 if discrete else 0,
        )
        object.__setattr__(self, "_stats", st)
        with _STATS_LOCK:
            _STATS_MEMO[fp] = st
            _STATS_MEMO.move_to_end(fp)
            while len(_STATS_MEMO) > _STATS_MEMO_CAP:
                _STATS_MEMO.popitem(last=False)
        return st

    def materialize(self, block_obs: int = 65536) -> Block:
        """Concatenate every block — small datasets and tests only."""
        xs, ys = zip(*self.iter_blocks(block_obs))
        return np.concatenate(xs), np.concatenate(ys)

    def to_npy(
        self, x_path: str, y_path: str, block_obs: int = 65536
    ) -> tuple[str, str]:
        """Stream the source into ``.npy`` files (block-wise via memmap, no
        full-dataset host allocation) — ready for :class:`NpySource`."""
        peek = self.iter_blocks(1)
        try:
            first = next(peek)  # dtype peek, one row
        finally:
            close = getattr(peek, "close", None)
            if close is not None:
                close()
        Xm = np.lib.format.open_memmap(
            x_path, mode="w+", dtype=first[0].dtype,
            shape=(self.num_obs, self.num_features),
        )
        ym = np.lib.format.open_memmap(
            y_path, mode="w+", dtype=first[1].dtype, shape=(self.num_obs,)
        )
        lo = 0
        for X, y in self.iter_blocks(block_obs):
            Xm[lo : lo + X.shape[0]] = X
            ym[lo : lo + X.shape[0]] = y
            lo += X.shape[0]
        Xm.flush()
        ym.flush()
        return x_path, y_path


def as_source(X, y=None) -> DataSource:
    """Coerce ``fit`` inputs to a source: pass sources through, wrap arrays."""
    if isinstance(X, DataSource):
        if y is not None:
            raise ValueError("y comes from the DataSource; pass the source alone")
        return X
    if y is None:
        raise ValueError("array inputs need a target: as_source(X, y)")
    return ArraySource(X, y)


class ArraySource(DataSource):
    """In-memory (or memmapped) arrays as a source — the fast-path adapter."""

    def __init__(self, X, y):
        # asanyarray keeps memmaps memmapped (no eager load).
        self.X = np.asanyarray(X)
        self.y = np.asanyarray(y)
        if (
            self.X.ndim != 2
            or self.y.ndim != 1
            or self.y.shape[0] != self.X.shape[0]
        ):
            raise ValueError(f"bad shapes X{self.X.shape} y{self.y.shape}")

    @property
    def num_obs(self) -> int:
        return self.X.shape[0]

    @property
    def num_features(self) -> int:
        return self.X.shape[1]

    @property
    def feature_dtype(self) -> np.dtype:
        return self.X.dtype

    def iter_blocks(self, block_obs: int) -> Iterator[Block]:
        for lo in range(0, self.num_obs, block_obs):
            hi = min(lo + block_obs, self.num_obs)
            # np.array forces a real copy: yielded blocks are contiguous
            # and never pin a memmapped file.
            yield np.array(self.X[lo:hi]), np.array(self.y[lo:hi])

    def iter_shard_blocks(
        self,
        block_obs: int,
        obs_range: "tuple | None" = None,
        col_range: "tuple | None" = None,
    ) -> Iterator[Block]:
        # Direct window slicing: a memmapped host never faults in pages
        # outside its shard (the default walks every leading block).
        olo, ohi = obs_range if obs_range is not None else (0, self.num_obs)
        clo, chi = col_range if col_range is not None else (0, self.num_features)
        for lo in range(olo, ohi, block_obs):
            hi = min(lo + block_obs, ohi)
            yield (
                np.ascontiguousarray(self.X[lo:hi, clo:chi]),
                np.array(self.y[lo:hi]),
            )


class NpySource(ArraySource):
    """Memmapped ``.npy`` feature matrix + target vector, read one
    observation-block at a time."""

    def __init__(self, x_path: str, y_path: str, *, mmap: bool = True):
        mode = "r" if mmap else None
        super().__init__(
            np.load(x_path, mmap_mode=mode), np.load(y_path, mmap_mode=mode)
        )
        self.x_path, self.y_path = x_path, y_path

    def _fingerprint_update(self, h) -> None:
        # (path, size, mtime_ns) instead of content: no pass over the file.
        _stat_fingerprint(h, self.x_path, self.y_path)


class CSVSource(DataSource):
    """Streaming CSV reader: parses ``block_obs`` lines at a time.

    Args:
      path: CSV file; a non-numeric first line is treated as a header.
      target_col: column index of the target (default: last column).
      dtype: feature dtype (use an integer dtype for discrete/MI data).
      target_dtype: target dtype (default: ``dtype``).
      delimiter: field separator.
    """

    def __init__(
        self,
        path: str,
        *,
        target_col: int = -1,
        dtype=np.float32,
        target_dtype=None,
        delimiter: str = ",",
    ):
        self.path = path
        self.target_col = target_col
        self.dtype = np.dtype(dtype)
        self.target_dtype = np.dtype(target_dtype or dtype)
        self.delimiter = delimiter
        with open(path) as f:
            first = f.readline()
        if not first:
            raise ValueError(f"empty CSV {path!r}")
        fields = first.strip().split(delimiter)
        self._has_header = not _all_numeric(fields)
        self._num_cols = len(fields)
        self._num_obs: int | None = None

    @property
    def num_obs(self) -> int:
        if self._num_obs is None:  # one cheap line-count pass, cached
            with open(self.path) as f:
                n = sum(1 for line in f if line.strip())
            self._num_obs = n - int(self._has_header)
        return self._num_obs

    @property
    def num_features(self) -> int:
        return self._num_cols - 1

    @property
    def feature_dtype(self) -> np.dtype:
        return self.dtype

    def _parse(self, lines: list) -> Block:
        tgt = self.target_col % self._num_cols
        keep = [c for c in range(self._num_cols) if c != tgt]
        rows = np.loadtxt(
            io.StringIO("".join(lines)),
            delimiter=self.delimiter,
            ndmin=2,
            dtype=np.float64,
        )
        return rows[:, keep].astype(self.dtype), rows[:, tgt].astype(
            self.target_dtype
        )

    def _fingerprint_update(self, h) -> None:
        # Parse knobs are part of the identity: the same file read with a
        # different target column or dtype is a different dataset.
        _stat_fingerprint(h, self.path)
        h.update(
            repr(
                (self.target_col, str(self.dtype), str(self.target_dtype),
                 self.delimiter)
            ).encode()
        )

    def iter_blocks(self, block_obs: int) -> Iterator[Block]:
        with open(self.path) as f:
            if self._has_header:
                f.readline()
            lines: list = []
            # Count only non-blank lines toward the block, so blank runs of
            # any length never truncate the stream.
            for line in f:
                if not line.strip():
                    continue
                lines.append(line)
                if len(lines) == block_obs:
                    yield self._parse(lines)
                    lines = []
            if lines:
                yield self._parse(lines)


def _pyarrow(what: str):
    """Soft-import pyarrow: columnar sources are optional, and the error
    should say what to install rather than NameError deep in a fit."""
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError:
        raise ImportError(
            f"{what} requires pyarrow; install it (pip install pyarrow) "
            "or convert the data to .npy/.csv for the built-in readers"
        ) from None
    return pa, pq


def _arrow_numpy_dtype(fields) -> np.dtype:
    """Schema -> block dtype: all-integral (incl. bool) columns stream as
    int32 (exact-MI territory), anything else as float32 — the same
    discrete-vs-continuous split :meth:`DataSource.stats` applies."""
    import pyarrow.types as pt

    integral = all(
        pt.is_integer(f.type) or pt.is_boolean(f.type) for f in fields
    )
    return np.dtype(np.int32 if integral else np.float32)


class _ColumnarSource(DataSource):
    """Shared column-wise block extraction for Arrow-layout sources.

    Subclasses provide ``_batches(block_obs)`` — an iterator of
    RecordBatch/Table slices in row order — plus resolved feature/target
    column names and dtypes; this base turns each slice into the
    protocol's ``(X (B, N), y (B,))`` numpy block.
    """

    def _resolve_columns(self, names, target_col):
        if isinstance(target_col, str):
            if target_col not in names:
                raise ValueError(
                    f"target column {target_col!r} not in schema {names}"
                )
            tgt = target_col
        else:
            tgt = names[int(target_col) % len(names)]
        self._tgt_name = tgt
        self._feat_names = [n for n in names if n != tgt]
        if not self._feat_names:
            raise ValueError("schema holds only the target column")

    def _block_of(self, batch) -> Block:
        def col(name):
            idx = batch.schema.get_field_index(name)
            return batch.column(idx).to_numpy(zero_copy_only=False)

        X = np.column_stack(
            [col(n).astype(self.dtype, copy=False) for n in self._feat_names]
        )
        y = col(self._tgt_name).astype(self.target_dtype, copy=False)
        return np.ascontiguousarray(X), np.ascontiguousarray(y)

    @property
    def num_features(self) -> int:
        return len(self._feat_names)

    @property
    def feature_dtype(self) -> np.dtype:
        return self.dtype


class ParquetSource(_ColumnarSource):
    """Streaming Parquet reader (pyarrow) — column-chunked row batches.

    ``pq.ParquetFile.iter_batches`` decodes ``block_obs`` rows at a time
    straight from the file's row groups, so peak host memory is one block
    regardless of file size; row order is file order, independent of the
    requested block size.  Geometry (``num_obs``) comes from the Parquet
    footer metadata — no data pages are read until ``iter_blocks``.

    Args:
      path: ``.parquet`` file.
      target_col: target column name, or index into the schema (default:
        last column).
      dtype / target_dtype: numpy dtypes for the emitted blocks; default
        derives from the schema (all-integral columns -> int32 for exact
        MI, otherwise float32 — pair with ``bins=`` on the selector).

    Composes like every other source: wrap in ``BinnedSource`` for
    on-the-fly quantile discretisation or ``BlockCacheSource`` to spill
    decoded blocks across selection passes.
    """

    def __init__(
        self, path: str, *, target_col=-1, dtype=None, target_dtype=None
    ):
        _, pq = _pyarrow("ParquetSource")
        self.path = path
        self.target_col = target_col
        meta = pq.ParquetFile(path)
        try:
            schema = meta.schema_arrow
            self._resolve_columns(list(schema.names), target_col)
            self._num_obs = int(meta.metadata.num_rows)
            fields = {f.name: f for f in schema}
        finally:
            meta.close()
        self.dtype = (
            np.dtype(dtype)
            if dtype is not None
            else _arrow_numpy_dtype([fields[n] for n in self._feat_names])
        )
        self.target_dtype = (
            np.dtype(target_dtype)
            if target_dtype is not None
            else _arrow_numpy_dtype([fields[self._tgt_name]])
        )

    @property
    def num_obs(self) -> int:
        return self._num_obs

    def _fingerprint_update(self, h) -> None:
        # (path, size, mtime_ns) like NpySource — never a content pass —
        # plus the parse knobs: same file, different target column or
        # dtype is a different dataset.
        _stat_fingerprint(h, self.path)
        h.update(
            repr(
                (self.target_col, str(self.dtype), str(self.target_dtype))
            ).encode()
        )

    def iter_blocks(self, block_obs: int) -> Iterator[Block]:
        _, pq = _pyarrow("ParquetSource")
        pf = pq.ParquetFile(self.path)
        try:
            cols = self._feat_names + [self._tgt_name]
            for batch in pf.iter_batches(batch_size=block_obs, columns=cols):
                yield self._block_of(batch)
        finally:
            pf.close()


class ArrowSource(_ColumnarSource):
    """An in-memory ``pyarrow.Table`` (or RecordBatch) as a source.

    The zero-copy handoff for data already in Arrow memory — a Flight
    fetch, a DuckDB/Polars result — sliced into observation blocks
    without ever round-tripping through a file.
    """

    def __init__(self, table, *, target_col=-1, dtype=None, target_dtype=None):
        pa, _ = _pyarrow("ArrowSource")
        if isinstance(table, pa.RecordBatch):
            table = pa.Table.from_batches([table])
        self.table = table
        self.target_col = target_col
        self._resolve_columns(list(table.schema.names), target_col)
        fields = {f.name: f for f in table.schema}
        self.dtype = (
            np.dtype(dtype)
            if dtype is not None
            else _arrow_numpy_dtype([fields[n] for n in self._feat_names])
        )
        self.target_dtype = (
            np.dtype(target_dtype)
            if target_dtype is not None
            else _arrow_numpy_dtype([fields[self._tgt_name]])
        )

    @property
    def num_obs(self) -> int:
        return int(self.table.num_rows)

    def iter_blocks(self, block_obs: int) -> Iterator[Block]:
        for lo in range(0, self.num_obs, block_obs):
            yield self._block_of(self.table.slice(lo, block_obs))


@dataclasses.dataclass(frozen=True)
class ShardSource(DataSource):
    """A window of another source, presented as a complete source.

    The multi-host engine wraps each host's base source in one of these
    (ranges from :class:`~repro_torch.dist.multihost.HostShardSpec`), so
    every downstream consumer — placer, spill cache, read-ahead — sees an
    ordinary ``num_obs × num_features`` source and streams only the shard's
    bytes.  The fingerprint folds the window into the base identity, so
    different hosts' spill entries for one file never collide.
    """

    base: DataSource
    obs_range: tuple
    col_range: tuple

    def __post_init__(self):
        olo, ohi = self.obs_range
        clo, chi = self.col_range
        if not (0 <= olo < ohi <= self.base.num_obs):
            raise ValueError(
                f"obs_range {self.obs_range} outside 0..{self.base.num_obs}"
            )
        if not (0 <= clo < chi <= self.base.num_features):
            raise ValueError(
                f"col_range {self.col_range} outside "
                f"0..{self.base.num_features}"
            )

    @property
    def num_obs(self) -> int:
        return self.obs_range[1] - self.obs_range[0]

    @property
    def num_features(self) -> int:
        return self.col_range[1] - self.col_range[0]

    @property
    def feature_dtype(self) -> "np.dtype | None":
        return self.base.feature_dtype

    def _fingerprint_update(self, h) -> None:
        h.update(
            f"shard|{self.base.fingerprint()}|"
            f"{self.obs_range}|{self.col_range}".encode()
        )

    def iter_blocks(self, block_obs: int) -> Iterator[Block]:
        yield from self.base.iter_shard_blocks(
            block_obs, self.obs_range, self.col_range
        )

    def iter_shard_blocks(
        self,
        block_obs: int,
        obs_range: "tuple | None" = None,
        col_range: "tuple | None" = None,
    ) -> Iterator[Block]:
        # Compose windows so nested sharding reads the base directly.
        olo, ohi = obs_range if obs_range is not None else (0, self.num_obs)
        clo, chi = col_range if col_range is not None else (0, self.num_features)
        yield from self.base.iter_shard_blocks(
            block_obs,
            (self.obs_range[0] + olo, self.obs_range[0] + ohi),
            (self.col_range[0] + clo, self.col_range[0] + chi),
        )


def _all_numeric(fields) -> bool:
    try:
        [float(v) for v in fields]
        return True
    except ValueError:
        return False


def _stat_fingerprint(h, *paths: str) -> None:
    """Feed ``(abspath, size, mtime_ns)`` of each file into the hash."""
    for p in paths:
        st = os.stat(p)
        h.update(
            f"{os.path.abspath(p)}:{st.st_size}:{st.st_mtime_ns};".encode()
        )


@dataclasses.dataclass(frozen=True)
class CorralSource(DataSource):
    """The paper's §V CorrAL-style generator as a streaming source (Eq. 3).

    Rows are generated in fixed internal chunks, each seeded by
    ``(seed, chunk_index)``, so the dataset is a pure function of
    ``(seed, num_obs, num_cols)`` — identical for every ``block_obs`` and
    never materialised whole.  Columns 0..7 are relevant (Eq. 3), 8
    partially class-correlated (75% agreement), the rest iid noise;
    ``flip_prob`` injects label noise.
    """

    num_rows: int
    num_cols: int
    seed: int = 0
    flip_prob: float = 0.05

    def __post_init__(self):
        if self.num_cols < 9:
            raise ValueError("CorralSource needs at least 9 columns")

    @property
    def num_obs(self) -> int:
        return self.num_rows

    @property
    def num_features(self) -> int:
        return self.num_cols

    @property
    def feature_dtype(self) -> np.dtype:
        return np.dtype(np.int8)

    def _fingerprint_update(self, h) -> None:
        h.update(
            repr(
                (self.num_rows, self.num_cols, self.seed, self.flip_prob)
            ).encode()
        )

    def _chunk(self, ci: int) -> Block:
        rows = min(_GEN_CHUNK, self.num_rows - ci * _GEN_CHUNK)
        rng = np.random.default_rng((self.seed, ci))
        blk = rng.integers(0, 2, size=(rows, self.num_cols), dtype=np.int8)
        x = [blk[:, i].astype(bool) for i in range(8)]
        c = ((x[0] & x[1]) | (x[2] & x[3])) & ((x[4] & x[5]) | (x[6] & x[7]))
        agree = rng.random(rows) < 0.75
        blk[:, 8] = np.where(agree, c, ~c)
        if self.flip_prob > 0:
            flips = rng.random(rows) < self.flip_prob
            c = np.where(flips, ~c, c)
        return blk, c.astype(np.int8)

    def iter_blocks(self, block_obs: int) -> Iterator[Block]:
        nchunks = -(-self.num_rows // _GEN_CHUNK)
        yield from _rechunked(
            (self._chunk(ci) for ci in range(nchunks)), block_obs
        )


# ---------------------------------------------------------------------------
# step-indexed token sources (the LM-pipeline face of the protocol)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SyntheticTokenSource:
    """Infinite step-indexed token stream, pure in ``(seed, step)``.

    ``block(step, lo, hi)`` returns rows [lo, hi) of the global batch at
    ``step``: ``(hi - lo, seq_len + 1)`` int32 tokens with a Zipf-like
    marginal (a squared uniform, skewed to low ids).  A restart at step k
    replays the same stream with no loader state to keep.  Bitwise the JAX
    package's ``SyntheticTokenSource`` (numpy only)."""

    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0

    def block(self, step: int, lo: int, hi: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        u = rng.random((self.global_batch, self.seq_len + 1))[lo:hi]
        return (u * u * self.vocab).astype(np.int32)


__all__ = [
    "ArraySource",
    "ArrowSource",
    "CSVSource",
    "CorralSource",
    "DataSource",
    "NpySource",
    "ParquetSource",
    "ShardSource",
    "SourceStats",
    "SyntheticTokenSource",
    "as_source",
    "clear_stats_memo",
]
