"""Encoded-block spill cache — pay the parse/encode tax once per dataset.

The streaming engine visits its source ``L`` times (1 relevance +
``L-1`` redundancy passes), and every pass re-does the expensive host
work from scratch: CSV parse, dtype conversion, quantile-bin encode.
:class:`BlockCacheSource` is a write-through / read-through cache at
exactly the point where that work is done — post parse, post
:class:`~repro_torch.data.binning.BinnedSource` encode, pre placement:

* **pass 1** streams the wrapped source normally and spills every block
  to ``cache_dir`` as compact ``.npy`` chunks (written to a temp name,
  published with an atomic ``os.replace``; a manifest lands last, so a
  crash mid-write can never look like a complete entry);
* **passes 2..L** replay the memmapped chunks — zero parse, zero encode,
  and (for a binned source) a fraction of the bytes: int codes spill at
  the narrowest integer dtype that holds ``bins`` values (``int8`` for
  the common ``bins <= 128`` case vs the base's float32 — 4x fewer bytes).

Entries are keyed by ``fingerprint() × block_obs`` (a
:class:`~repro_torch.data.binning.BinnedSource` fingerprint already folds the
bin config in, so ``bins=16`` and ``bins=64`` spills never collide) and
evicted LRU against a byte ``budget``.  Replay re-verifies every chunk
against the manifest's recorded sizes: a truncated or missing chunk
invalidates the whole entry and the pass silently falls back to
re-staging from the base source — a corrupt spill can cost a pass, never
a wrong selection.

The wrapper IS its base source to every consumer: same geometry, same
block stream (values, order, block-size independence), same
``fingerprint()`` — so the selection service's result cache treats
spilled and direct fits as the same content, which they are.

A copy of the JAX package's ``repro.data.block_cache`` (numpy only): the
same entry layout, manifest, counters and eviction.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
from typing import Iterator

import numpy as np

from repro_torch.data.binning import BinnedSource
from repro_torch.data.sources import Block, DataSource, SourceStats

_MANIFEST = "manifest.json"

# One lock per process: entry publication (chunks + manifest) and LRU
# eviction mutate shared directories.  Cross-process safety rides on the
# atomic renames — a reader either sees a complete entry or none.
_CACHE_LOCK = threading.Lock()


def _narrow_int_dtype(num_values: int) -> np.dtype:
    """Smallest signed integer dtype holding codes in ``[0, num_values)``."""
    for dt in (np.int8, np.int16, np.int32):
        if num_values - 1 <= np.iinfo(dt).max:
            return np.dtype(dt)
    return np.dtype(np.int64)


def _atomic_save(path: str, arr: np.ndarray) -> None:
    """Write ``arr`` as ``.npy`` via a temp file + atomic rename, so a
    crash mid-write leaves a stray temp, never a truncated ``path``."""
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.save(f, arr)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


@dataclasses.dataclass
class BlockCacheSource(DataSource):
    """A :class:`DataSource` wrapper that spills staged blocks to disk.

    Args:
      base: the source to cache.  Wrapping a
        :class:`~repro_torch.data.binning.BinnedSource` caches the *encoded*
        int codes (the expensive part), downcast to the narrowest integer
        dtype that holds ``bins`` values.
      cache_dir: spill directory (created on demand).  Entries are
        subdirectories keyed by ``fingerprint() × block_obs``; several
        sources (or processes) may share one ``cache_dir``.
      budget_bytes: LRU byte budget for ``cache_dir`` as a whole; when a
        freshly completed entry pushes the total over, the least recently
        replayed entries are evicted (never the one just written).
        ``None`` = unbounded.
      namespace: extra entry-key segment for writers that must never share
        an entry even at identical content — multi-host fits pass their
        process index (``"h0"``, ``"h1"``, ...) so hosts on one shared
        filesystem can never race each other's chunks or manifests (shard
        windows already make the *fingerprints* distinct; the namespace
        makes disjointness a contract rather than a property of the
        wrapped source).

    Counters (:attr:`counters`) record the parse-vs-replay split so I/O
    savings are measurable, not guessed: ``parse_passes``/``parsed_bytes``
    count blocks staged from the base source, ``replay_passes``/
    ``replayed_bytes`` count blocks served from the spill.
    """

    base: DataSource
    cache_dir: str
    budget_bytes: int | None = None
    namespace: str = ""

    def __post_init__(self):
        if not isinstance(self.base, DataSource):
            raise TypeError(
                f"BlockCacheSource wraps a DataSource, got "
                f"{type(self.base).__name__}"
            )
        if isinstance(self.base, BlockCacheSource):
            raise ValueError("base source is already block-cached")
        if self.budget_bytes is not None and self.budget_bytes <= 0:
            raise ValueError(
                f"budget_bytes must be positive or None, got "
                f"{self.budget_bytes}"
            )
        if self.namespace and not all(
            c.isalnum() or c in "-_." for c in self.namespace
        ):
            raise ValueError(
                f"namespace {self.namespace!r} must be filesystem-safe "
                "(alphanumerics, '-', '_', '.')"
            )
        # Encoded spill dtype: known without I/O only for binned bases
        # (codes live in [0, bins)); everything else spills as-is.
        self._spill_dtype = (
            _narrow_int_dtype(self.base.bins)
            if isinstance(self.base, BinnedSource)
            else None
        )
        self.counters = dict(
            parse_passes=0, parsed_bytes=0, replay_passes=0, replayed_bytes=0
        )

    # -- delegated identity/geometry ------------------------------------

    @property
    def num_obs(self) -> int:
        return self.base.num_obs

    @property
    def num_features(self) -> int:
        return self.base.num_features

    @property
    def feature_dtype(self) -> np.dtype | None:
        dt = self.base.feature_dtype
        return self._spill_dtype if self._spill_dtype is not None else dt

    def fingerprint(self) -> str:
        # Same content, same address: the cache changes where blocks come
        # from, never what they hold — result-cache keys must coalesce.
        return self.base.fingerprint()

    def stats(self, block_obs: int = 65536) -> SourceStats:
        return self.base.stats(block_obs)

    # -- entry layout ----------------------------------------------------

    def _entry_dir(self, block_obs: int) -> str:
        ns = f"-{self.namespace}" if self.namespace else ""
        return os.path.join(
            self.cache_dir, f"{self.fingerprint()[:32]}-b{int(block_obs)}{ns}"
        )

    def _chunk_paths(self, entry: str, i: int) -> tuple[str, str]:
        return (
            os.path.join(entry, f"X{i:05d}.npy"),
            os.path.join(entry, f"y{i:05d}.npy"),
        )

    def _load_manifest(self, entry: str) -> dict | None:
        try:
            with open(os.path.join(entry, _MANIFEST)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _verify(self, entry: str, manifest: dict | None) -> bool:
        """A replayable entry has a manifest whose every chunk exists at
        exactly the recorded byte size — a crash that truncated a chunk
        after the manifest landed (torn disk, copy) is caught here."""
        if not manifest or manifest.get("version") != 1:
            return False
        if manifest.get("num_obs") != self.num_obs or manifest.get(
            "num_features"
        ) != self.num_features:
            return False
        for i, ch in enumerate(manifest.get("chunks", [])):
            xp, yp = self._chunk_paths(entry, i)
            try:
                ok = (
                    os.path.getsize(xp) == ch["x_bytes"]
                    and os.path.getsize(yp) == ch["y_bytes"]
                )
            except OSError:
                return False
            if not ok:
                return False
        return True

    # -- the block stream ------------------------------------------------

    def iter_blocks(self, block_obs: int) -> Iterator[Block]:
        entry = self._entry_dir(block_obs)
        manifest = self._load_manifest(entry)
        with _CACHE_LOCK:
            replayable = self._verify(entry, manifest)
        if replayable:
            yield from self._replay(entry, manifest)
        else:
            yield from self._stage_and_spill(entry, block_obs)

    def _replay(self, entry: str, manifest: dict) -> Iterator[Block]:
        self.counters["replay_passes"] += 1
        os.utime(entry)  # LRU recency: replays keep an entry warm
        for i in range(len(manifest["chunks"])):
            xp, yp = self._chunk_paths(entry, i)
            # Memmapped load: replay never allocates the chunk on the
            # host — the consumer (placer) copies straight out of the
            # page cache while padding.
            X = np.load(xp, mmap_mode="r")
            y = np.load(yp, mmap_mode="r")
            self.counters["replayed_bytes"] += X.nbytes + y.nbytes
            yield X, y

    def _stage_and_spill(self, entry: str, block_obs: int) -> Iterator[Block]:
        self.counters["parse_passes"] += 1
        os.makedirs(entry, exist_ok=True)
        chunks = []
        for i, (X, y) in enumerate(self.base.iter_blocks(block_obs)):
            if self._spill_dtype is not None and X.dtype != self._spill_dtype:
                X = X.astype(self._spill_dtype)
            X = np.ascontiguousarray(X)
            y = np.ascontiguousarray(y)
            self.counters["parsed_bytes"] += X.nbytes + y.nbytes
            xp, yp = self._chunk_paths(entry, i)
            _atomic_save(xp, X)
            _atomic_save(yp, y)
            chunks.append(
                dict(
                    rows=int(X.shape[0]),
                    x_bytes=os.path.getsize(xp),
                    y_bytes=os.path.getsize(yp),
                )
            )
            yield X, y
        # The manifest is written LAST (atomically): its presence asserts
        # every chunk above it is complete.  A crash anywhere before this
        # line leaves a manifest-less entry that replay refuses.
        manifest = dict(
            version=1,
            num_obs=self.num_obs,
            num_features=self.num_features,
            block_obs=int(block_obs),
            chunks=chunks,
            bytes=sum(c["x_bytes"] + c["y_bytes"] for c in chunks),
        )
        d = os.path.dirname(os.path.join(entry, _MANIFEST))
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(entry, _MANIFEST))
        self._evict(keep=entry)

    # -- LRU eviction ----------------------------------------------------

    def _entries(self) -> list:
        """(mtime, path, bytes) of every complete entry under cache_dir."""
        out = []
        try:
            names = os.listdir(self.cache_dir)
        except OSError:
            return out
        for name in names:
            path = os.path.join(self.cache_dir, name)
            m = self._load_manifest(path)
            if m is None:
                continue
            try:
                out.append((os.stat(path).st_mtime, path, int(m.get("bytes", 0))))
            except OSError:
                continue
        return out

    def _evict(self, keep: str) -> None:
        """Drop least-recently-used entries until the directory fits the
        byte budget; the entry just written (``keep``) is never evicted."""
        if self.budget_bytes is None:
            return
        with _CACHE_LOCK:
            entries = self._entries()
            total = sum(b for _, _, b in entries)
            for _, path, nbytes in sorted(entries):
                if total <= self.budget_bytes:
                    break
                if os.path.abspath(path) == os.path.abspath(keep):
                    continue
                _rmtree_entry(path)
                total -= nbytes

    def spilled_bytes(self, block_obs: int) -> int | None:
        """Byte size of this source's entry for ``block_obs`` (None when
        the entry is incomplete or absent)."""
        m = self._load_manifest(self._entry_dir(block_obs))
        return None if m is None else int(m.get("bytes", 0))


def _rmtree_entry(path: str) -> None:
    """Remove one cache entry directory (manifest first, so a concurrent
    reader that raced past _verify sees missing chunks, not torn ones)."""
    try:
        os.unlink(os.path.join(path, _MANIFEST))
    except OSError:
        pass
    try:
        for name in os.listdir(path):
            try:
                os.unlink(os.path.join(path, name))
            except OSError:
                pass
        os.rmdir(path)
    except OSError:
        pass


__all__ = ["BlockCacheSource"]
