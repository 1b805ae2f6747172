"""Observation-block placement for the streaming engine, on one device or
a :class:`~repro_torch.dist.meshes.Mesh`.

``BlockPlacer`` pads every host block to ``block_obs`` rows (reporting the
padding through a ``valid`` mask, which the score turns into out-of-range
targets) and lands it on the device: on a CUDA device through pinned host
memory with a ``non_blocking`` copy, so the transfer runs on the stream
while the host moves on; on the CPU as a view of the numpy block.  Given a
mesh it lands each block as tiles, one a position, per the plan's regime:

* **obs-sharded** (tall data) — rows split over ``obs_axes``; each shard
  counts every feature on its rows, and the engine sums the shards' states
  once a pass (exact integer counts);
* **feature-sharded** (wide data) — columns padded to the feature extent
  and split over ``feat_axes``, and the *statistics state itself* lives in
  feature shards (``place_state``): per-device state is ``O(N/shards)``;
* **2-D grid** — both at once.

Padded feature columns produce junk statistics rows the engine slices off
after finalize.

``PrefetchPlacer`` is the double-buffered face of the same placement: a
bounded host thread reads and pads block ``i+1`` while the consumer places
block ``i`` and the device counts it.

``CrossPassReader`` reads raw blocks ahead across pass boundaries, so the
next pass's first blocks are in hand while the current pass finishes and
the host picks the next feature.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch

from repro_torch.dist.sharding import axes_tuple, grid_devices, mesh_extent

# End-of-stream sentinels for the prefetch and read-ahead queues.
_DONE = object()
_PASS_END = object()


def resolve_prefetch(prefetch, device) -> int:
    """Resolve the ``prefetch`` knob: an int passes through, ``"auto"`` is
    2 on a CUDA device (staging the next block overlaps the transfer and the
    count) and 0 on the CPU (nothing to overlap with)."""
    if prefetch != "auto":
        try:
            p = int(prefetch)
        except (TypeError, ValueError):
            raise ValueError(
                f"prefetch must be an int >= 0 or 'auto', got {prefetch!r}"
            ) from None
        if p < 0:
            raise ValueError(f"prefetch must be >= 0 or 'auto', got {p}")
        return p
    return 2 if torch.device(device).type == "cuda" else 0


def effective_block_obs(block_obs: int, obs_extent: int = 1) -> int:
    """Blocks round UP to a multiple of the observation-axes extent (1 on
    one device), so ``plan_.block_obs`` reports what the placer runs."""
    ext = max(int(obs_extent), 1)
    return -(-int(block_obs) // ext) * ext


@dataclasses.dataclass
class BlockPlacer:
    """Pad-and-place for observation blocks.

    Args:
      block_obs: rows per placed block; rounded UP to a multiple of the
        observation-axes extent so every shard gets equal rows.  Shorter
        blocks are zero-padded and their padding marked invalid.
      device: the torch device blocks land on without a mesh.
      num_features: expected feature count of every block (required for
        feature sharding: columns pad up to a multiple of the feature-axes
        extent, ``padded_features``).
      mesh: a device mesh, or None for one device.
      obs_axes / feat_axes: mesh axes to shard observations / features
        (and the statistics state) over, intersected with the mesh's axes.
    """

    block_obs: int
    device: torch.device
    num_features: int | None = None
    mesh: object = None
    obs_axes: tuple = ()
    feat_axes: tuple = ()

    def __post_init__(self):
        obs, feat = axes_tuple(self.obs_axes), axes_tuple(self.feat_axes)
        if self.mesh is not None:
            obs = tuple(a for a in obs if a in self.mesh.shape)
            feat = tuple(a for a in feat if a in self.mesh.shape)
            if not obs and not feat:
                # A mesh the blocks cannot shard over would silently run on
                # one device against the caller's device budget.
                raise ValueError(
                    f"mesh axes {tuple(self.mesh.shape)} share no axis "
                    f"with obs_axes {axes_tuple(self.obs_axes)} or "
                    f"feat_axes {axes_tuple(self.feat_axes)}"
                )
            if feat and self.num_features is None:
                # Without the global feature count the placer can neither pad
                # columns to the shard extent nor shard the state.
                raise ValueError(
                    "feature sharding requires num_features "
                    f"(feat_axes={feat} on mesh {tuple(self.mesh.shape)})"
                )
            self.grid = grid_devices(self.mesh, obs, feat)
        else:
            self.grid = [[torch.device(self.device)]]
        self.obs_axes, self.feat_axes = obs, feat
        self.device = self.grid[0][0]
        self.block_obs = effective_block_obs(self.block_obs, mesh_extent(self.mesh, obs))
        fext = mesh_extent(self.mesh, feat)
        self._feat_pad = (
            None if self.num_features is None
            else -(-int(self.num_features) // fext) * fext
        )

    @property
    def padded_features(self) -> int:
        """Feature count after padding to the feature-axes extent."""
        if self._feat_pad is None:
            raise ValueError("BlockPlacer was built without num_features")
        return self._feat_pad

    @property
    def shard_rows(self) -> int:
        return self.block_obs // len(self.grid)

    @property
    def shard_cols(self) -> int:
        return self.padded_features // len(self.grid[0])

    def _cols(self, j: int) -> slice:
        """Feature shard ``j``'s columns (all of them without feature axes)."""
        if len(self.grid[0]) == 1:
            return slice(None)
        return slice(j * self.shard_cols, (j + 1) * self.shard_cols)

    # -- statistics state -------------------------------------------------

    def place_state(self, state):
        """Land a freshly initialised statistics state — one tensor
        (contingency counts) or a dict of tensors (running moments) — as
        ``[i][j]``: a zeroed copy per position, leaves with a leading
        ``padded_features`` axis cut to feature shard ``j``'s columns (the
        rest, scalars, whole).  Without a mesh, ``[[state]]`` on the device."""

        def cut(leaf, j, dev):
            if leaf.dim() >= 1 and leaf.shape[0] == self._feat_pad:
                leaf = leaf[self._cols(j)]
            return leaf.to(dev, copy=True)

        return [[{k: cut(v, j, d) for k, v in state.items()}
                 if isinstance(state, dict) else cut(state, j, d)
                 for j, d in enumerate(row)] for row in self.grid]

    def place_edges(self, edges: np.ndarray) -> list:
        """Land fitted bin edges ``(N, E)`` for every block's device encode:
        float32, padded to ``padded_features`` rows of +inf (a pad column
        encodes to code 0; its statistics are sliced off), cut into feature
        shards — ``[i][j]`` on each position."""
        e = np.ascontiguousarray(edges, dtype=np.float32)
        if e.shape[0] != self.num_features:
            raise ValueError(
                f"edges cover {e.shape[0]} features, placer expects "
                f"{self.num_features}"
            )
        pad = self.padded_features - e.shape[0]
        if pad:
            e = np.concatenate([e, np.full((pad, e.shape[1]), np.inf, np.float32)])
        t = torch.from_numpy(e)
        return [[t[self._cols(j)].to(d) for j, d in enumerate(row)] for row in self.grid]

    # -- blocks -------------------------------------------------------------

    def stage(self, X_block: np.ndarray, target: np.ndarray):
        """Host half: pad a (B, N) block and its ``(B,)`` or ``(q, B)``
        target to ``block_obs`` rows (and the block to ``padded_features``
        zero columns) and build the valid mask.  Pure numpy — safe on a
        background thread (``PrefetchPlacer`` runs it there)."""
        b, nf = X_block.shape
        if b > self.block_obs:
            raise ValueError(
                f"block of {b} rows exceeds block_obs={self.block_obs}"
            )
        if self.num_features is not None and nf != self.num_features:
            raise ValueError(
                f"block has {nf} features, placer expects {self.num_features}"
            )
        if b < self.block_obs:
            pad = self.block_obs - b
            X_block = np.concatenate(
                [X_block, np.zeros((pad,) + X_block.shape[1:], X_block.dtype)]
            )
            tpad = np.zeros(target.shape[:-1] + (pad,), target.dtype)
            target = np.concatenate([target, tpad], axis=-1)
        if self._feat_pad is not None and nf < self._feat_pad:
            X_block = np.concatenate(
                [X_block, np.zeros((X_block.shape[0], self._feat_pad - nf), X_block.dtype)],
                axis=1,
            )
        valid = np.arange(self.block_obs) < b
        return X_block, target, valid

    def _land(self, a: np.ndarray, dev: torch.device) -> torch.Tensor:
        """One host array onto ``dev``: through pinned memory with an
        asynchronous copy on a CUDA device (the caching host allocator keeps
        the pinned buffer alive until the copy has run)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type != "cuda":
            return t.to(dev)
        return t.pin_memory().to(dev, non_blocking=True)

    def place(self, staged):
        """Device half: land a staged (X, target, valid) triple as ``[i][j]``
        triples, tile (i, j) holding observation shard ``i``'s rows of
        feature shard ``j``'s columns (targets and mask: shard ``i``'s rows)
        on its position's device — ``[[triple]]`` without a mesh."""
        X, target, valid = staged
        h = self.shard_rows
        return [[(self._land(X[i * h:(i + 1) * h, self._cols(j)], d),
                  self._land(target[..., i * h:(i + 1) * h], d),
                  self._land(valid[i * h:(i + 1) * h], d))
                 for j, d in enumerate(row)] for i, row in enumerate(self.grid)]

    def __call__(self, X_block: np.ndarray, target: np.ndarray):
        """(B, N), (B,) host block -> ``[i][j]`` placed (X, target, valid)
        triples (see :meth:`place`)."""
        return self.place(self.stage(X_block, target))


@dataclasses.dataclass
class PrefetchPlacer:
    """Double-buffered placement: a host thread runs the placer's staging
    half up to ``depth`` blocks ahead while the consumer places and the
    device counts the previous block.  Exceptions raised while reading or
    staging re-raise in the consumer, and abandoning the iterator stops the
    thread."""

    placer: BlockPlacer
    depth: int = 2

    def __post_init__(self):
        if self.depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {self.depth}")

    def stream(self, host_blocks):
        """``(X_block, target)`` host iterator -> placed-tiles iterator."""
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def produce():
            try:
                for X_block, target in host_blocks:
                    if stop.is_set():
                        return
                    q.put((self.placer.stage(X_block, target), None))
                q.put((_DONE, None))
            except BaseException as exc:  # re-raised by the consumer
                q.put((None, exc))

        worker = threading.Thread(
            target=produce, name="block-prefetch", daemon=True
        )
        worker.start()
        try:
            while True:
                staged, exc = q.get()
                if exc is not None:
                    raise exc
                if staged is _DONE:
                    return
                yield self.placer.place(staged)
        finally:
            stop.set()
            while worker.is_alive():
                try:  # unblock a producer waiting on a full queue
                    q.get_nowait()
                except queue.Empty:
                    pass
                worker.join(timeout=0.01)


class CrossPassReader:
    """Read blocks ahead *across pass boundaries* on one reader thread.

    The streaming engine's pass loop has a structural bubble: while the
    device finalizes pass ``l`` and the host folds/argmaxes, nobody is
    reading pass ``l+1`` — yet which blocks a pass reads never depends on
    the pick (only the target-column *extraction* does, and the engine
    extracts at consume time).  This reader keeps one thread iterating
    ``make_pass()`` — a fresh raw ``(X, y)`` host-block iterator per call
    — pass after pass, up to ``depth`` blocks ahead through a bounded
    queue, so the tail of pass ``l`` overlaps the head of pass ``l+1``.

    The consumer pulls whole passes in order via :meth:`next_pass` and
    must call :meth:`close` (or exhaust ``max_passes``) to stop the
    thread.  Read/parse exceptions re-raise in the consumer at the block
    they correspond to.
    """

    def __init__(self, make_pass, depth: int = 2, max_passes: int | None = None):
        if depth < 1:
            raise ValueError(f"read-ahead depth must be >= 1, got {depth}")
        if max_passes is not None and max_passes < 1:
            raise ValueError(f"max_passes must be >= 1, got {max_passes}")
        self._make_pass = make_pass
        self._max_passes = max_passes
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._passes_started = 0
        self._worker = threading.Thread(
            target=self._produce, name="cross-pass-readahead", daemon=True
        )
        self._worker.start()

    def _produce(self):
        try:
            p = 0
            while self._max_passes is None or p < self._max_passes:
                self._passes_started += 1
                for blk in self._make_pass():
                    if self._stop.is_set():
                        return
                    self._q.put((blk, None))
                self._q.put((_PASS_END, None))
                if self._stop.is_set():
                    return
                p += 1
            self._q.put((_DONE, None))
        except BaseException as exc:  # re-raised by the consumer
            self._q.put((None, exc))

    def next_pass(self):
        """Iterator over the next pass's raw ``(X, y)`` host blocks."""
        while True:
            item, exc = self._q.get()
            if exc is not None:
                raise exc
            if item is _PASS_END:
                return
            if item is _DONE:
                raise RuntimeError(
                    "CrossPassReader exhausted: next_pass() called after "
                    f"max_passes={self._max_passes} passes were consumed"
                )
            yield item

    def close(self):
        """Stop the reader thread and drop any read-ahead blocks."""
        self._stop.set()
        while self._worker.is_alive():
            try:  # unblock a producer waiting on a full queue
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._worker.join(timeout=0.01)

    def __enter__(self) -> "CrossPassReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
