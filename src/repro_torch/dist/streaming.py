"""Observation-block placement for the streaming engine, on one device.

``BlockPlacer`` pads every host block to ``block_obs`` rows (reporting the
padding through a ``valid`` mask, which the score turns into out-of-range
targets) and lands it on the device: on a CUDA device through pinned host
memory with a ``non_blocking`` copy, so the transfer runs on the stream
while the host moves on; on the CPU as a view of the numpy block.

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
    """Pad-and-place for observation blocks on one device.

    Args:
      block_obs: rows per placed block; shorter blocks are zero-padded and
        their padding marked invalid.
      device: the torch device the blocks land on.
      num_features: expected feature count of every block.
    """

    block_obs: int
    device: torch.device
    num_features: int

    def __post_init__(self):
        self.block_obs = effective_block_obs(self.block_obs)
        self.device = torch.device(self.device)

    def place_state(self, state):
        """Land a freshly initialised statistics state on the device: one
        tensor (contingency counts) or a dict of tensors (running moments)."""
        if isinstance(state, dict):
            return {k: v.to(self.device) for k, v in state.items()}
        return state.to(self.device)

    def place_edges(self, edges: np.ndarray) -> torch.Tensor:
        """Land fitted bin edges ``(N, E)`` as one contiguous float32 tensor,
        the operand every block's device encode reads."""
        e = np.ascontiguousarray(edges, dtype=np.float32)
        if e.shape[0] != self.num_features:
            raise ValueError(
                f"edges cover {e.shape[0]} features, placer expects "
                f"{self.num_features}"
            )
        return torch.from_numpy(e).to(self.device)

    def stage(self, X_block: np.ndarray, target: np.ndarray):
        """Host half: pad a (B, N) block and its ``(B,)`` or ``(q, B)``
        target to ``block_obs`` rows and build the valid mask.  Pure numpy —
        safe on a background thread (``PrefetchPlacer`` runs it there)."""
        b, nf = X_block.shape
        if b > self.block_obs:
            raise ValueError(
                f"block of {b} rows exceeds block_obs={self.block_obs}"
            )
        if nf != self.num_features:
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
        valid = np.arange(self.block_obs) < b
        return X_block, target, valid

    def place(self, staged):
        """Device half: land a staged (X, target, valid) triple.  On a CUDA
        device each array goes through pinned memory with an asynchronous
        copy (the caching host allocator keeps the pinned buffer alive until
        the copy has run)."""
        arrays = [torch.from_numpy(np.ascontiguousarray(a)) for a in staged]
        if self.device.type != "cuda":
            return tuple(a.to(self.device) for a in arrays)
        return tuple(
            a.pin_memory().to(self.device, non_blocking=True) for a in arrays
        )

    def __call__(self, X_block: np.ndarray, target: np.ndarray):
        """(B, N), (B,) host block -> placed (X, target, valid)."""
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
        """``(X_block, target)`` host iterator -> placed-tuple iterator."""
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
