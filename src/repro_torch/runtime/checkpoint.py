"""Sharded checkpointing: atomic, async, in the JAX package's on-disk layout
(port of ``repro.runtime.checkpoint``).

Layout: ``<dir>/step_<n>/proc_<i>.npz`` + ``manifest.json`` (``step``,
``num_processes``, the sorted ``keys``).  A tree is flattened as JAX
flattens a pytree: dict keys in sorted order, dataclass fields in their
order (``TrainState``: params, opt, step), sequence items by index; a
leaf's key is its path joined by ``SEP``.  Each process lands only its own
``proc_<i>.npz`` (written to a private name, ``os.replace``d into the
step's tmp dir), and process 0 alone, after polling for every shard, writes
the manifest, swaps the tmp dir into place and applies the retention.  So
a crash mid-write never corrupts the latest checkpoint, and the two
packages read each other's checkpoints: the port's trainer saves
``train.train_step.state_to_jax(model, state)``, the JAX stacked layout.

Leaves are numpy arrays, tensors or
:class:`~repro_torch.dist.sharding.ShardedArray` s (a state on a model
mesh: each leaf assembled whole on the host, as a single JAX process
writes it, so the files equal those of the same state on one device),
taken to the host when ``save`` is called; the file is written on a
background thread when ``use_async``.  ``restore(..., shardings=mesh)``
lays each leaf that ``like`` gives as a ``ShardedArray`` out onto the
mesh's positions by its spec, a copy of its block a position.
bfloat16 leaves are stored as the JAX package stores them, 2-byte void
(``|V2``) records of their bits; a ``|V2`` record read back is bfloat16.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.dist.multihost import process_count, process_index
from repro_torch.dist.sharding import ShardedArray

SEP = "\x1e"  # record separator: flat pytree key


def _children(node):
    """(key, child) pairs in JAX's pytree order, or None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def flatten_with_paths(tree) -> dict:
    """Flat ``{key: leaf}`` in the tree's (JAX) order; keys are paths joined
    by ``SEP``."""
    out = {}

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            out[SEP.join(path)] = node
            return
        for k, child in kids:
            walk(child, path + (str(k),))

    walk(tree, ())
    return out


def unflatten_like(like, values: dict):
    """A tree shaped as ``like`` whose leaves are ``values[key]``, rebuilt in
    ``like``'s order (never a sorted order of the keys)."""

    def build(node, path):
        kids = _children(node)
        if kids is None:
            return values[SEP.join(path)]
        built = [(k, build(child, path + (str(k),))) for k, child in kids]
        if isinstance(node, dict):
            return {k: v for k, v in built}
        if dataclasses.is_dataclass(node):
            return dataclasses.replace(node, **dict(built))
        return type(node)(v for _, v in built)

    return build(like, ())


def to_host(leaf) -> np.ndarray:
    """A leaf as the numpy array the file stores (bfloat16 as ``|V2``; a
    sharded leaf whole)."""
    if isinstance(leaf, ShardedArray):
        leaf = leaf.whole()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def from_host(a: np.ndarray) -> torch.Tensor:
    """A stored array as a tensor (a ``|V2`` record is bfloat16)."""
    if a.dtype == np.dtype("V2"):
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _place(t: torch.Tensor, like, shardings):
    """restore's placement of the stored tensor ``t``: on the host (None),
    a device, or a Mesh (laid out over it where ``like`` is a
    ``ShardedArray``, else on its first position's device)."""
    if shardings is None:
        return t
    devices = getattr(shardings, "devices", None)
    if devices is None:
        return t.to(torch.device(shardings))
    if isinstance(like, ShardedArray):
        return ShardedArray.from_whole(t, shardings, like.spec)
    return t.to(devices.flat[0])


class CheckpointManager:
    """Save and restore trees (a ``TrainState`` in the JAX layout) with
    retention and async writes.

    ``process_index`` / ``process_count`` default to the
    ``torch.distributed`` rank and world size (0 and 1 without a group);
    tests pass them to act as several writers on one directory."""

    def __init__(
        self,
        directory: str,
        *,
        keep: int = 3,
        use_async: bool = True,
        process_index: int | None = None,
        process_count: int | None = None,
        publish_timeout: float = 300.0,
    ):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1) if use_async else None
        self._pending = None
        self._lock = threading.Lock()
        self._process_index = process_index
        self._process_count = process_count
        self.publish_timeout = publish_timeout

    def _coords(self) -> tuple[int, int]:
        proc = process_index() if self._process_index is None else self._process_index
        nproc = process_count() if self._process_count is None else self._process_count
        return proc, nproc

    # ------------------------------------------------------------------ save
    def save(self, step: int, state) -> None:
        """Snapshot to host memory NOW, write asynchronously."""
        host = {k: to_host(v) for k, v in flatten_with_paths(state).items()}
        if self._pool is None:
            self._write(step, host)
            return
        self.wait()
        with self._lock:
            self._pending = self._pool.submit(self._write, step, host)

    def wait(self) -> None:
        """Block until the pending write has landed (its error raised here)."""
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def _write(self, step: int, flat: dict) -> None:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        proc, nproc = self._coords()
        part = os.path.join(tmp, f"proc_{proc}.npz.part")
        with open(part, "wb") as f:
            np.savez(f, **flat)
        os.replace(part, os.path.join(tmp, f"proc_{proc}.npz"))
        if proc != 0:
            return  # process 0 alone publishes (manifest, swap, gc)
        expect = [os.path.join(tmp, f"proc_{i}.npz") for i in range(nproc)]
        deadline = time.monotonic() + self.publish_timeout
        while not all(os.path.exists(p) for p in expect):
            if time.monotonic() >= deadline:
                missing = [p for p in expect if not os.path.exists(p)]
                raise TimeoutError(
                    f"step {step}: {len(missing)}/{nproc} shard files never "
                    f"arrived within {self.publish_timeout}s "
                    f"(first missing: {os.path.basename(missing[0])})"
                )
            time.sleep(0.05)
        manifest = {"step": step, "num_processes": nproc, "keys": sorted(flat)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    # ---------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, name, "manifest.json")):
                    out.append(int(name[len("step_"):]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like, shardings=None):
        """Restore into the structure of ``like`` (a tree of tensors, arrays,
        ``meta`` tensors or ``ShardedArray`` s of them; only its keys and
        the sharded leaves' specs matter): tensors in the stored dtypes, on
        ``shardings`` (a device; a Mesh, over which a ``ShardedArray`` leaf
        is laid out by its spec and any other leaf goes to its first
        position's device; or None for the host).  Only ``like``'s keys are
        read."""
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        flat_like = flatten_with_paths(like)
        want = set(flat_like)
        data = {}
        for i in range(manifest["num_processes"]):
            fp = os.path.join(path, f"proc_{i}.npz")
            if os.path.exists(fp):
                with np.load(fp) as z:
                    data.update({k: z[k] for k in z.files if k in want})
        missing = want - set(data)
        if missing:
            raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]}...")
        return unflatten_like(like, {k: _place(from_host(v), flat_like[k], shardings)
                                     for k, v in data.items()})


__all__ = ["SEP", "CheckpointManager", "flatten_with_paths", "unflatten_like"]
