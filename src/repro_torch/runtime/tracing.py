"""Spans and per-fit records of the in-memory mRMR fit: the program's one
home for both.

Nothing is recorded unless a ``torch.profiler`` collects on the fit's
thread (it collects on the thread that started it).  Then each
:func:`span` enters ``torch.profiler.record_function``, so it lands in the
profiler's trace on the same clock as the device's kernels, and adds its
count and host seconds to the thread's open fit record.  Without a
profiler a span is one shared no-op object, one check of the profiler's
state (~0.25 us).

``span(FIT)`` (``"mrmr.fit"``) opens the record of one fit on its thread,
so that fits on parallel threads (the selection service's workers) keep
their records apart; on exit the record joins a bounded store of the
newest fits, read back by :func:`records`.  A record holds:

* ``fit``: the fit's id, counting from 1 over the process;
* ``spans``: ``{span name: [count, host seconds]}``;
* ``reads``: ``{site: [count, blocked seconds]}`` of the blocking
  device-to-host reads made through :func:`host_read`;
* ``pass_s``: each counting pass's device seconds, from CUDA events that
  :func:`pass_frame` records on the stream where the fit runs on one CUDA
  device (empty on the CPU and on a mesh).

Span names are fixed strings, so that a trace's reader can key time by
them; none starts with ``fit:``.  The kernel layer's counter is each kernel
wrapper's ``launches`` (:func:`repro_torch.kernels._build.count_launch`),
not kept here.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time

import torch

FIT = "mrmr.fit"
PASS = "mrmr.pass."  # + the pass's kind: "relevance" or "redundancy"
KEEP = 1024  # records of the newest fits kept

_enabled = torch._C._autograd._profiler_enabled
_local = threading.local()
_lock = threading.Lock()
_store: collections.deque = collections.deque(maxlen=KEEP)
_ids = itertools.count(1)


@dataclasses.dataclass
class Record:
    """What one fit recorded while a profiler collected."""

    fit: int
    spans: dict = dataclasses.field(default_factory=dict)
    reads: dict = dataclasses.field(default_factory=dict)
    pass_s: list = dataclasses.field(default_factory=list)
    _events: list = dataclasses.field(default_factory=list, repr=False)

    def _resolve(self) -> None:
        """Each pass's (start, end) events -> its device seconds."""
        for start, end in self._events:
            end.synchronize()
            self.pass_s.append(start.elapsed_time(end) * 1e-3)
        self._events.clear()


def _add(table: dict, key: str, seconds: float) -> None:
    entry = table.setdefault(key, [0, 0.0])
    entry[0] += 1
    entry[1] += seconds


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Span:
    __slots__ = ("name", "device", "_fn", "_rec", "_prev", "_t0", "_start")

    def __init__(self, name: str, device=None):
        self.name = name
        self.device = device  # a pass's CUDA device, timed by events

    def __enter__(self):
        if self.name == FIT:
            self._prev = getattr(_local, "record", None)
            self._rec = _local.record = Record(next(_ids))
        else:
            self._rec = getattr(_local, "record", None)
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        self._start = None
        if self.device is not None and self._rec is not None:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self.device))
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            self._rec._events.append((self._start, end))
        self._fn.__exit__(*exc)
        if self._rec is not None:
            _add(self._rec.spans, self.name, seconds)
        if self.name == FIT:
            _local.record = self._prev
            with _lock:
                _store.append(self._rec)
        return False


def span(name: str):
    """A context manager that traces ``name`` while a profiler collects,
    and is the shared :data:`NOOP` otherwise."""
    return _Span(name) if _enabled() else NOOP


def pass_frame(kind: str, device=None):
    """The span ``mrmr.pass.<kind>`` of one counting pass.  Where ``device``
    is a CUDA device (the fit's one device; ``None`` on a mesh) and a fit's
    record is open, CUDA events on its current stream time the pass on the
    device; they are read only by :func:`records`."""
    if not _enabled():
        return NOOP
    cuda = device is not None and torch.device(device).type == "cuda"
    return _Span(PASS + kind, device if cuda else None)


def host_read(site: str, tensor: torch.Tensor):
    """One blocking device-to-host read: a 0-d tensor's value
    (``tensor.item()``, as ``int(t)`` reads it), else ``tensor.cpu()``.
    While a fit's record is open, its count and blocked seconds go under
    ``site``."""
    rec = getattr(_local, "record", None)
    if rec is None:
        return _read(tensor)
    t0 = time.perf_counter()
    out = _read(tensor)
    _add(rec.reads, site, time.perf_counter() - t0)
    return out


def _read(tensor: torch.Tensor):
    return tensor.item() if tensor.dim() == 0 else tensor.cpu()


def records(n: int) -> list:
    """The newest ``n`` fits' records, oldest first, with each pass's device
    seconds resolved."""
    with _lock:
        out = list(_store)[-n:] if n > 0 else []
        for rec in out:
            rec._resolve()
    return out


__all__ = ["FIT", "KEEP", "NOOP", "PASS", "Record", "host_read", "pass_frame", "records", "span"]
