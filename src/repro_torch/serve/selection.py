"""Selection-as-a-service: job manager, result cache, coalescing queue.

The paper pitches feature selection as shared cluster infrastructure —
many analysts, one dataset fleet — and at that scale *recomputation
count*, not FLOPs, dominates cost: most traffic is the same few fits
asked for again and again.  :class:`SelectionService` is the long-lived
front end that exploits that:

* **Job manager** — ``submit(source, num_select=...) -> job_id`` with the
  lifecycle ``QUEUED -> RUNNING -> DONE | FAILED | CANCELLED``;
  ``poll``/``result``/``cancel``/``stats`` observe and steer it.
* **Queue-based load leveling** — a bounded work queue drained by a
  worker pool.  A full queue *rejects* with :class:`Backpressure`
  (carrying ``retry_after_s``) instead of blocking or crashing, so load
  spikes shed gracefully and callers know when to come back.
* **Content-addressed result cache** — cache-aside over
  ``sha256(source.fingerprint() × score × criterion × num_select ×
  encoding)`` with an LRU bound: a repeat submission is DONE at submit
  time with zero engine or I/O passes.  ``block_obs``/``prefetch``/
  ``batch_candidates``/``spill_dir``/``readahead`` are deliberately NOT
  part of the address — selections are block-size independent and
  batched/spilled runs are bitwise-identical (tested repo invariants),
  so every execution geometry of the same fit shares one cache line.  An optional ``cache_dir`` spills
  entries as JSON (``MRMRResult.to_json``) and reads them back
  (read-through), surviving restarts.
* **Request coalescing / idempotency keys** — a stampede of identical
  submissions while one is queued or running attaches to the in-flight
  primary job: the engine runs exactly once and every submitter gets the
  same result (and their own job id).
* **Retry with backoff** — each engine run goes through
  :func:`repro_torch.runtime.resilience.retry_with_backoff`; transient
  worker failures (:class:`~repro_torch.runtime.resilience.TransientError`
  by default) re-run with exponential backoff before the job FAILs.

The fits run on the service's ``device`` (``"cuda"`` unless told
otherwise; a CUDA device without a card raises at construction, never
falling back to the CPU).  Worker threads launch the kernels concurrently:
the kernels' first-use build is under a lock and their launch counters
count under one.  The cache key is the JAX package's for the same request
(``repro.serve.selection``), score identities spelled as that package
spells them, so either service's persisted results are addressed alike.

    >>> from repro_torch.serve.selection import SelectionService
    >>> svc = SelectionService(workers=2, queue_capacity=32)
    >>> job = svc.submit("X.npy::y.npy", num_select=10)
    >>> svc.result(job).selected        # blocks until DONE
    >>> svc.submit("X.npy::y.npy", num_select=10)   # cache hit: DONE now
    >>> svc.stats()                     # queue / cache / coalescing counters

CLI: ``python -m repro_torch.launch.serve_select`` submits, polls and
prints the same stats as JSON.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
import queue
import threading
import time
from collections import OrderedDict

import numpy as np

from repro_torch.core.criteria import Criterion, resolve_criterion
from repro_torch.core.mrmr import MRMRResult
from repro_torch.core.scores import MIScore, PearsonMIScore, ScoreFn
from repro_torch.core.selector import check_num_select
from repro_torch.data.binning import BinnedSource
from repro_torch.data.sources import (
    CSVSource,
    CorralSource,
    DataSource,
    NpySource,
    as_source,
)
from repro_torch.device import resolve_device
from repro_torch.runtime.resilience import TransientError, retry_with_backoff

# Job lifecycle states.
QUEUED = "QUEUED"
RUNNING = "RUNNING"
DONE = "DONE"
FAILED = "FAILED"
CANCELLED = "CANCELLED"

_SHUTDOWN = object()  # worker-loop poison pill


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------

class Backpressure(RuntimeError):
    """Work queue full — resubmit after ``retry_after_s`` seconds.

    The reject-with-retry-after half of queue-based load leveling: a full
    queue sheds load at the door instead of letting latency (or memory)
    grow without bound.  ``retry_after_s`` estimates the backlog drain
    time from a running average of job durations.
    """

    def __init__(self, retry_after_s: float, depth: int, capacity: int):
        super().__init__(
            f"selection queue full ({depth}/{capacity} jobs); "
            f"retry after ~{retry_after_s:.2f}s"
        )
        self.retry_after_s = retry_after_s
        self.depth = depth
        self.capacity = capacity


class UnknownJob(KeyError):
    """No job with that id."""


class JobFailed(RuntimeError):
    """The job's engine run raised (after exhausting retries)."""

    def __init__(self, job_id: str, error: str):
        super().__init__(f"{job_id} failed: {error}")
        self.job_id = job_id
        self.error = error


class JobCancelled(RuntimeError):
    """The job was cancelled before producing a result."""


# ---------------------------------------------------------------------------
# requests and jobs
# ---------------------------------------------------------------------------

def score_identity(score: ScoreFn) -> str:
    """A score's identity in the cache key, as the JAX package's
    ``repr`` spells the same score: ``MIScore``'s kernel knob is named
    ``use_pallas`` there, and ``PearsonMIScore`` has no field.  Any other
    score is its own ``repr``."""
    if isinstance(score, MIScore):
        return (
            f"MIScore(num_values={score.num_values!r}, num_classes="
            f"{score.num_classes!r}, block={score.block!r}, "
            f"use_pallas={score.use_kernel!r})"
        )
    if isinstance(score, PearsonMIScore):
        return "PearsonMIScore()"
    return repr(score)


@dataclasses.dataclass(frozen=True)
class SelectionRequest:
    """One fit ask: the source plus every plan knob the service honours.

    ``score`` is already resolved (never None) by the time a request is
    built — the idempotency key needs a concrete score identity.
    """

    source: DataSource
    num_select: int
    score: ScoreFn
    criterion: Criterion
    encoding: str = "auto"
    block_obs: int = 65536
    prefetch: int | str = "auto"
    batch_candidates: int = 1
    spill_dir: str | None = None
    readahead: int = 0
    device: str = "cuda"

    def cache_key(self) -> str:
        """The content address: what the *result* depends on, nothing more.

        ``block_obs`` / ``prefetch`` / ``batch_candidates`` / ``spill_dir``
        / ``readahead`` / ``device`` only change how the fit executes, not
        what it selects (block-size independence and batched/spilled bitwise
        equivalence are tested invariants), so they are excluded — every
        execution geometry of the same fit coalesces onto one cache line.
        The payload is the JAX package's: the score as :func:`score_identity`
        spells it.
        """
        payload = "|".join(
            (
                self.source.fingerprint(),
                score_identity(self.score),
                self.criterion.name or repr(self.criterion),
                str(int(self.num_select)),
                self.encoding,
            )
        )
        return hashlib.sha256(payload.encode()).hexdigest()


@dataclasses.dataclass
class _Job:
    """Internal mutable job record (one per submission, coalesced or not)."""

    job_id: str
    key: str
    request: SelectionRequest
    state: str = QUEUED
    submitted_at: float = 0.0
    started_at: float | None = None
    finished_at: float | None = None
    error: str | None = None
    result: MRMRResult | None = None
    cache_hit: bool = False
    coalesced_into: str | None = None
    attempts: int = 0
    cancel_requested: bool = False
    followers: list = dataclasses.field(default_factory=list)
    done: threading.Event = dataclasses.field(default_factory=threading.Event)


@dataclasses.dataclass(frozen=True)
class JobInfo:
    """Immutable ``poll`` snapshot of a job."""

    job_id: str
    state: str
    cache_hit: bool
    coalesced_into: str | None
    error: str | None
    attempts: int
    submitted_at: float
    started_at: float | None
    finished_at: float | None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _snapshot(job: _Job) -> JobInfo:
    return JobInfo(
        job_id=job.job_id, state=job.state, cache_hit=job.cache_hit,
        coalesced_into=job.coalesced_into, error=job.error,
        attempts=job.attempts, submitted_at=job.submitted_at,
        started_at=job.started_at, finished_at=job.finished_at,
    )


# ---------------------------------------------------------------------------
# result cache
# ---------------------------------------------------------------------------

class ResultCache:
    """Content-addressed LRU cache of :class:`MRMRResult`s (cache-aside).

    The service reads before enqueueing and writes after each engine run;
    the cache itself never computes.  ``persist_dir`` spills every entry
    as ``<key>.json`` (write-through) and ``get`` falls back to disk
    (read-through), so a restarted service — or another process pointed at
    the same directory — reuses results across the LRU bound and across
    process lifetimes.
    """

    def __init__(self, capacity: int = 128, persist_dir: str | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.persist_dir = persist_dir
        self._entries: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.disk_hits = 0
        if persist_dir is not None:
            os.makedirs(persist_dir, exist_ok=True)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    def _path(self, key: str) -> str:
        return os.path.join(self.persist_dir, f"{key}.json")

    def get(self, key: str) -> MRMRResult | None:
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                return self._entries[key]
        if self.persist_dir is not None and os.path.exists(self._path(key)):
            with open(self._path(key)) as f:
                result = MRMRResult.from_json(f.read())
            with self._lock:
                self.disk_hits += 1
            self._insert(key, result)
            return result
        with self._lock:
            self.misses += 1
        return None

    def _insert(self, key: str, result: MRMRResult) -> None:
        with self._lock:
            self._entries[key] = result
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1

    def put(self, key: str, result: MRMRResult) -> None:
        self._insert(key, result)
        if self.persist_dir is not None:
            # Atomic spill: a concurrent reader sees the old file or the
            # new one, never a torn write.
            tmp = self._path(key) + ".tmp"
            with open(tmp, "w") as f:
                f.write(result.to_json())
            os.replace(tmp, self._path(key))

    def stats(self) -> dict:
        with self._lock:
            return dict(
                size=len(self._entries), capacity=self.capacity,
                hits=self.hits, misses=self.misses,
                evictions=self.evictions, disk_hits=self.disk_hits,
            )

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits = self.misses = self.evictions = self.disk_hits = 0


# ---------------------------------------------------------------------------
# source refs
# ---------------------------------------------------------------------------

def parse_source_ref(ref: str) -> DataSource:
    """Build a :class:`DataSource` from a string reference.

    Accepted forms (the CLI's ``--source`` and ``submit``'s string face):

    * ``"X.npy::y.npy"``       — memmapped feature matrix + target vector
    * ``"data.csv"``           — streaming CSV, target = last column
    * ``"corral:ROWSxCOLS"``   — the paper's synthetic generator
      (``corral:20000x64:7`` pins ``seed=7``; default seed 0)
    """
    if ref.startswith("corral:"):
        parts = ref.split(":")
        try:
            rows, cols = (int(v) for v in parts[1].split("x"))
            seed = int(parts[2]) if len(parts) > 2 else 0
        except (ValueError, IndexError):
            raise ValueError(
                f"bad corral ref {ref!r}; want 'corral:ROWSxCOLS[:SEED]'"
            ) from None
        return CorralSource(rows, cols, seed=seed)
    if "::" in ref:
        x_path, y_path = ref.split("::", 1)
        return NpySource(x_path, y_path)
    if ref.endswith(".csv"):
        return CSVSource(ref, dtype=np.int32)
    raise ValueError(
        f"unrecognised source ref {ref!r}; want 'X.npy::y.npy', "
        "'data.csv' or 'corral:ROWSxCOLS[:SEED]'"
    )


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------

class SelectionService:
    """Long-lived selection front end: queue, workers, cache, coalescing.

    Args:
      workers: worker threads draining the queue (each runs one engine fit
        at a time; streamed fits bound their own device memory, so worker
        count × ``block_obs`` is the service's peak-memory envelope).
      queue_capacity: bound on QUEUED jobs; beyond it ``submit`` raises
        :class:`Backpressure` (coalesced and cache-hit submissions never
        occupy a slot).
      cache_capacity / cache_dir: LRU bound and optional JSON spill
        directory of the :class:`ResultCache`.
      max_attempts / retry_base_delay_s / retry_on: the per-job
        :func:`retry_with_backoff` envelope for transient engine failures.
      fit_fn: ``SelectionRequest -> MRMRResult`` override (tests inject
        counting/flaky fits); default runs :class:`repro_torch.MRMRSelector`.
      device: where the fits run (``"cuda"`` raises without a card;
        ``"cpu"`` runs the plain PyTorch versions).

    Thread-safe; use as a context manager or call :meth:`close`.
    """

    def __init__(
        self,
        *,
        workers: int = 2,
        queue_capacity: int = 32,
        cache_capacity: int = 128,
        cache_dir: str | None = None,
        max_attempts: int = 3,
        retry_base_delay_s: float = 0.05,
        retry_on=(TransientError,),
        fit_fn=None,
        retry_sleep=time.sleep,
        device="cuda",
    ):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.device = str(resolve_device(device))
        self.cache = ResultCache(cache_capacity, persist_dir=cache_dir)
        self._queue: queue.Queue = queue.Queue(maxsize=queue_capacity)
        self._lock = threading.Lock()
        self._jobs: dict[str, _Job] = {}
        self._inflight: dict[str, _Job] = {}  # cache key -> primary job
        self._ids = itertools.count()
        self._rejected = 0
        self._coalesced = 0
        self._avg_run_s: float | None = None
        self._closed = False
        self._max_attempts = max_attempts
        self._retry_base_delay_s = retry_base_delay_s
        self._retry_on = retry_on
        self._retry_sleep = retry_sleep
        self._fit_fn = fit_fn if fit_fn is not None else _default_fit
        self._workers = [
            threading.Thread(
                target=self._worker_loop,
                name=f"selection-worker-{i}",
                daemon=True,
            )
            for i in range(workers)
        ]
        for w in self._workers:
            w.start()

    # ------------------------------------------------------------- submit

    def submit(
        self,
        source,
        *,
        num_select: int,
        score: ScoreFn | None = None,
        criterion: Criterion | str = "mid",
        encoding: str = "auto",
        block_obs: int = 65536,
        prefetch: int | str = "auto",
        batch_candidates: int = 1,
        spill_dir: str | None = None,
        readahead: int = 0,
        bins: int | None = None,
    ) -> str:
        """Enqueue a fit; returns a job id immediately.

        ``source`` is a :class:`DataSource`, a string reference (see
        :func:`parse_source_ref`) or an ``(X, y)`` array pair.  A result
        already in the cache completes the job at submit time
        (``cache_hit``); an identical request queued or running coalesces
        onto it; otherwise the job takes a queue slot — or, when the queue
        is full, ``submit`` raises :class:`Backpressure`.

        ``bins`` quantile-discretises a continuous source on the fly
        (:class:`~repro_torch.data.binning.BinnedSource`); the binned
        fingerprint folds the bin config into the cache key, so bins=16
        and bins=64 runs of the same file never collide, and wrapping is
        I/O-free at submit (the sketch pass runs inside the worker's fit,
        memoised per fingerprint).
        """
        if self._closed:
            raise RuntimeError("SelectionService is closed")
        if isinstance(source, str):
            source = parse_source_ref(source)
        elif isinstance(source, tuple):
            source = as_source(*source)
        else:
            source = as_source(source)
        check_num_select(num_select, source.num_features)
        if (
            bins is not None
            and not isinstance(source, BinnedSource)
            and (score is None or isinstance(score, MIScore))
            and (
                np.issubdtype(source.feature_dtype, np.floating)
                if source.feature_dtype is not None
                else not source.stats(block_obs).discrete
            )
        ):
            source = BinnedSource(source, int(bins), fit_block_obs=block_obs)
        if isinstance(source, BinnedSource) and score is None:
            # Sized from config + the sketch pass (memoised: repeat
            # submissions of the same binned content never re-sketch).
            score = MIScore(
                num_values=source.bins,
                num_classes=source.stats(block_obs).num_classes,
            )
        if score is None:
            # stats() is memoised per source fingerprint, so repeat
            # submissions on the same file resolve without an I/O pass.
            st = source.stats(block_obs)
            score = (
                MIScore(num_values=st.num_values, num_classes=st.num_classes)
                if st.discrete
                else PearsonMIScore()
            )
        request = SelectionRequest(
            source=source, num_select=int(num_select), score=score,
            criterion=resolve_criterion(criterion), encoding=encoding,
            block_obs=int(block_obs),
            prefetch=prefetch if prefetch == "auto" else int(prefetch),
            batch_candidates=int(batch_candidates), spill_dir=spill_dir,
            readahead=int(readahead), device=self.device,
        )
        key = request.cache_key()
        cached = self.cache.get(key)
        with self._lock:
            job_id = f"job-{next(self._ids):04d}"
            now = time.time()
            job = _Job(
                job_id=job_id, key=key, request=request, submitted_at=now
            )
            if cached is not None:
                # Cache-aside read path: DONE before it ever queues.
                job.state = DONE
                job.result = cached
                job.cache_hit = True
                job.started_at = job.finished_at = now
                job.done.set()
                self._jobs[job_id] = job
                return job_id
            primary = self._inflight.get(key)
            if primary is not None:
                # Idempotent coalescing: ride the in-flight run.  (The
                # primary may itself be CANCELLED-but-queued; this new
                # submitter's interest is what keeps the run alive.)
                job.coalesced_into = primary.job_id
                job.state = RUNNING if primary.state == RUNNING else QUEUED
                job.started_at = primary.started_at
                primary.followers.append(job)
                self._coalesced += 1
                self._jobs[job_id] = job
                return job_id
            try:
                self._queue.put_nowait(job)
            except queue.Full:
                self._rejected += 1
                raise Backpressure(
                    self._retry_after(), self._queue.qsize(),
                    self._queue.maxsize,
                ) from None
            self._inflight[key] = job
            self._jobs[job_id] = job
            return job_id

    def _retry_after(self) -> float:
        per_job = self._avg_run_s if self._avg_run_s is not None else 1.0
        # Full queue + what the workers hold, drained by the pool.
        backlog = self._queue.maxsize + len(self._workers)
        return max(per_job * backlog / max(len(self._workers), 1), 0.05)

    # -------------------------------------------------------------- query

    def _get(self, job_id: str) -> _Job:
        try:
            return self._jobs[job_id]
        except KeyError:
            raise UnknownJob(job_id) from None

    def poll(self, job_id: str) -> JobInfo:
        """Current lifecycle snapshot of a job."""
        with self._lock:
            return _snapshot(self._get(job_id))

    def result(self, job_id: str, timeout: float | None = None) -> MRMRResult:
        """Block until the job finishes and return its result.

        Raises :class:`JobFailed` / :class:`JobCancelled` for those
        terminal states and ``TimeoutError`` if ``timeout`` elapses.
        """
        with self._lock:
            job = self._get(job_id)
        if not job.done.wait(timeout):
            raise TimeoutError(f"{job_id} still {job.state} after {timeout}s")
        if job.state == FAILED:
            raise JobFailed(job_id, job.error or "unknown error")
        if job.state == CANCELLED:
            raise JobCancelled(f"{job_id} was cancelled")
        return job.result

    def cancel(self, job_id: str) -> bool:
        """Withdraw a submission; True if it will never run for this caller.

        A QUEUED primary job is cancelled in place (the worker skips it
        unless coalesced followers still want the result — then the run
        proceeds for them and this job stays CANCELLED).  Coalesced
        followers can cancel any time before completion.  A RUNNING
        primary cannot be stopped mid-engine: returns False.
        """
        with self._lock:
            job = self._get(job_id)
            if job.state in (DONE, FAILED, CANCELLED):
                return job.state == CANCELLED
            if job.coalesced_into is None and job.state != QUEUED:
                return False  # primary already running
            job.cancel_requested = True
            job.state = CANCELLED
            job.finished_at = time.time()
            job.done.set()
            return True

    def stats(self) -> dict:
        """Queue, job, coalescing and cache counters (one JSON-able dict)."""
        with self._lock:
            by_state: dict[str, int] = {}
            for j in self._jobs.values():
                by_state[j.state] = by_state.get(j.state, 0) + 1
            return dict(
                queue=dict(
                    depth=self._queue.qsize(),
                    capacity=self._queue.maxsize,
                    rejected=self._rejected,
                    inflight=len(self._inflight),
                ),
                workers=len(self._workers),
                jobs=by_state,
                coalesced=self._coalesced,
                avg_run_s=self._avg_run_s,
                cache=self.cache.stats(),
            )

    # ------------------------------------------------------------ workers

    def _worker_loop(self) -> None:
        while True:
            job = self._queue.get()
            if job is _SHUTDOWN:
                return
            with self._lock:
                interested = [
                    j
                    for j in (job, *job.followers)
                    if not j.cancel_requested
                ]
                if not interested:
                    # Everyone cancelled while queued; states are already
                    # CANCELLED — just release the idempotency key.
                    self._inflight.pop(job.key, None)
                    continue
                started = time.time()
                for j in interested:
                    j.state = RUNNING
                    j.started_at = started

            def run():
                job.attempts += 1
                return self._fit_fn(job.request)

            try:
                result = retry_with_backoff(
                    run,
                    max_attempts=self._max_attempts,
                    base_delay_s=self._retry_base_delay_s,
                    retry_on=self._retry_on,
                    sleep=self._retry_sleep,
                )
            except Exception as e:  # noqa: BLE001 — job-level fault barrier
                self._finish(job, FAILED, error=f"{type(e).__name__}: {e}")
                continue
            # Cache-aside write path: populate before releasing the key so
            # the next identical submit hits the cache, not a fresh run.
            self.cache.put(job.key, result)
            elapsed = time.time() - started
            self._avg_run_s = (
                elapsed
                if self._avg_run_s is None
                else 0.8 * self._avg_run_s + 0.2 * elapsed
            )
            self._finish(job, DONE, result=result)

    def _finish(self, job: _Job, state: str, *, result=None, error=None):
        """Fan a terminal state out to the primary and every follower —
        including followers that coalesced on while the engine ran."""
        now = time.time()
        with self._lock:
            for j in (job, *job.followers):
                if j.cancel_requested:
                    continue  # already CANCELLED with done set
                j.state = state
                j.result = result
                j.error = error
                j.attempts = job.attempts
                j.finished_at = now
                j.done.set()
            self._inflight.pop(job.key, None)

    # ------------------------------------------------------------ closing

    def close(self, timeout: float = 10.0) -> None:
        """Stop accepting work and join the workers (running jobs finish)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for _ in self._workers:
            self._queue.put(_SHUTDOWN)
        for w in self._workers:
            w.join(timeout=timeout)

    def __enter__(self) -> "SelectionService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _default_fit(request: SelectionRequest) -> MRMRResult:
    """Run the request through the front-door selector (streaming engine
    for every DataSource under ``encoding="auto"``) on its device."""
    from repro_torch.core.selector import MRMRSelector  # local: breaks no cycles

    sel = MRMRSelector(
        num_select=request.num_select,
        score=request.score,
        criterion=request.criterion,
        encoding=request.encoding,
        block_obs=request.block_obs,
        prefetch=request.prefetch,
        batch_candidates=request.batch_candidates,
        spill_dir=request.spill_dir,
        readahead=request.readahead,
        device=request.device,
    )
    sel.fit(request.source)
    return sel.result_


__all__ = [
    "Backpressure",
    "CANCELLED",
    "DONE",
    "FAILED",
    "JobCancelled",
    "JobFailed",
    "JobInfo",
    "QUEUED",
    "RUNNING",
    "ResultCache",
    "SelectionRequest",
    "SelectionService",
    "UnknownJob",
    "parse_source_ref",
    "score_identity",
]
