"""Fault-tolerance runtime: watchdog, crash-restart driver, call retries.

A copy of the JAX package's ``repro.runtime.resilience`` (threading and the
standard library only).  Host-side failures surface as (a) hung steps
(node loss -> a step never completes), (b) process crashes, (c) transient
errors of one call (flaky I/O, a preempted worker):

* ``StepWatchdog``  — per-step heartbeat; a step exceeding ``timeout_s``
  triggers ``on_stall`` (default: log loudly), so the driver can skip or
  abort for the restart wrapper to take over.
* ``run_with_restarts`` — crash-restart loop: on exception, restore the
  latest checkpoint and resume (bounded retries).
* ``retry_with_backoff`` — call-level retry with exponential backoff for
  transient failures; the selection service wraps each engine run in it so
  one wobble never fails a job.
* ``elastic_restore`` — restore a checkpoint onto a DIFFERENT mesh: the
  checkpoint layout is mesh-agnostic (whole host arrays), so scaling from
  N to M positions, a model mesh or one device, is a restore onto the new
  layout.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable

logger = logging.getLogger("repro_torch.resilience")


class TransientError(RuntimeError):
    """A failure expected to succeed on retry (flaky I/O, preemption).

    Raise it — or pass your own exception types via ``retry_on`` — to mark
    work as retryable; anything else propagates immediately.
    """


def retry_with_backoff(
    fn: Callable[[], object],
    *,
    max_attempts: int = 3,
    base_delay_s: float = 0.1,
    max_delay_s: float = 30.0,
    backoff: float = 2.0,
    retry_on=(TransientError,),
    on_retry: Callable[[int, BaseException, float], None] | None = None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Call ``fn()``; on a retryable exception, back off and re-call.

    Delay before attempt ``k+1`` is ``min(base * backoff**(k-1), max)``.
    Non-retryable exceptions — and the last retryable one once
    ``max_attempts`` calls have failed — propagate to the caller.
    ``on_retry(attempt, exc, delay_s)`` observes each retry (the selection
    service uses it to count attempts per job); ``sleep`` is injectable
    for tests.
    """
    if max_attempts < 1:
        raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
    attempt = 1
    while True:
        try:
            return fn()
        except retry_on as e:
            if attempt >= max_attempts:
                raise
            delay = min(base_delay_s * backoff ** (attempt - 1), max_delay_s)
            logger.warning(
                "transient failure (attempt %d/%d), retrying in %.2fs: %s",
                attempt, max_attempts, delay, e,
            )
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)
            attempt += 1


class StepWatchdog:
    """Heartbeat monitor: call ``beat(step)`` once per train step."""

    def __init__(
        self,
        timeout_s: float = 300.0,
        on_stall: Callable[[int, float], None] | None = None,
        poll_s: float = 1.0,
    ):
        self.timeout_s = timeout_s
        self.on_stall = on_stall or self._default_stall
        self.poll_s = poll_s
        self._last_beat = time.monotonic()
        self._last_step = -1
        self._stalled_steps: list[int] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _default_stall(self, step: int, elapsed: float) -> None:
        logger.error(
            "step %d stalled for %.1fs (straggler or hung collective)",
            step, elapsed,
        )

    def beat(self, step: int) -> None:
        self._last_beat = time.monotonic()
        self._last_step = step

    @property
    def stalled_steps(self) -> list[int]:
        return list(self._stalled_steps)

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            elapsed = time.monotonic() - self._last_beat
            if elapsed > self.timeout_s:
                self._stalled_steps.append(self._last_step)
                self.on_stall(self._last_step, elapsed)
                self._last_beat = time.monotonic()  # rate-limit alarms

    def __enter__(self) -> "StepWatchdog":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


def run_with_restarts(
    make_state: Callable[[], object],
    run_from: Callable[[object], object],
    *,
    ckpt,
    state_like_fn: Callable[[], object],
    shardings=None,
    max_restarts: int = 3,
):
    """Crash-restart driver.

    ``make_state()`` builds a fresh state (cold start); ``run_from(state)``
    trains until done (raising on failure); ``ckpt`` is a CheckpointManager.
    On failure, restores the latest checkpoint (or cold-starts when none)
    and re-enters, up to ``max_restarts`` times.
    """
    attempts = 0
    while True:
        try:
            step = ckpt.latest_step()
            if step is None:
                state = make_state()
                logger.info("cold start")
            else:
                state = ckpt.restore(step, state_like_fn(), shardings)
                logger.info("restored checkpoint step %d", step)
            return run_from(state)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — restart on any failure
            attempts += 1
            logger.exception("run failed (attempt %d): %s", attempts, e)
            if attempts > max_restarts:
                raise
            time.sleep(min(2.0**attempts, 30.0))


def elastic_restore(ckpt, step: int, model, opt_cfg, new_mesh):
    """Restore checkpoint ``step`` of ``model`` onto ``new_mesh`` -> (model,
    the port ``TrainState`` there).  A mesh with a ``model`` axis gets each
    position's blocks, as ``make_train_step(model, opt_cfg, mesh=new_mesh)``
    trains them; a mesh of batch axes only keeps the state on its first
    position's device, as a data-parallel step does; a device (or None,
    the host) holds the state whole.  The checkpoint itself is whole
    arrays, so any of these restores any checkpoint."""
    from repro_torch.train.train_step import state_from_jax, state_to_jax, train_state_shapes

    like = state_to_jax(model, train_state_shapes(model, opt_cfg, mesh=new_mesh), new_mesh)
    restored = ckpt.restore(step, like, new_mesh)
    return model, state_from_jax(model, restored)


__all__ = [
    "StepWatchdog",
    "TransientError",
    "elastic_restore",
    "retry_with_backoff",
    "run_with_restarts",
]
