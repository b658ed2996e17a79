"""Fault tolerance of the training loop: backoff, preemption, stragglers,
crash recovery (the training half of ``repro.runtime.fault_tolerance``,
the port's own copy).

* **Backoff** — :func:`backoff_delay` computes capped exponential
  backoff with *deterministic* jitter (seeded, so retry schedules are
  reproducible across runs); :func:`run_with_recovery` sleeps it between
  attempts.
* **Preemption** (SIGTERM from the scheduler): finish the current step,
  write a final checkpoint, exit cleanly. ``PreemptionHandler`` exposes a
  ``should_stop`` flag the loop polls once per step. Signal handlers can
  only be installed from the main thread — constructed anywhere else the
  handler degrades to an explicit no-op with a warning instead of raising.
* **Crash recovery**: ``run_with_recovery`` wraps a run loop; on an
  exception it restores from the latest checkpoint and replays, up to
  ``max_restarts``, sleeping a capped-exponential backoff between
  attempts and emitting one structured log line per attempt (backed by
  the atomic checkpoints of ``runtime/checkpoint.py``: a crashed save
  never corrupts the restore point).
* **Stragglers**: ``StragglerMonitor`` keeps a per-host EMA of step
  times; hosts slower than ``threshold`` x the median are flagged for a
  grace restart.

The serving fleet's half (fault injection, ``ReplicaHealth``, poisoned
devices) belongs to the fleet slice of the port (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
import json
import signal
import sys
import threading
import time
import warnings
from typing import Callable, List, Optional

import numpy as np

__all__ = ["PreemptionHandler", "StragglerReport", "StragglerMonitor",
           "run_with_recovery", "backoff_delay"]


def backoff_delay(attempt: int, *, base_s: float = 0.05,
                  cap_s: float = 2.0, factor: float = 2.0,
                  jitter: float = 0.25, seed: int = 0) -> float:
    """Capped exponential backoff with deterministic jitter.

    ``attempt`` is 1-based: delay ``base_s * factor**(attempt-1)``,
    capped at ``cap_s``, then scaled by a jitter factor in
    ``[1 - jitter, 1 + jitter]`` drawn from an rng seeded on
    ``(seed, attempt)`` — the schedule is reproducible for a given seed
    (pass a per-replica seed to de-synchronize replicas without losing
    determinism). ``base_s <= 0`` disables the delay entirely.
    """
    if base_s <= 0:
        return 0.0
    delay = min(cap_s, base_s * factor ** (max(int(attempt), 1) - 1))
    if jitter:
        u = float(np.random.default_rng(
            [abs(int(seed)), max(int(attempt), 1)]).uniform(-1.0, 1.0))
        delay *= 1.0 + jitter * u
    return float(min(delay, cap_s))


class PreemptionHandler:
    """Installs SIGTERM/SIGINT handlers that request a graceful stop.

    ``signal.signal`` raises ``ValueError`` off the main thread, so
    construction elsewhere
    degrades to a warned no-op: ``should_stop`` stays poll-able (always
    False unless :meth:`request_stop` is called) and :meth:`restore`
    does nothing. Usable as a context manager — ``__exit__`` restores
    the previous handlers.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self.should_stop = False
        self._prev = {}
        self.installed = (threading.current_thread()
                          is threading.main_thread())
        if not self.installed:
            warnings.warn(
                "PreemptionHandler: signal handlers can only be installed "
                "from the main thread; running as a no-op (should_stop "
                "stays False unless request_stop() is called)",
                RuntimeWarning, stacklevel=2)
            return
        for sig in signals:
            self._prev[sig] = signal.signal(sig, self._handler)

    def _handler(self, signum, frame):
        self.should_stop = True

    def request_stop(self):
        """Programmatic stop request (the signal-free path)."""
        self.should_stop = True

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev = {}

    def __enter__(self) -> "PreemptionHandler":
        return self

    def __exit__(self, *exc):
        self.restore()
        return False


@dataclasses.dataclass
class StragglerReport:
    slow_hosts: List[int]
    median_ms: float
    worst_ratio: float
    action: str  # "none" | "grace_restart"


class StragglerMonitor:
    """EMA-based per-host step-time tracking with restart planning."""

    def __init__(self, n_hosts: int, ema: float = 0.9,
                 threshold: float = 1.5, min_steps: int = 8):
        self.n_hosts = n_hosts
        self.ema = ema
        self.threshold = threshold
        self.min_steps = min_steps
        self._t = np.zeros(n_hosts)
        self._n = 0

    def record(self, host_times_ms):
        host_times_ms = np.asarray(host_times_ms, np.float64)
        assert host_times_ms.shape == (self.n_hosts,)
        if self._n == 0:
            self._t = host_times_ms.copy()
        else:
            self._t = self.ema * self._t + (1 - self.ema) * host_times_ms
        self._n += 1

    def plan(self) -> StragglerReport:
        med = float(np.median(self._t))
        ratios = self._t / max(med, 1e-9)
        slow = ([] if self._n < self.min_steps
                else [int(i) for i in np.nonzero(
                    ratios > self.threshold)[0]])
        action = "grace_restart" if slow else "none"
        return StragglerReport(slow_hosts=slow, median_ms=med,
                               worst_ratio=float(ratios.max(initial=0.0)),
                               action=action)


def run_with_recovery(run_fn: Callable[[Optional[int]], int],
                      restore_step_fn: Callable[[], Optional[int]],
                      max_restarts: int = 3,
                      backoff_s: float = 0.0, *,
                      backoff_cap_s: float = 30.0,
                      jitter: float = 0.25,
                      seed: int = 0,
                      on_attempt: Optional[Callable[[dict], None]] = None
                      ) -> int:
    """Run ``run_fn(resume_step)`` to completion with restore-on-crash.

    ``run_fn`` returns the final step; ``restore_step_fn`` returns the
    latest durable checkpoint step (or None). Re-raises after the
    restart budget is exhausted. Between attempts it sleeps a capped
    exponential backoff with deterministic jitter
    (:func:`backoff_delay`; ``backoff_s`` is the base, 0 disables the
    sleep) and emits one structured JSON log line per restart to stderr
    — ``{"event": "recovery_restart", "attempt": ..., "resume_step":
    ..., "error": ..., "backoff_s": ...}`` — also passed to
    ``on_attempt`` when given.
    """
    attempts = 0
    while True:
        resume = restore_step_fn()
        try:
            return run_fn(resume)
        except KeyboardInterrupt:
            raise
        except Exception as e:
            attempts += 1
            if attempts > max_restarts:
                raise
            delay = backoff_delay(attempts, base_s=backoff_s,
                                  cap_s=backoff_cap_s, jitter=jitter,
                                  seed=seed)
            event = {"event": "recovery_restart", "attempt": attempts,
                     "max_restarts": max_restarts, "resume_step": resume,
                     "error": f"{type(e).__name__}: {e}",
                     "backoff_s": round(delay, 6)}
            print(json.dumps(event), file=sys.stderr, flush=True)
            if on_attempt is not None:
                on_attempt(event)
            if delay:
                time.sleep(delay)
