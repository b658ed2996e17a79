"""Fault tolerance: injection, detection, backoff, health, preemption,
stragglers and crash recovery (the port's own copy of
``repro.runtime.fault_tolerance``).

It serves the self-healing replica fleet (:mod:`repro_torch.launch.replica`)
and the training loop:

* **Fault injection** — :class:`FaultInjector` drives deterministic,
  seed-addressed faults (raise-on-Nth-group, hang-past-deadline, poisoned
  device) through the seam :meth:`ServeEngine.run
  <repro_torch.launch.serve.ServeEngine.run>` exposes. The faults are
  Python exceptions raised at step boundaries, never real device faults: a
  CUDA error is sticky and would end the context of every replica sharing
  the card, so no test or smoke provokes one. A poisoned device names
  fleet *slot* ids (:func:`repro_torch.launch.mesh.carve_submeshes`).
* **Health** — :class:`ReplicaHealth` keeps a per-replica latency EMA plus
  consecutive-failure tracking, and derives the state the driver's
  scheduler and supervisor act on: ``healthy -> suspect -> unhealthy``
  from failures, with the overlay states ``rebuilding`` / ``dead`` forced
  by the supervisor during recovery.
* **Backoff** — :func:`backoff_delay` computes capped exponential
  backoff with *deterministic* jitter (seeded, so retry schedules are
  reproducible across runs and distinct across replicas); the replica
  worker's retry path and :func:`run_with_recovery` sleep it.
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
"""

from __future__ import annotations

import dataclasses
import json
import signal
import sys
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["PreemptionHandler", "StragglerReport", "StragglerMonitor",
           "run_with_recovery", "backoff_delay", "ReplicaHealth",
           "FaultSpec", "FaultInjector", "InjectedFault",
           "PoisonedDeviceError", "DeadlineExceeded"]


class InjectedFault(RuntimeError):
    """A deterministic fault raised by :class:`FaultInjector`."""


class PoisonedDeviceError(InjectedFault):
    """An injected device failure: the listed slot ids are unusable.

    The replica supervisor treats this as non-retryable on the same slot
    set: it excludes ``device_ids`` and rebuilds the replica on the
    remaining healthy slots
    (:func:`repro_torch.runtime.elastic.replacement_mesh`).
    """

    def __init__(self, device_ids: Tuple[int, ...], msg: str = ""):
        super().__init__(msg or f"poisoned devices: {tuple(device_ids)}")
        self.device_ids = tuple(device_ids)


class DeadlineExceeded(RuntimeError):
    """The per-group watchdog deadline (or a supervisor abort) fired."""


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


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault to inject into the serving stack.

    Fires on the ``group``-th request-group *execution* on replica
    ``replica`` (0-based; retried executions of the same group count, so
    ``count > max_retries`` exhausts the worker's retry budget and forces a
    failover). Kinds:

    * ``"raise"`` — raise :class:`InjectedFault` (a transient worker crash;
      retryable on the same replica).
    * ``"hang"`` — sleep ``hang_s`` inside the group (a straggler; the
      engine's watchdog then raises :class:`DeadlineExceeded` once past
      ``deadline_s``).
    * ``"poison"`` — raise :class:`PoisonedDeviceError` naming
      ``device_ids`` (a dead device; non-retryable — the supervisor must
      re-mesh around the exclusion set).
    """

    kind: str                              # "raise" | "hang" | "poison"
    replica: int = 0                       # -1 = any replica
    group: int = 0                         # Nth group execution (0-based)
    count: int = 1                         # consecutive executions hit
    after_decode_steps: int = 0            # 0 = at group start
    hang_s: float = 0.25
    device_ids: Tuple[int, ...] = ()
    probability: float = 1.0               # seed-decided when < 1

    def __post_init__(self):
        if self.kind not in ("raise", "hang", "poison"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind == "poison" and not self.device_ids:
            raise ValueError("poison fault needs device_ids")


class FaultInjector:
    """Deterministic, seed-driven fault injection for the replica fleet.

    Thread-safe; one injector serves every replica. The driver binds a
    per-replica view (:meth:`bind`) and threads it into ``ServeEngine.run``,
    which calls ``before_group()`` as each request group starts and
    ``on_decode(step)`` before each decode step. Group indices count
    *executions* per replica (retries increment them), so a spec with
    ``count=k`` fails k consecutive attempts.

    Every decision is deterministic: specs address (replica, group)
    directly, and sub-1 ``probability`` specs are decided by
    ``np.random.default_rng([seed, replica + 1, group + 1])`` — the same
    specs and seed fire the same faults as the reference's injector.
    :meth:`fired` returns the structured log of every injected event.
    """

    def __init__(self, specs=(), seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._exec: Dict[int, int] = {}     # replica -> groups started
        self._fired: List[dict] = []

    def bind(self, replica: int) -> "_ReplicaInjector":
        """A per-replica handle for one ``ServeEngine.run`` call."""
        return _ReplicaInjector(self, int(replica))

    def fired(self) -> List[dict]:
        """Structured log of injected events (kind/replica/group/step/t)."""
        with self._lock:
            return [dict(e) for e in self._fired]

    def _begin_group(self, replica: int) -> int:
        with self._lock:
            g = self._exec.get(replica, 0)
            self._exec[replica] = g + 1
        return g

    def _matches(self, replica: int, group: int, step: int):
        out = []
        for spec in self.specs:
            if spec.replica not in (-1, replica):
                continue
            if not (spec.group <= group < spec.group + spec.count):
                continue
            if spec.after_decode_steps != step:
                continue
            if spec.probability < 1.0:
                u = float(np.random.default_rng(
                    [self.seed, replica + 1, group + 1]).random())
                if u >= spec.probability:
                    continue
            out.append(spec)
        return out

    def _fire(self, replica: int, group: int, step: int):
        for spec in self._matches(replica, group, step):
            with self._lock:
                self._fired.append({
                    "kind": spec.kind, "replica": replica, "group": group,
                    "step": step, "t": time.time()})
            if spec.kind == "hang":
                time.sleep(spec.hang_s)
            elif spec.kind == "poison":
                raise PoisonedDeviceError(
                    spec.device_ids,
                    f"injected poisoned devices {spec.device_ids} on "
                    f"replica {replica} group {group}")
            else:
                raise InjectedFault(
                    f"injected fault on replica {replica} group {group}"
                    + (f" decode step {step}" if step else ""))


class _ReplicaInjector:
    """The bound view ``ServeEngine.run`` calls into (one replica)."""

    def __init__(self, parent: FaultInjector, replica: int):
        self._parent = parent
        self._replica = replica
        self._group: Optional[int] = None

    def before_group(self):
        self._group = self._parent._begin_group(self._replica)
        self._parent._fire(self._replica, self._group, 0)

    def on_decode(self, step: int):
        if self._group is not None and step > 0:
            self._parent._fire(self._replica, self._group, step)


class ReplicaHealth:
    """Per-replica health: group-latency EMA + consecutive-failure state.

    States derived from consecutive failures — ``"healthy"`` (none),
    ``"suspect"`` (some, below ``unhealthy_after``), ``"unhealthy"``
    (at/above it) — plus two supervisor-forced overlay states:
    ``"rebuilding"`` while a replacement engine is under construction and
    ``"dead"`` when no healthy slot set remains. The scheduler dispatches
    only to ``healthy``/``suspect`` replicas (:meth:`schedulable`),
    preferring ``healthy`` under ``least_loaded``. :meth:`is_straggler`
    flags a replica whose smoothed group latency exceeds
    ``straggler_ratio`` x a fleet reference.
    """

    def __init__(self, ema: float = 0.8, unhealthy_after: int = 3,
                 straggler_ratio: float = 3.0):
        self.ema = float(ema)
        self.unhealthy_after = int(unhealthy_after)
        self.straggler_ratio = float(straggler_ratio)
        self.latency_ema: Optional[float] = None
        self.successes = 0
        self.failures = 0
        self.consecutive_failures = 0
        self.last_error: Optional[str] = None
        self._forced: Optional[str] = None

    @property
    def state(self) -> str:
        if self._forced is not None:
            return self._forced
        if self.consecutive_failures >= self.unhealthy_after:
            return "unhealthy"
        if self.consecutive_failures > 0:
            return "suspect"
        return "healthy"

    def schedulable(self) -> bool:
        return self.state in ("healthy", "suspect")

    def record_success(self, latency_s: float):
        self.successes += 1
        self.consecutive_failures = 0
        if self.latency_ema is None:
            self.latency_ema = float(latency_s)
        else:
            self.latency_ema = (self.ema * self.latency_ema
                                + (1.0 - self.ema) * float(latency_s))

    def record_failure(self, err: Optional[BaseException] = None):
        self.failures += 1
        self.consecutive_failures += 1
        if err is not None:
            self.last_error = f"{type(err).__name__}: {err}"

    def force(self, state: Optional[str]):
        """Supervisor overlay: ``"rebuilding"`` / ``"dead"`` (or None)."""
        if state not in (None, "rebuilding", "dead"):
            raise ValueError(f"cannot force state {state!r}")
        self._forced = state

    def reset(self):
        """Replacement engine online: clear failures and overlays."""
        self._forced = None
        self.consecutive_failures = 0
        self.latency_ema = None

    def is_straggler(self, reference_s: Optional[float]) -> bool:
        return (self.latency_ema is not None and reference_s is not None
                and reference_s > 0
                and self.latency_ema > self.straggler_ratio * reference_s)

    def snapshot(self) -> dict:
        return {"state": self.state, "latency_ema_s": self.latency_ema,
                "successes": self.successes, "failures": self.failures,
                "consecutive_failures": self.consecutive_failures,
                "last_error": self.last_error}


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
