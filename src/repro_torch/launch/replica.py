"""Replica-group serving driver: data-parallel throughput, bit-identical
logits (the port's ``repro.launch.replica``).

Partition the device slots into R disjoint sub-meshes
(:func:`repro_torch.launch.mesh.carve_submeshes`), run one deterministic
engine per sub-mesh and dispatch request groups across the replicas. Every
replica computes exactly the single-engine program, so every request's
tokens and logits are bitwise those of one engine serving the same groups.

Weight state is built **once** and shared: replica 0 prepares the quantized
planes, and the other replicas receive :func:`transfer_tree` copies of them
(the identity on the same device): ``quant.PREP_STATS`` stays flat in R.
Calibration is one pass on replica 0, installed on every engine.

Scheduling model
----------------
Requests are batched in **arrival order** into groups of the engine batch;
the *group* is the scheduling unit. Only the group -> replica assignment
follows the policy (``"round_robin"`` or ``"least_loaded"``), never group
composition, so outputs do not depend on the policy or on R.

Devices and streams
-------------------
Each replica has one worker thread and one queue. On CUDA each worker runs
its engine under a CUDA stream of its own (the counterpart of the
reference's disjoint devices): replicas carved from
:func:`~repro_torch.launch.mesh.virtual_devices` share one card and overlap
only as far as the host lets them. The prepared planes are read-only after
preparation, and the device is synchronized after replica 0 builds them
and before the workers start; caches and per-run tensors are allocated and
used on the worker's own stream. Installs and replays made from the
caller's thread synchronize the device after them.

Fault tolerance
---------------
Every worker serves its groups under a retry-with-backoff loop and a
per-group watchdog deadline; repeated failure (or a poisoned slot)
escalates to :meth:`ReplicaServeDriver._fail_replica`: the replica is
marked ``rebuilding``, its queued and in-flight groups are reset and
requeued whole onto survivors (or held through the rebuild when there are
none), and a replacement engine is rebuilt on the replica's healthy slots
(:func:`repro_torch.runtime.elastic.replacement_mesh` + :func:`transfer_tree`:
nothing re-prepared). A requeued group reproduces its bits on whichever
replica re-runs it. Faults are injected in Python
(:class:`~repro_torch.runtime.fault_tolerance.FaultInjector`), never as
real device faults: a CUDA error is sticky and would end the context of
every replica on the card.

Lifecycle::

    driver = ReplicaServeDriver(cfg, replicas=2, batch=4, max_len=64,
                                devices=virtual_devices("cpu", 2))
    driver.warmup(prompt_len=32)
    futs = driver.submit_many(reqs)     # Future -> completed Request
    driver.drain()
    print(driver.stats())
    driver.close()                      # or use it as a context manager
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import sys
import threading
import time
import traceback
from concurrent.futures import Future, InvalidStateError
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import carve_submeshes
from repro_torch.launch.serve import Request, make_engine
from repro_torch.quant import PreparedWeight
from repro_torch.quant.calibrate import CalibrationTable
from repro_torch.runtime.elastic import replacement_mesh
from repro_torch.runtime.fault_tolerance import (FaultInjector,
                                                 PoisonedDeviceError,
                                                 ReplicaHealth, backoff_delay)

__all__ = ["ReplicaServeDriver", "transfer_tree"]

SCHEDULERS = ("round_robin", "least_loaded")


def _normal(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def transfer_tree(tree, device):
    """``tree`` with every tensor leaf and every
    :class:`~repro_torch.quant.PreparedWeight` plane on ``device``.

    A pure placement: nothing is quantized again (``PREP_STATS`` does not
    move). On the tree's own device it is the identity: tensors and
    prepared weights come back as the same objects, so no plane is copied.
    """
    dev = _normal(device)

    def move(node):
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        if isinstance(node, torch.Tensor):
            return node if node.device == dev else node.to(dev)
        if isinstance(node, PreparedWeight):
            planes = (node.codes, node.scale, node.limbs)
            if all(p is None or p.device == dev for p in planes):
                return node
            return PreparedWeight(
                move(node.codes), move(node.scale), node.fmt_name,
                node.tail, None if node.limbs is None else move(node.limbs),
                node.limb_sigma, node.act_sigma)
        return node

    return move(tree)


def _new_stream(device: torch.device) -> Optional["torch.cuda.Stream"]:
    return torch.cuda.Stream(device) if device.type == "cuda" else None


@dataclasses.dataclass
class _Job:
    """One dispatched group (the scheduling unit)."""
    requests: List[Request]
    futures: List[Future]
    counted: bool = True    # warmup jobs don't enter the served stats
    # (buckets, max_new, seed): run the engine's warmup instead of a group,
    # one job per replica so the R warmups proceed concurrently
    warmup: Optional[tuple] = None


class ReplicaServeDriver:
    """R deterministic engines on disjoint slot sub-meshes, one queue each.

    Args:
      cfg: model config (the quant config selects the kernels, as for one
        engine).
      replicas: number of replicas R; must divide the slot count.
      batch / max_len / seed / eos_id: per-engine serving parameters (see
        :class:`~repro_torch.launch.serve.ServeEngine`).
      params: optional shared parameter tree, prepared once on replica 0.
      calibration: optional table installed on every engine.
      scheduler: ``"round_robin"`` cycles the replicas in dispatch order;
        ``"least_loaded"`` picks the fewest queued + in-flight groups,
        preferring healthy replicas over suspect ones. Both skip
        unhealthy / rebuilding / dead replicas; outputs are identical.
      model_parallel: model axis width of each sub-mesh (default all of a
        replica's slots; only 1 is served in this slice).
      devices: the slots to carve (default one per visible CUDA device;
        :func:`~repro_torch.launch.mesh.virtual_devices` for several on
        one device).
      injector: optional ``FaultInjector``, bound per replica and threaded
        into every group's ``engine.run`` (warmup is never injected).
      max_retries: in-place retries per group before the supervisor fails
        the replica over (a poisoned slot fails over at once).
      deadline_s: per-group watchdog budget handed to ``engine.run``.
      backoff_base_s / backoff_cap_s: retry backoff (``backoff_delay``,
        jitter seeded per replica).
      continuous: one ``ContinuousBatchingEngine`` per replica (``batch``
        slots each); the request becomes the scheduling unit and joins the
        replica's serve loop between decode steps. The injection /
        deadline seam is group-mode only: passing ``injector`` or
        ``deadline_s`` with ``continuous=True`` raises.
    """

    def __init__(self, cfg: ModelConfig, replicas: int, *, batch: int,
                 max_len: int, params=None, seed: int = 0,
                 eos_id: Optional[int] = None,
                 calibration: Optional[CalibrationTable] = None,
                 scheduler: str = "round_robin",
                 model_parallel: Optional[int] = None, devices=None,
                 injector: Optional[FaultInjector] = None,
                 max_retries: int = 2,
                 deadline_s: Optional[float] = None,
                 backoff_base_s: float = 0.02,
                 backoff_cap_s: float = 0.5,
                 continuous: bool = False):
        if scheduler not in SCHEDULERS:
            raise ValueError(f"scheduler {scheduler!r} not in {SCHEDULERS}")
        if continuous and (injector is not None or deadline_s is not None):
            raise ValueError("fault injection / deadline_s are group-mode "
                             "features; continuous=True does not support "
                             "them")
        self.batch = batch
        self.scheduler = scheduler
        self.cfg = cfg
        self.continuous = continuous
        self._engine_kwargs = dict(batch=batch, max_len=max_len, seed=seed,
                                   eos_id=eos_id, continuous=continuous)
        self._calibration = calibration
        self._injector = injector
        self._max_retries = max_retries
        self._deadline_s = deadline_s
        self._backoff = dict(base_s=backoff_base_s, cap_s=backoff_cap_s)
        self._seed = seed
        self._warmup_plan: Optional[tuple] = None
        self.meshes = carve_submeshes(replicas, model_parallel=model_parallel,
                                      devices=devices)
        dev0 = self.meshes[0].device
        first = make_engine(
            cfg, params=None if params is None else transfer_tree(params,
                                                                  dev0),
            calibration=calibration, device=dev0, **self._engine_kwargs)
        self.engines = [first]
        for mesh in self.meshes[1:]:
            # shared prepared planes: transferred, never prepared again
            self.engines.append(make_engine(
                cfg, params=transfer_tree(first.params, mesh.device),
                calibration=calibration, device=mesh.device,
                **self._engine_kwargs))
        self._streams = [_new_stream(e.device) for e in self.engines]
        self._sync_devices()        # the planes are complete on every card

        self._lock = threading.Lock()
        self._pending: List = []        # [(Request, Future)] awaiting a group
        self._inflight = [0] * replicas  # queued + running groups per replica
        self._rr = 0
        self._t0: Optional[float] = None
        self._stats: Dict[str, Any] = {
            "prefill_tokens": 0, "decode_tokens": 0, "decode_steps": 0,
            "requests": 0, "groups": 0, "busy_s": 0.0, "retries": 0,
            "failovers": 0, "requeued_requests": 0, "rebuilds": 0,
            "groups_per_replica": [0] * replicas}
        self.health = [ReplicaHealth() for _ in range(replicas)]
        self._events: List[Dict[str, Any]] = []
        self._streaming = None          # set by enable_streaming
        self._closed = False
        self._queues: List["queue.Queue"] = [queue.Queue()
                                             for _ in range(replicas)]
        worker = self._worker_continuous if continuous else self._worker
        self._workers = [
            threading.Thread(target=worker, args=(i,), daemon=True,
                             name=f"replica-serve-{i}")
            for i in range(replicas)]
        for t in self._workers:
            t.start()

    # -- devices -----------------------------------------------------------

    def _on_stream(self, idx: int):
        """Replica ``idx``'s CUDA stream as the thread's current stream."""
        s = self._streams[idx]
        return torch.cuda.stream(s) if s is not None else \
            contextlib.nullcontext()

    def _sync_devices(self):
        """Wait for every card an engine runs on (all streams)."""
        for dev in {e.device for e in self.engines}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # -- worker ------------------------------------------------------------

    def _worker(self, idx: int):
        q = self._queues[idx]
        while True:
            job = q.get()
            if job is None:
                q.task_done()
                return
            try:
                with self._on_stream(idx):
                    self._run_job(idx, job)
            except Exception as e:
                # _run_job owns failure handling; anything escaping it (a
                # fault in the failover path itself) must not strand the
                # futures
                if not self._fail_futures(job.futures, e):
                    print(f"replica-serve-{idx}: failure with no live "
                          f"futures to notify:", file=sys.stderr)
                    traceback.print_exception(type(e), e, e.__traceback__)
            finally:
                with self._lock:
                    self._inflight[idx] -= 1
                q.task_done()

    @staticmethod
    def _fail_futures(futures, err) -> bool:
        delivered = False
        for fut in futures:
            if not fut.done():
                fut.set_exception(err)
                delivered = True
        return delivered

    def _worker_continuous(self, idx: int):
        """Continuous-mode worker: one ``serve()`` absorbs queued traffic.

        Jobs carry single requests. The first blocking ``get`` starts an
        ``engine.serve()`` whose ``feed`` hook drains whatever queues up
        afterwards, so new requests are admitted between decode steps of
        the resident ones; each future resolves from ``on_done`` the moment
        its request finishes.
        """
        q = self._queues[idx]
        while True:
            job = q.get()
            if job is None:
                q.task_done()
                return
            if job.warmup is not None:
                self._run_side_job(idx, job)
                continue
            jobs = [job]
            deferred: List[_Job] = []
            sentinel: List[Any] = []
            futmap = {id(r): f for r, f in zip(job.requests, job.futures)}

            def feed():
                got: List[Request] = []
                while True:
                    try:
                        j = q.get_nowait()
                    except queue.Empty:
                        return got
                    if j is None:             # close() sentinel
                        sentinel.append(j)
                        return got
                    if j.warmup is not None:  # run after this serve pass
                        deferred.append(j)
                        continue
                    jobs.append(j)
                    for r, f in zip(j.requests, j.futures):
                        futmap[id(r)] = f
                    got.extend(j.requests)

            def on_done(req: Request):
                fut = futmap.pop(id(req), None)
                if fut is not None:
                    try:
                        fut.set_result(req)
                    except InvalidStateError:
                        pass

            try:
                with self._on_stream(idx):
                    stats = self.engines[idx].serve(
                        list(job.requests), feed=feed, on_done=on_done)
                with self._lock:
                    self.health[idx].record_success(stats["wall_s"])
                    self._stats["prefill_tokens"] += stats["prefill_tokens"]
                    self._stats["decode_tokens"] += stats["decode_tokens"]
                    self._stats["decode_steps"] += stats["steps"]
                    self._stats["requests"] += sum(len(j.requests)
                                                   for j in jobs)
                    self._stats["groups"] += len(jobs)
                    self._stats["groups_per_replica"][idx] += len(jobs)
                    self._stats["busy_s"] += stats["wall_s"]
            except Exception as e:
                for j in jobs:
                    self._fail_futures(j.futures, e)
            finally:
                with self._lock:
                    self._inflight[idx] -= len(jobs)
                for _ in jobs:
                    q.task_done()
            for j in deferred:
                self._run_side_job(idx, j)
            if sentinel:
                q.task_done()   # the consumed None
                q.put(None)     # re-post: the next get() exits cleanly

    def _run_side_job(self, idx: int, job: _Job):
        """A warmup job on the continuous worker."""
        try:
            with self._on_stream(idx):
                self._run_job(idx, job)
        except Exception as e:
            self._fail_futures(job.futures, e)
        finally:
            with self._lock:
                self._inflight[idx] -= 1
            self._queues[idx].task_done()

    @staticmethod
    def _deliver(job: _Job, results):
        for r, fut in zip(results, job.futures):
            # a future cancelled while queued: deliver the others
            try:
                fut.set_result(r)
            except InvalidStateError:
                pass

    @staticmethod
    def _reset_requests(requests: List[Request]):
        """Roll a group back to its as-submitted state before a re-run: a
        fault can land mid-decode with partial ``out_tokens``, and a clean
        re-run of the same group reproduces every token bitwise only from
        the blank state the first run saw."""
        for r in requests:
            r.out_tokens.clear()
            r.done = False

    def _log_event(self, event: str, idx: int, **fields):
        rec = {"event": event, "replica": idx, "t": time.time(), **fields}
        with self._lock:
            self._events.append(rec)

    def _run_job(self, idx: int, job: _Job):
        engine = self.engines[idx]
        if job.warmup is not None:
            buckets, max_new, seed = job.warmup
            engine.warmup(buckets, max_new=max_new, seed=seed)
            self._deliver(job, [None] * len(job.futures))
            return
        attempts = 0
        while True:
            bound = (self._injector.bind(idx)
                     if self._injector is not None else None)
            try:
                stats = engine.run(job.requests, injector=bound,
                                   deadline_s=self._deadline_s)
            except Exception as err:
                attempts += 1
                self._reset_requests(job.requests)
                poisoned = (err.device_ids
                            if isinstance(err, PoisonedDeviceError) else ())
                retryable = attempts <= self._max_retries and not poisoned
                with self._lock:
                    self.health[idx].record_failure(err)
                    if retryable:
                        self._stats["retries"] += 1
                self._log_event(
                    "fault", idx, attempt=attempts, retrying=retryable,
                    error=f"{type(err).__name__}: {err}")
                if retryable:
                    time.sleep(backoff_delay(attempts, seed=self._seed + idx,
                                             **self._backoff))
                    continue
                self._fail_replica(idx, job, err, poisoned)
                return
            with self._lock:
                self.health[idx].record_success(stats["wall_s"])
                if job.counted:
                    self._stats["prefill_tokens"] += stats["prefill_tokens"]
                    self._stats["decode_tokens"] += stats["decode_tokens"]
                    self._stats["decode_steps"] += stats["steps"]
                    self._stats["requests"] += len(job.requests)
                    self._stats["groups"] += 1
                    self._stats["groups_per_replica"][idx] += 1
                    self._stats["busy_s"] += stats["wall_s"]
            self._deliver(job, job.requests)
            return

    # -- supervisor: drain, requeue, rebuild -------------------------------

    def _fail_replica(self, idx: int, job: _Job, err: BaseException,
                      poisoned=()):
        """Retries exhausted (or the slot set is poisoned): fail over.

        Runs on the failing replica's worker thread. Marks the replica
        ``rebuilding`` (the schedulers stop routing to it), drains its
        queue, requeues the queued + in-flight groups whole onto surviving
        replicas, then rebuilds a replacement engine on the healthy slots.
        With no survivors the groups are held and dispatched to the rebuilt
        replica; only if the rebuild fails too do their futures carry the
        error.
        """
        t_detect = time.time()
        with self._lock:
            self.health[idx].force("rebuilding")
            self._stats["failovers"] += 1
        q = self._queues[idx]
        drained, saw_sentinel = [job], False
        n_popped = 0
        while True:
            try:
                j = q.get_nowait()
            except queue.Empty:
                break
            n_popped += 1
            if j is None:        # close() sentinel: re-posted after rebuild
                saw_sentinel = True
                continue
            drained.append(j)
        requeue: List[_Job] = []
        for j in drained:
            if j.warmup is not None:   # warmup is best-effort; not requeued
                self._deliver(j, [None] * len(j.futures))
                continue
            self._reset_requests(j.requests)
            requeue.append(j)
        n_requests = sum(len(j.requests) for j in requeue)
        with self._lock:
            self._inflight[idx] -= n_popped
            self._stats["requeued_requests"] += n_requests
            survivors = [i for i in range(len(self.engines))
                         if i != idx and self.health[i].schedulable()]
            if survivors:
                for j in requeue:
                    self._dispatch_locked(j)
                held = []
            else:
                held = requeue
        # the popped jobs were counted by their original put(): balance the
        # queue's join() accounting now that they live elsewhere
        for _ in range(n_popped):
            q.task_done()
        self._log_event("drain_requeue", idx, requests=n_requests,
                        queued_jobs=len(drained) - 1,
                        survivors=len(survivors),
                        error=f"{type(err).__name__}: {err}")
        ok = self._rebuild_replica(idx, exclude=poisoned, t_detect=t_detect)
        if held:
            if ok:
                with self._lock:
                    for j in held:
                        self._dispatch_locked(j, idx=idx)
            else:
                for j in held:
                    self._fail_futures(j.futures, err)
        if saw_sentinel:
            q.put(None)

    def _rebuild_replica(self, idx: int, exclude=(), *,
                         t_detect: float) -> bool:
        """Build a replacement engine on the replica's healthy slots.

        Re-meshes around the exclusion set (``replacement_mesh`` keeps the
        model axis width) and builds the engine from a transfer of a
        surviving engine's prepared planes: nothing prepared again. The
        donor's calibration tables are applied in version order (the
        replacement keeps every version for replay and ends on the fleet's
        current state), its streaming calibrator is re-attached with the
        replica's gate seed, and the driver's warmup plan is replayed.
        Returns False (replica ``dead``) when too few healthy slots remain.
        """
        try:
            mesh = replacement_mesh(self.meshes[idx], exclude=exclude)
            with self._lock:
                donors = [i for i in range(len(self.engines))
                          if i != idx and self.health[i].schedulable()]
            donor = self.engines[donors[0]] if donors else self.engines[idx]
            donor_tables = dict(donor._tables)
            if mesh.device != self.engines[idx].device:
                self._streams[idx] = _new_stream(mesh.device)
            with self._on_stream(idx):
                # built bare when the donor holds tables: the donor's v1 is
                # the first install, not the constructor's table
                engine = make_engine(
                    self.cfg, params=transfer_tree(donor.params, mesh.device),
                    calibration=None if donor_tables else self._calibration,
                    device=mesh.device, **self._engine_kwargs)
                for v in sorted(donor_tables):
                    engine.apply_calibration(donor_tables[v])
                if donor._streaming is not None:
                    engine.enable_streaming(
                        donor._streaming, seed=donor._streaming.seed + idx)
                if self._warmup_plan is not None:
                    buckets, max_new, seed = self._warmup_plan
                    engine.warmup(buckets, max_new=max_new, seed=seed)
                if engine.device.type == "cuda":
                    torch.cuda.current_stream(engine.device).synchronize()
        except Exception as e:
            with self._lock:
                self.health[idx].force("dead")
            self._log_event("replica_dead", idx,
                            reason=f"{type(e).__name__}: {e}")
            return False
        self.engines[idx] = engine
        self.meshes[idx] = mesh
        with self._lock:
            self.health[idx].reset()
            self._stats["rebuilds"] += 1
        self._log_event("rebuilt", idx, excluded=list(exclude),
                        devices=len(mesh.ids),
                        recovery_s=time.time() - t_detect)
        return True

    # -- dispatch ----------------------------------------------------------

    def _schedulable_locked(self) -> List[int]:
        return [i for i in range(len(self._queues))
                if self.health[i].schedulable()]

    def _pick_replica_locked(self) -> int:
        live = self._schedulable_locked()
        if not live:
            raise RuntimeError("no schedulable replicas (all unhealthy or "
                               "rebuilding; see driver.stats()['health'])")
        if self.scheduler == "least_loaded":
            return min(live, key=lambda i: (
                self._inflight[i], self.health[i].state != "healthy", i))
        for _ in range(len(self._queues)):
            idx = self._rr
            self._rr = (self._rr + 1) % len(self._queues)
            if idx in live:
                return idx
        return live[0]

    def _dispatch_locked(self, job: _Job, idx: Optional[int] = None):
        if self._closed:
            raise RuntimeError("driver is closed")
        if idx is None:
            idx = self._pick_replica_locked()
        self._inflight[idx] += 1
        if job.counted and self._t0 is None:
            self._t0 = time.time()
        self._queues[idx].put(job)

    def _flush_locked(self):
        while self._pending:
            group = self._pending[:self.batch]
            del self._pending[:self.batch]
            self._dispatch_locked(_Job([r for r, _ in group],
                                       [f for _, f in group]))

    # -- public API --------------------------------------------------------

    @property
    def replicas(self) -> int:
        return len(self.engines)

    def submit(self, request: Request) -> Future:
        """Enqueue one request; returns a Future of the completed Request.

        Requests accumulate in arrival order until a full group of
        ``batch`` exists, which is dispatched by the scheduler policy; a
        partial trailing group waits for :meth:`flush` / :meth:`drain`. In
        continuous mode the request is dispatched at once.
        """
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("driver is closed")
            if self.continuous:
                self._dispatch_locked(_Job([request], [fut]))
            else:
                self._pending.append((request, fut))
                if len(self._pending) >= self.batch:
                    self._flush_locked()
        return fut

    def submit_many(self, requests: Sequence[Request]) -> List[Future]:
        """Submit a sequence of requests, preserving their order."""
        return [self.submit(r) for r in requests]

    def flush(self):
        """Dispatch any partial pending group immediately."""
        with self._lock:
            self._flush_locked()

    def drain(self, timeout: Optional[float] = None):
        """Flush and block until every dispatched request has completed.

        Failover can move work between queues mid-drain, so the wait loops
        until a full pass finds every queue empty and nothing in flight.
        ``timeout`` (seconds, default none) raises ``TimeoutError`` instead
        of waiting on a hung worker for ever.
        """
        end = None if timeout is None else time.monotonic() + timeout
        self.flush()
        while True:
            for q in self._queues:
                with q.all_tasks_done:
                    while q.unfinished_tasks:
                        left = None if end is None else end - time.monotonic()
                        if left is not None and left <= 0:
                            raise TimeoutError("replica drain timed out")
                        q.all_tasks_done.wait(left)
            with self._lock:
                busy = any(self._inflight) or bool(self._pending)
            if not busy:
                return

    def warmup(self, prompt_len: Optional[int] = None, max_new: int = 1, *,
               plen_buckets: Optional[Sequence[int]] = None, seed: int = 0):
        """Warm every replica up before traffic (one uncounted job each, run
        concurrently): pass one ``prompt_len`` or the ``plen_buckets`` of
        the deployment. The plan is kept: a rebuilt replica replays it."""
        if hasattr(prompt_len, "__iter__"):
            # a bucket list passed positionally
            if plen_buckets is not None:
                raise ValueError("pass exactly one of prompt_len / "
                                 "plen_buckets")
            prompt_len, plen_buckets = None, prompt_len
        if (prompt_len is None) == (plen_buckets is None):
            raise ValueError("pass exactly one of prompt_len / "
                             "plen_buckets")
        buckets = tuple(sorted({int(b) for b in (
            plen_buckets if plen_buckets is not None else [prompt_len])}))
        self._warmup_plan = (buckets, max_new, seed)
        futs: List[Future] = []
        with self._lock:
            for idx in range(self.replicas):
                if self.health[idx].state == "dead":
                    continue      # nobody will ever consume its queue
                fut: Future = Future()
                futs.append(fut)
                self._dispatch_locked(
                    _Job([], [fut], counted=False,
                         warmup=(buckets, max_new, seed)), idx=idx)
        for fut in futs:
            fut.result()

    def calibrate(self, prompts=None, *, seed: int = 0) -> CalibrationTable:
        """One calibration pass, shared by every replica: drains, records
        on replica 0 (:meth:`ServeEngine.calibrate`) and installs the table
        on every engine."""
        self.drain()
        table = self.engines[0].calibrate(prompts, update=True, seed=seed)
        for engine in self.engines[1:]:
            engine.apply_calibration(table)
        self._sync_devices()
        return table

    # -- streaming calibration: fleet-wide versioned hot swap --------------

    def apply_calibration(self, table: CalibrationTable) -> int:
        """Push ``table`` to every live replica **without** drain.

        Each engine swaps its runtime state at its own boundary (the group
        engine at the next group, the continuous engine behind its fence),
        so traffic keeps flowing: nothing is rebuilt or dropped. Versions
        advance in lockstep because every install goes through the driver;
        returns the installed version.
        """
        with self._lock:
            live = [i for i in range(len(self.engines))
                    if self.health[i].state != "dead"]
        versions = [self.engines[i].apply_calibration(table) for i in live]
        self._sync_devices()
        self._log_event("calib_swap", -1, version=max(versions),
                        replicas=live)
        return max(versions)

    def enable_streaming(self, *, seed: int = 0, sample_period: int = 4,
                         **thresholds):
        """Attach one shared streaming calibrator to the whole fleet: every
        replica feeds the same thread-safe recorder through its own
        sampling gate, seeded ``seed + replica`` so the replicas shadow
        different traffic. Refresh with :meth:`maybe_refresh_calibration`.
        """
        calibrator = self.engines[0].enable_streaming(
            seed=seed, sample_period=sample_period, **thresholds)
        for i, engine in enumerate(self.engines[1:], start=1):
            engine.enable_streaming(calibrator, seed=seed + i)
        self._streaming = calibrator
        return calibrator

    def maybe_refresh_calibration(self):
        """Drift-check the shared statistics; on drift push the refreshed
        table fleet-wide (:meth:`apply_calibration`) and return the
        ``DriftReport``, else ``None``."""
        if self._streaming is None:
            return None
        report = self._streaming.maybe_refresh(self.apply_calibration)
        if report is not None:
            self._log_event("calib_refresh", -1,
                            drifted_sites=list(report.drifted_sites))
        return report

    def replay(self, request: Request, version=None, *,
               group: Optional[List[Request]] = None):
        """Re-serve a logged request under its recorded table version on a
        schedulable replica that keeps that version (every replica does
        when every install went through the driver). Run while idle. See
        :meth:`ServeEngine.replay`."""
        want = request.table_version if version is None else version
        with self._lock:
            live = self._schedulable_locked()
        for i in live:
            if want == 0 or want in self.engines[i]._tables:
                out = self.engines[i].replay(request, version, group=group)
                self._sync_devices()
                return out
        raise KeyError(f"no schedulable replica retains calibration "
                       f"version {want}")

    _COUNTERS = ("prefill_tokens", "decode_tokens", "decode_steps",
                 "requests", "groups", "busy_s", "retries", "failovers",
                 "requeued_requests", "rebuilds")

    def events(self) -> List[Dict[str, Any]]:
        """Structured fault / recovery event log, in order: ``event``
        (``"fault"``, ``"drain_requeue"``, ``"rebuilt"``,
        ``"replica_dead"``, ``"calib_swap"``, ``"calib_refresh"``),
        ``replica``, ``t`` and event fields (``recovery_s`` on
        ``"rebuilt"``: detection to serving)."""
        with self._lock:
            return [dict(e) for e in self._events]

    def run(self, requests: Sequence[Request], *,
            timeout: Optional[float] = None) -> Dict[str, Any]:
        """Submit everything, drain, return the stats of **this call**
        (counter deltas over this submit-to-drain window; :meth:`stats`
        stays cumulative). ``timeout`` bounds the drain and each result."""
        with self._lock:
            base = {k: self._stats[k] for k in self._COUNTERS}
            base_groups = list(self._stats["groups_per_replica"])
        t0 = time.time()
        futs = self.submit_many(requests)
        self.drain(timeout)
        for fut in futs:
            fut.result(timeout)    # surface worker exceptions
        wall = max(time.time() - t0, 1e-9)
        with self._lock:
            out = {k: self._stats[k] - base[k] for k in self._COUNTERS}
            out["groups_per_replica"] = [
                g - b for g, b in zip(self._stats["groups_per_replica"],
                                      base_groups)]
        out["replicas"] = self.replicas
        out["scheduler"] = self.scheduler
        out["wall_s"] = wall
        out["requests_per_s"] = out["requests"] / wall
        out["decode_tok_per_s"] = out["decode_tokens"] / wall
        return out

    def stats(self) -> Dict[str, Any]:
        """Cumulative served-traffic statistics since construction.

        ``busy_s`` sums per-replica engine wall time (it exceeds ``wall_s``
        when replicas overlap) and ``decode_steps`` the engines' decode
        steps (served traffic only: a failed attempt's are not counted);
        ``wall_s`` spans the first counted dispatch to now. Warmup traffic
        is excluded.
        """
        with self._lock:
            out = dict(self._stats,
                       groups_per_replica=list(
                           self._stats["groups_per_replica"]))
            out["health"] = [h.snapshot() for h in self.health]
            t0 = self._t0
        out["replicas"] = self.replicas
        out["scheduler"] = self.scheduler
        out["wall_s"] = (time.time() - t0) if t0 is not None else 0.0
        wall = max(out["wall_s"], 1e-9)
        out["requests_per_s"] = out["requests"] / wall
        out["decode_tok_per_s"] = out["decode_tokens"] / wall
        return out

    def close(self, timeout: Optional[float] = None):
        """Finish outstanding work and stop the worker threads; raises
        ``TimeoutError`` if a worker is still alive after ``timeout``."""
        with self._lock:
            if self._closed:
                return
            self._flush_locked()
            self._closed = True
        for q in self._queues:
            q.put(None)
        for t in self._workers:
            t.join(timeout)
        alive = [t.name for t in self._workers if t.is_alive()]
        if alive:
            raise TimeoutError(f"replica workers still running: {alive}")

    def __enter__(self) -> "ReplicaServeDriver":
        return self

    def __exit__(self, *exc):
        self.close()
        return False
