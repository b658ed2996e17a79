"""Ranks, process groups and the collectives of sharded serving.

The reference serves on a mesh of JAX devices and GSPMD inserts every
collective its layouts need. The port runs one ``torch.distributed`` rank
per mesh position and writes those collectives out. This module owns:

* :class:`RankMesh` — the ``(data, model)`` (or any) grid of the world's
  ranks: this rank's coordinate, one process group per set of mesh axes
  (the ranks that differ only along those axes), and the collectives the
  model needs, each over a named set of axes: an integer sum and a float
  max (:meth:`RankMesh.all_reduce`), an all-gather along a dim
  (:meth:`RankMesh.all_gather`, shards concatenated in the spec's
  row-major order), the same gather as a list of the ranks' tensors in
  shard order (:meth:`RankMesh.all_gather_parts`: what an ordered float
  sum adds up), a barrier (:meth:`RankMesh.barrier`) and an agreed int32
  vector from the host (:meth:`RankMesh.agree`: the max over every rank,
  what a host-side decision such as an admission count is taken from);
* :data:`COMM_STATS` — calls, bytes and bytes staged through the host, per
  process;
* :func:`launch` — starts N ranks (``torch.multiprocessing``, spawn) that
  meet through a ``FileStore`` (no TCP port to pick), collects what each
  returns and stops them all past a deadline.

Backends: NCCL where every rank has a card of its own; gloo on the CPU and
where the caller explicitly asks for several ranks on one card
(``share_device=True``; NCCL refuses two ranks on one GPU). gloo is handed
host tensors only: a CUDA tensor is staged through the host on purpose,
and counted (``host_bytes``). A mesh larger than the visible cards raises
unless the caller asks to share a device.
"""

from __future__ import annotations

import itertools
import math
import os
import queue
import shutil
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["RankMesh", "COMM_STATS", "reset_comm_stats", "launch",
           "plan_ranks", "rank_device"]

#: collectives of this process: calls per kind, payload bytes (what this
#: rank sends into each call) and bytes copied through the host (gloo with
#: CUDA tensors: down and back up)
COMM_STATS: Dict[str, int] = {"calls": 0, "bytes": 0, "host_bytes": 0,
                              "all_reduce_sum": 0, "all_reduce_max": 0,
                              "all_gather": 0, "barrier": 0, "agree": 0}
_STATS_LOCK = threading.Lock()
_RANK_DEVICE: Optional[torch.device] = None


def reset_comm_stats() -> None:
    with _STATS_LOCK:
        for k in COMM_STATS:
            COMM_STATS[k] = 0


def _count(kind: str, nbytes: int, host: int) -> None:
    with _STATS_LOCK:
        COMM_STATS["calls"] += 1
        COMM_STATS[kind] += 1
        COMM_STATS["bytes"] += nbytes
        COMM_STATS["host_bytes"] += host


def rank_device() -> torch.device:
    """The device :func:`launch` gave this rank (the CPU outside one)."""
    return _RANK_DEVICE if _RANK_DEVICE is not None else torch.device("cpu")


class RankMesh:
    """A grid of the world's ranks, rank ``r`` at the row-major position
    ``r`` of ``shape``.

    ``shape`` maps axis name to size and ``axis_names`` orders them, as a
    JAX mesh's do, so :class:`~repro_torch.parallel.sharding.Rules`
    resolve over it. A mesh of one rank needs no process group.
    """

    def __init__(self, shape: Sequence[int],
                 axis_names: Sequence[str] = ("data", "model"), *,
                 device=None):
        self.axis_names = tuple(axis_names)
        self.sizes = tuple(int(s) for s in shape)
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.sizes} vs axes "
                             f"{self.axis_names}")
        self.size = math.prod(self.sizes)
        if dist.is_available() and dist.is_initialized():
            world, self.rank = dist.get_world_size(), dist.get_rank()
            backend = dist.get_backend()
        elif self.size == 1:
            world, self.rank, backend = 1, 0, None
        else:
            raise RuntimeError(
                f"a {self.sizes} mesh needs {self.size} torch.distributed "
                "ranks and no process group is initialized: start them "
                "with repro_torch.parallel.comm.launch")
        if world != self.size:
            raise ValueError(f"mesh shape {self.sizes} needs {self.size} "
                             f"ranks; the world has {world}")
        self.device = torch.device(device) if device is not None \
            else rank_device()
        self.backend = backend
        #: gloo takes host tensors: CUDA payloads are staged through the host
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.coord = self.coord_of(self.rank)
        self._groups: Dict[Tuple[str, ...], Tuple[Any, List[int]]] = {}
        if self.size > 1:
            self._make_groups()

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    def coord_of(self, rank: int) -> Dict[str, int]:
        out, r = {}, rank
        for a, s in reversed(list(zip(self.axis_names, self.sizes))):
            out[a] = r % s
            r //= s
        return {a: out[a] for a in self.axis_names}

    def _rank_of(self, coord: Dict[str, int]) -> int:
        r = 0
        for a, s in zip(self.axis_names, self.sizes):
            r = r * s + coord[a]
        return r

    def _make_groups(self):
        """One group per set of axes (in mesh order) and per position on
        the other axes; every rank creates every group, in one order."""
        names = self.axis_names
        for n in range(1, len(names) + 1):
            for axes in itertools.combinations(names, n):
                if math.prod(self.shape[a] for a in axes) == 1:
                    continue
                others = [a for a in names if a not in axes]
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in others)):
                    base = dict(zip(others, fixed))
                    ranks = sorted(
                        self._rank_of({**base, **dict(zip(axes, free))})
                        for free in itertools.product(
                            *(range(self.shape[a]) for a in axes)))
                    group = (dist.group.WORLD if len(ranks) == self.size
                             else dist.new_group(ranks))
                    if self.rank in ranks:
                        self._groups[axes] = (group, ranks)

    def _group(self, axes: Sequence[str]):
        """(group, member ranks in group order) of this rank along
        ``axes``; ``None`` when they span one rank."""
        key = tuple(a for a in self.axis_names if a in axes
                    and self.shape[a] > 1)
        return self._groups.get(key) if key else None

    def _shard_index(self, rank: int, axes: Sequence[str]) -> int:
        c, idx = self.coord_of(rank), 0
        for a in axes:
            idx = idx * self.shape[a] + c[a]
        return idx

    def all_reduce(self, x: torch.Tensor, op: str,
                   axes: Sequence[str]) -> torch.Tensor:
        """A new tensor: ``x`` summed (``op="sum"``, integers: exact) or
        maxed (``op="max"``) over the ranks along ``axes``."""
        if op not in ("sum", "max"):
            raise ValueError(f"op {op!r} not in ('sum', 'max')")
        g = self._group(axes)
        if g is None:
            return x
        h = x.contiguous().cpu() if self.staged else x.clone()
        dist.all_reduce(h, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=g[0])
        out = h.to(x.device) if self.staged else h
        nb = x.numel() * x.element_size()
        _count("all_reduce_" + op, nb, 2 * nb if self.staged else 0)
        return out

    def _gather(self, x: torch.Tensor, axes: Sequence[str]):
        """The ranks' ``x`` along ``axes`` in row-major shard order of
        ``axes`` (as listed), on the host when staged; ``None`` when the
        axes span one rank."""
        g = self._group(axes)
        if g is None:
            return None
        group, members = g
        h = x.contiguous().cpu() if self.staged else x.contiguous()
        parts = [torch.empty_like(h) for _ in members]
        dist.all_gather(parts, h, group=group)
        order = [None] * len(members)
        for r, p in zip(members, parts):
            order[self._shard_index(r, axes)] = p
        return order

    def _count_gather(self, x: torch.Tensor, n: int) -> None:
        nb = x.numel() * x.element_size()
        _count("all_gather", nb, nb * (1 + n) if self.staged else 0)

    def all_gather(self, x: torch.Tensor, dim: int,
                   axes: Sequence[str]) -> torch.Tensor:
        """The shards of ``x`` along ``axes`` concatenated on ``dim`` in
        row-major shard order of ``axes`` (as listed)."""
        order = self._gather(x, axes)
        if order is None:
            return x
        out = torch.cat(order, dim)
        if self.staged:
            out = out.to(x.device)
        self._count_gather(x, len(order))
        return out

    def all_gather_parts(self, x: torch.Tensor,
                         axes: Sequence[str]) -> List[torch.Tensor]:
        """Every rank's ``x`` along ``axes`` (any dtype, bits unchanged),
        in row-major shard order of ``axes``: ``[x]`` when they span one
        rank. One all-gather, counted as one."""
        order = self._gather(x, axes)
        if order is None:
            return [x]
        if self.staged:
            order = [p.to(x.device) for p in order]
        self._count_gather(x, len(order))
        return order

    def agree(self, values: Sequence[int]) -> List[int]:
        """The elementwise max over every rank of an int32 vector held on
        the host: one all-reduce over the whole mesh, counted as
        ``agree`` (gloo reduces it on the host, nothing staged; NCCL takes
        it up to the card and back). ``values`` alone on one rank."""
        vals = [int(v) for v in values]
        g = self._group(self.axis_names)
        if g is None:
            return vals
        dev = torch.device("cpu") if self.backend == "gloo" else self.device
        t = torch.tensor(vals, dtype=torch.int32, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g[0])
        nb = 4 * len(vals)
        _count("agree", nb, 0 if dev.type == "cpu" else 2 * nb)
        return [int(v) for v in t.tolist()]

    def barrier(self, axes: Optional[Sequence[str]] = None) -> None:
        """Wait until every rank along ``axes`` (default: all) is here."""
        g = self._group(self.axis_names if axes is None else axes)
        if g is None:
            return
        dist.barrier(group=g[0])
        _count("barrier", 0, 0)

    def __repr__(self):
        return (f"RankMesh(shape={self.shape}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def plan_ranks(device, world: int, share_device: bool = False
               ) -> Tuple[str, List[torch.device]]:
    """(backend, one device per rank) for ``world`` ranks on ``device``.

    The CPU: gloo. CUDA: NCCL over one visible card per rank, or with
    ``share_device`` gloo over one card for every rank; a mesh larger than
    the visible cards raises unless ``share_device``.
    """
    dev = torch.device(device)
    if dev.type == "cpu":
        return "gloo", [dev] * world
    if dev.type != "cuda":
        raise ValueError(f"ranks run on cpu or cuda, not {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "ranks on the CPU")
    if share_device:
        one = torch.device("cuda", dev.index or 0)
        return "gloo", [one] * world
    n = torch.cuda.device_count()
    if world > n:
        raise ValueError(
            f"a mesh of {world} ranks needs {world} cards and {n} are "
            "visible; pass share_device=True (--share-device) to run the "
            "ranks on one card over gloo")
    return "nccl", [torch.device("cuda", i) for i in range(world)]


def _rank_main(rank: int, world: int, backend: str, device: str,
               store_path: str, fn: Callable, args: tuple, out_q,
               threads: Optional[int]):
    global _RANK_DEVICE
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        _RANK_DEVICE = dev
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
    except BaseException:   # reported to the parent, which fails the run
        out_q.put((rank, False, traceback.format_exc()))
        return
    try:
        result = fn(rank, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out_q.put((rank, True, result))
    except BaseException:
        # reported before the group closes: the other ranks' errors that
        # the closing causes arrive after this one
        out_q.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world: int, *, args: tuple = (), device="cpu",
           share_device: bool = False, timeout: float = 600.0,
           store_dir: Optional[str] = None,
           threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``world`` ranks; returns their results
    in rank order.

    Each rank is a spawned process with the process group initialized
    (:func:`plan_ranks` picks backend and device; the device is current
    there and :func:`rank_device` returns it). ``fn`` must be importable
    (module level) and its result picklable. ``threads`` pins torch's
    intra-op threads in every rank. Raises if a rank fails (with its
    traceback) or the ranks are not all done within ``timeout`` seconds;
    every rank still running then is stopped.
    """
    backend, devices = plan_ranks(device, world, share_device)
    # every rank runs on this host: gloo's pairs over the loopback device
    # (the host name need not resolve on a machine without a network)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    ctx = torch.multiprocessing.get_context("spawn")
    out_q = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="rank_store_", dir=store_dir)
    store_path = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, backend, str(devices[r]),
                               store_path, fn, tuple(args), out_q, threads))
             for r in range(world)]
    results: Dict[int, Any] = {}
    errors: Dict[int, str] = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0 or errors:
                # past the deadline, or a rank failed and the others may
                # wait for it in a collective forever
                break
            try:
                r, ok, payload = out_q.get(timeout=min(left, 1.0))
            except queue.Empty:
                for r, p in enumerate(procs):
                    if (r not in results and r not in errors
                            and not p.is_alive() and p.exitcode not in
                            (0, None)):
                        errors[r] = f"rank {r} exited with {p.exitcode}"
                continue
            (results if ok else errors)[r] = payload
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(5)
        out_q.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        first = next(iter(errors))          # the first to arrive
        raise RuntimeError(f"rank {first} of {world} failed:\n"
                           f"{errors[first]}")
    if len(results) < world:
        missing = sorted(set(range(world)) - set(results))
        raise TimeoutError(f"ranks {missing} of {world} not done within "
                           f"{timeout} s; stopped")
    return [results[r] for r in range(world)]
