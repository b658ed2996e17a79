"""The training driver of the port (``repro.launch.train``).

Wires together: config -> init -> data pipeline -> train step -> metrics
-> async atomic checkpoints -> preemption -> crash recovery -> straggler
monitoring. Runs on the GPU (``cuda``) unless ``device="cpu"`` is passed;
without CUDA the default raises, and nothing falls back to the CPU.

  python -m repro_torch.launch.train --arch mgs-paper-eval --reduced \\
      --steps 20 --device cpu
  python -m repro_torch.launch.train --arch deepseek-7b --reduced \\
      --mesh 2x2 --device cpu

On a ``(data, model)`` mesh of ``torch.distributed`` ranks (``mesh=`` a
:class:`~repro_torch.parallel.comm.RankMesh`; ``--mesh DxM`` starts the
ranks through ``parallel.comm.launch``) every rank holds its slice of the
train state by the reference's train specs, makes the step-indexed global
batch and runs ``make_train_step(..., mesh=)`` (bitwise the one-device step
with ``grad_accum`` = the batch's row shards). Checkpoints are the
one-device layout (rank 0 writes the gathered leaves), so a run restores
on any mesh. A stop request is agreed across ranks once a step (a max
all-reduce of the flag), so every rank ends after the same step. On the
card ``--mesh`` needs a card a rank (NCCL) or ``--share-device`` (gloo,
every rank on one card); a mesh larger than the visible cards raises
otherwise. The ranks run under ``torch.use_deterministic_algorithms``
there. ``--mesh`` ranks take a stop request as ``SIGUSR1``; with
``--ckpt-dir`` a failed rank fails the launch and the whole rank group
restarts from the newest checkpoint (``run_with_recovery``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import signal
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.serve import _parse_mesh, resolve_device
from repro_torch.models import init_params
from repro_torch.parallel.sharding import named_sharding, train_rules
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.elastic import reshard
from repro_torch.runtime.fault_tolerance import (PreemptionHandler,
                                                 StragglerMonitor,
                                                 run_with_recovery)
from repro_torch.train import OptConfig, init_train_state, make_train_step
from repro_torch.train.train_step import train_state_specs

__all__ = ["TrainLoopConfig", "train_loop", "train_on_mesh", "main"]


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep: int = 3
    grad_accum: int = 1
    seed: int = 0
    max_restarts: int = 3


def _stop_agreed(handler, mesh) -> bool:
    """The handler's stop request, agreed by every rank of ``mesh`` (any
    rank's request stops them all)."""
    stop = bool(handler.should_stop)
    if mesh is None:
        return stop
    flag = torch.tensor([int(stop)], dtype=torch.int32, device=mesh.device)
    return bool(mesh.all_reduce(flag, "max", mesh.axis_names).item())


def train_loop(cfg: ModelConfig, loop: TrainLoopConfig, *, device=None,
               mesh=None, opt_cfg: Optional[OptConfig] = None,
               resume_step: Optional[int] = None,
               handler: Optional[PreemptionHandler] = None
               ) -> Dict[str, Any]:
    """Train ``cfg`` for ``loop.steps`` steps on ``device`` (``cuda`` by
    default); returns ``{"final": metrics, "history": [...], "state":
    state}``.

    Parameters come from ``init_params(cfg, loop.seed)``; with
    ``resume_step`` (and ``loop.ckpt_dir``) the state and the data
    pipeline's position come from that checkpoint instead. Every
    ``loop.ckpt_every`` steps a checkpoint is written in the background,
    and one at the step reached when the loop ends (stopped early or not)
    unless that step was just written. ``handler`` is polled once a step
    (default: one that installs no signal handler); when it asks to stop,
    the loop ends after the step in flight.

    ``mesh``: this rank's :class:`~repro_torch.parallel.comm.RankMesh`
    (every rank calls ``train_loop``); ``device`` defaults to the mesh's.
    The returned state is this rank's slices; only rank 0 prints.
    """
    if mesh is not None and mesh.size == 1:
        mesh = None
    dev = resolve_device(device if mesh is None or device is not None
                         else mesh.device)
    if mesh is not None and mesh.device != dev:
        raise ValueError(f"the mesh's rank runs on {mesh.device}, not {dev}")
    opt_cfg = opt_cfg or OptConfig(total_steps=loop.steps,
                                   warmup_steps=max(2, loop.steps // 20),
                                   schedule=cfg.schedule,
                                   factored=cfg.opt_factored)
    step_fn = make_train_step(cfg, opt_cfg, grad_accum=loop.grad_accum,
                              mesh=mesh)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=loop.seq_len,
                                  global_batch=loop.global_batch,
                                  seed=loop.seed))
    saver = ckpt.AsyncCheckpointer(keep=loop.keep)
    handler = handler or PreemptionHandler(signals=())
    monitor = StragglerMonitor(n_hosts=1)
    speak = mesh is None or mesh.rank == 0

    state = init_train_state(init_params(cfg, loop.seed, device=dev),
                             factored=opt_cfg.factored)
    shardings = None
    if mesh is not None:
        specs = train_state_specs(cfg, train_rules(mesh), opt_cfg.factored)
        shardings = named_sharding(specs, mesh)
        state = reshard(state, specs, mesh)
    start = 0
    if resume_step is not None and loop.ckpt_dir:
        start, state, extra = ckpt.restore(loop.ckpt_dir, resume_step,
                                           template=state,
                                           shardings=shardings)
        data.load_state_dict(extra["data"])

    history = []
    metrics: Dict[str, float] = {}
    step = saved = start
    try:
        while step < loop.steps:
            hb = data.make_batch(step)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in hb.items()}
            t0 = time.time()
            state, m = step_fn(state, batch)
            metrics = {k: float(v) for k, v in m.items()}
            dt = (time.time() - t0) * 1e3
            monitor.record([dt])
            if step % loop.log_every == 0 or step == loop.steps - 1:
                history.append({"step": step, **metrics, "ms": dt})
                if speak:
                    print(f"step {step:5d} loss {metrics['loss']:.4f} "
                          f"gnorm {metrics['grad_norm']:.3f} {dt:.0f}ms")
            step += 1
            data.step = step
            if loop.ckpt_dir and step % loop.ckpt_every == 0:
                saver.save(loop.ckpt_dir, step, state,
                           extra={"data": data.state_dict()},
                           shardings=shardings)
                saved = step
            if _stop_agreed(handler, mesh):
                break
    except BaseException:
        # a save in flight is a restore point: finish it, but meet no
        # other rank (a failed rank's peers may never arrive)
        saver.wait(sync=False)
        raise
    saver.wait()
    # the last step reached, unless the periodic save just wrote it (the
    # reference saves it again, and the rename onto the published
    # directory fails)
    if loop.ckpt_dir and step != saved:
        ckpt.save(loop.ckpt_dir, step, state,
                  extra={"data": data.state_dict()}, keep=loop.keep,
                  shardings=shardings)
    return {"final": metrics, "history": history, "state": state,
            "step": step}


def _train_rank(rank: int, shape, cfg: ModelConfig, loop: TrainLoopConfig,
                resume_step: Optional[int]):
    """One rank of ``--mesh``: :func:`train_loop` on this rank's slice;
    returns (the final metrics, the step reached)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.comm import rank_device
    dev = rank_device()
    if dev.type == "cuda":
        torch.use_deterministic_algorithms(True)
    mesh = make_mesh(shape, ("data", "model"))
    with PreemptionHandler(signals=(signal.SIGUSR1,)) as handler:
        out = train_loop(cfg, loop, device=dev, mesh=mesh,
                         resume_step=resume_step, handler=handler)
    return out["final"], out["step"]


def train_on_mesh(cfg: ModelConfig, loop: TrainLoopConfig, shape, *,
                  device=None, share_device: bool = False,
                  resume_step: Optional[int] = None, rank_fn=_train_rank,
                  timeout: float = 3600.0):
    """Start a ``shape`` mesh of ranks running ``rank_fn(rank, shape, cfg,
    loop, resume_step)`` (default: :func:`train_loop` on each rank's
    slice) and return rank 0's result. A failed rank fails the launch."""
    from repro_torch.parallel.comm import launch
    dev = resolve_device(device)
    if dev.type == "cuda":
        # cuBLAS reads it when a rank creates its handle
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    res = launch(rank_fn, math.prod(shape),
                 args=(tuple(shape), cfg, loop, resume_step), device=dev,
                 share_device=share_device,
                 threads=1 if dev.type == "cpu" else None, timeout=timeout)
    return res[0]


def main(argv=None, *, rank_fn=_train_rank):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--mesh", default="1x1",
                    help="train on a DxM (data x model) mesh of ranks, or "
                         "auto (1 x every visible card)")
    ap.add_argument("--share-device", action="store_true",
                    help="with --mesh on the card: every rank on one card, "
                         "over gloo (NCCL needs a card per rank)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        shape = _parse_mesh(args.mesh, args.device)
    except ValueError as e:
        ap.error(str(e))

    cfg = (reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    loop = TrainLoopConfig(steps=args.steps, global_batch=args.batch,
                           seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                           grad_accum=args.grad_accum,
                           max_restarts=args.max_restarts)
    with PreemptionHandler(signals=(signal.SIGTERM,)) as handler:
        def run(resume):
            if shape is None:
                final = train_loop(cfg, loop, device=args.device,
                                   resume_step=resume,
                                   handler=handler)["final"]
            else:
                final, _ = train_on_mesh(
                    cfg, loop, shape, device=args.device,
                    share_device=args.share_device, resume_step=resume,
                    rank_fn=rank_fn)
            print(json.dumps(final, indent=1))
            return loop.steps

        if args.ckpt_dir:
            run_with_recovery(run, lambda: ckpt.latest_step(args.ckpt_dir),
                              max_restarts=args.max_restarts)
        else:
            run(None)


if __name__ == "__main__":
    main()
