"""The training driver of the port (``repro.launch.train`` on one device).

Wires together: config -> init -> data pipeline -> train step -> metrics
-> async atomic checkpoints -> preemption -> crash recovery -> straggler
monitoring. Runs on the GPU (``cuda``) unless ``device="cpu"`` is passed;
without CUDA the default raises, and nothing falls back to the CPU.

  python -m repro_torch.launch.train --arch mgs-paper-eval --reduced \\
      --steps 20 --device cpu

One device only: a data / model mesh (``--mesh`` other than ``1x1``)
belongs to the sharded runtime, a later slice of the port (ROADMAP A12.2).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.serve import resolve_device
from repro_torch.models import init_params
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.fault_tolerance import (PreemptionHandler,
                                                 StragglerMonitor,
                                                 run_with_recovery)
from repro_torch.train import OptConfig, init_train_state, make_train_step

__all__ = ["TrainLoopConfig", "train_loop", "main"]


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


def train_loop(cfg: ModelConfig, loop: TrainLoopConfig, *, device=None,
               opt_cfg: Optional[OptConfig] = None,
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
    """
    dev = resolve_device(device)
    opt_cfg = opt_cfg or OptConfig(total_steps=loop.steps,
                                   warmup_steps=max(2, loop.steps // 20),
                                   schedule=cfg.schedule,
                                   factored=cfg.opt_factored)
    step_fn = make_train_step(cfg, opt_cfg, grad_accum=loop.grad_accum)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=loop.seq_len,
                                  global_batch=loop.global_batch,
                                  seed=loop.seed))
    saver = ckpt.AsyncCheckpointer(keep=loop.keep)
    handler = handler or PreemptionHandler(signals=())
    monitor = StragglerMonitor(n_hosts=1)

    state = init_train_state(init_params(cfg, loop.seed, device=dev),
                             factored=opt_cfg.factored)
    start = 0
    if resume_step is not None and loop.ckpt_dir:
        start, state, extra = ckpt.restore(loop.ckpt_dir, resume_step,
                                           template=state)
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
                print(f"step {step:5d} loss {metrics['loss']:.4f} "
                      f"gnorm {metrics['grad_norm']:.3f} {dt:.0f}ms")
            step += 1
            data.step = step
            if loop.ckpt_dir and step % loop.ckpt_every == 0:
                saver.save(loop.ckpt_dir, step, state,
                           extra={"data": data.state_dict()})
                saved = step
            if handler.should_stop:
                break
    finally:
        saver.wait()    # a save in flight is a restore point: finish it
    # the last step reached, unless the periodic save just wrote it (the
    # reference saves it again, and the rename onto the published
    # directory fails)
    if loop.ckpt_dir and step != saved:
        ckpt.save(loop.ckpt_dir, step, state,
                  extra={"data": data.state_dict()}, keep=loop.keep)
    return {"final": metrics, "history": history, "state": state}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL; one device only (1x1)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.mesh != "1x1":
        ap.error(f"--mesh {args.mesh}: a device mesh belongs to a later "
                 "slice of the port (ROADMAP A12.2); this driver trains on "
                 "one device (--mesh 1x1)")

    cfg = (reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    loop = TrainLoopConfig(steps=args.steps, global_batch=args.batch,
                           seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                           grad_accum=args.grad_accum,
                           max_restarts=args.max_restarts)
    with PreemptionHandler(signals=(signal.SIGTERM,)) as handler:
        def run(resume):
            out = train_loop(cfg, loop, device=args.device,
                             resume_step=resume, handler=handler)
            print(json.dumps(out["final"], indent=1))
            return loop.steps

        if args.ckpt_dir:
            run_with_recovery(run, lambda: ckpt.latest_step(args.ckpt_dir),
                              max_restarts=args.max_restarts)
        else:
            run(None)


if __name__ == "__main__":
    main()
