"""Deterministic, resumable, shard-aware synthetic LM data pipeline (the
port's own copy of ``repro.data.pipeline``: pure numpy, so batches are
bitwise the reference's for every ``(seed, step, host_slice)``).

Produces a reproducible token stream: batch ``i`` is a pure function of
``(seed, i)``, so checkpoint/restore and *elastic re-sharding* (resuming
with a different data-parallel width) replay the exact same stream —
the property large-scale training actually needs from its input pipeline.
A host in a multi-process job materializes only its addressable slice
(``host_slice``); in this single-process environment that is the whole
batch.

The synthetic distribution is a Zipfian token mix with Markovian
repetition so that next-token prediction has learnable structure (used by
the training loop to show loss descent).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

__all__ = ["DataConfig", "SyntheticLM"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    repeat_p: float = 0.35  # P(copy a recent token) -> learnable structure


class SyntheticLM:
    """Stateful iterator with explicit, checkpointable state (the step)."""

    def __init__(self, cfg: DataConfig, step: int = 0,
                 host_slice: Optional[Tuple[int, int]] = None):
        self.cfg = cfg
        self.step = step
        lo, hi = host_slice or (0, cfg.global_batch)
        self._lo, self._hi = lo, hi
        # Zipf-ish unnormalized weights over a base vocab region.
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        w = ranks ** -cfg.zipf_a
        self._probs = w / w.sum()

    # --- checkpointable state ---
    def state_dict(self) -> Dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, state: Dict):
        assert state["seed"] == self.cfg.seed, "data seed mismatch"
        self.step = int(state["step"])

    # --- iteration ---
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self.make_batch(self.step)
        self.step += 1
        return batch

    def make_batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        n = self._hi - self._lo
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self._lo]))
        base = rng.choice(cfg.vocab, size=(n, cfg.seq_len + 1),
                          p=self._probs).astype(np.int32)
        # Markovian repetition: with prob repeat_p, copy the token 2 back.
        rep = rng.random((n, cfg.seq_len + 1)) < cfg.repeat_p
        for t in range(2, cfg.seq_len + 1):
            base[:, t] = np.where(rep[:, t], base[:, t - 2], base[:, t])
        return {"tokens": base[:, :-1], "labels": base[:, 1:]}
