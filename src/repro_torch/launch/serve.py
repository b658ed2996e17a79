"""Batched serving driver of the port: fixed-group prefill + greedy decode.

The port's ``repro.launch.serve.ServeEngine`` (non-continuous): requests
are served in groups of ``batch``, each group left-padded to a shared
prompt bucket, prefilled into a fresh cache and decoded step by step.
Static weights are quantized and encoded once at construction
(``quant.prepare_params`` + ``prepare_logits_head``); ``PREP_STATS``
stays flat while serving.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the tests do); a default-device engine without CUDA raises. The
continuous paged engine, speculative decoding, calibration and the replica
fleet are later slices (ROADMAP A7-A12).

  python -m repro_torch.launch.serve --arch deepseek-7b --reduced \\
      --batch 4 --prompt-len 32 --max-new 16 --quant fp8-mgs-serve-kv
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import (cast_params, decode_step, init_cache,
                                init_params, prefill)
from repro_torch.quant import prepare_logits_head, prepare_params

__all__ = ["ServeEngine", "Request", "bucket_for", "make_engine", "main",
           "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``cuda`` by default; the CPU only when asked. Never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port serves on the GPU by default; pass "
            "device='cpu' to run the plain twins on the CPU")
    return dev


def bucket_for(plen: int, buckets=None, *, block: int = 1) -> int:
    """The padded prompt length a request of ``plen`` tokens is served at:
    the smallest warmed bucket that fits, else ``plen`` rounded up to
    ``block``."""
    if buckets:
        for b in buckets:
            if b >= plen:
                return int(b)
    return -(-plen // block) * block


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray             # (prompt_len,) int32
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Fixed-batch prefill/decode engine with greedy sampling.

    Args:
      cfg: model config (dense family); ``cfg.quant`` selects the numerics.
      batch: requests per group.
      max_len: cache length (prompt bucket + new tokens must fit).
      params: parameter tree (``init_params`` layout) on ``device``;
        ``None`` draws random weights from ``seed`` on the device.
      device: ``"cuda"`` (default) or ``"cpu"``.
    """

    def __init__(self, cfg: ModelConfig, *, batch: int, max_len: int,
                 params=None, seed: int = 0, eos_id: Optional[int] = None,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.eos_id = eos_id
        self._buckets: Optional[List[int]] = None
        if params is None:
            params = init_params(cfg, seed, device=self.device)
        params = prepare_params(params, cfg.quant)
        params = prepare_logits_head(params, cfg.quant,
                                     tied=cfg.tie_embeddings)
        self.params = cast_params(params, cfg)

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(toks, dtype=torch.int64, device=self.device)

    @torch.no_grad()
    def warmup(self, plen_buckets, *, max_new: int = 1, seed: int = 0):
        """Run each prompt bucket once (prefill + ``max_new`` decode steps)
        before traffic: builds the kernels and fixes the buckets that
        :meth:`run` pads to. Returns the sorted bucket list."""
        buckets = sorted({int(b) for b in plen_buckets})
        bad = [b for b in buckets if b <= 0 or b + max_new > self.max_len]
        if bad:
            raise ValueError(f"warmup buckets {bad} out of range for "
                             f"max_len={self.max_len}, max_new={max_new}")
        rng = np.random.default_rng(seed)
        for plen in buckets:
            toks = rng.integers(1, self.cfg.vocab, (self.batch, plen))
            cache = init_cache(self.cfg, self.batch, self.max_len,
                               device=self.device)
            logits, cache = prefill(self.params, self.cfg,
                                    {"tokens": self._tokens(toks)}, cache)
            for _ in range(max_new):
                cur = logits.argmax(dim=-1)[:, None]
                logits, cache = decode_step(self.params, self.cfg, cur,
                                            cache)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._buckets = buckets
        return buckets

    @torch.no_grad()
    def run(self, requests: List[Request], *,
            record_logits: bool = False) -> Dict[str, Any]:
        """Serve ``requests`` in fixed-size groups; fills ``out_tokens``.

        Returns stats (``prefill_tokens``, ``decode_tokens``, ``wall_s``,
        ``decode_tok_per_s``), plus the float32 logits row behind every
        emitted token under ``logits`` when ``record_logits``.
        """
        t_start = time.time()
        n_prefill = n_decode = 0
        logits_log: Dict[int, List[np.ndarray]] = {}
        for i in range(0, len(requests), self.batch):
            group = requests[i:i + self.batch]
            plen = bucket_for(max(len(r.prompt) for r in group),
                              self._buckets)
            toks = np.zeros((self.batch, plen), np.int64)
            for j, r in enumerate(group):
                toks[j, plen - len(r.prompt):] = r.prompt   # left-pad
            cache = init_cache(self.cfg, self.batch, self.max_len,
                               device=self.device)
            logits, cache = prefill(self.params, self.cfg,
                                    {"tokens": self._tokens(toks)}, cache)
            n_prefill += plen * len(group)
            cur = logits.argmax(dim=-1)[:, None]
            max_new = max(r.max_new_tokens for r in group)
            for _ in range(max_new):
                cur_h = cur.cpu().numpy()
                rows = logits.float().cpu().numpy() if record_logits else None
                for j, r in enumerate(group):
                    if not r.done and len(r.out_tokens) < r.max_new_tokens:
                        tok = int(cur_h[j, 0])
                        r.out_tokens.append(tok)
                        n_decode += 1
                        if record_logits:
                            logits_log.setdefault(r.rid, []).append(
                                rows[j].copy())
                        if self.eos_id is not None and tok == self.eos_id:
                            r.done = True
                if all(r.done or len(r.out_tokens) >= r.max_new_tokens
                       for r in group):
                    break
                logits, cache = decode_step(self.params, self.cfg, cur,
                                            cache)
                cur = logits.argmax(dim=-1)[:, None]
            for r in group:
                r.done = True
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.time() - t_start
        stats: Dict[str, Any] = {
            "prefill_tokens": n_prefill, "decode_tokens": n_decode,
            "wall_s": dt, "decode_tok_per_s": n_decode / max(dt, 1e-9)}
        if record_logits:
            stats["logits"] = logits_log
        return stats


def make_engine(cfg: ModelConfig, *, batch: int, max_len: int, params=None,
                seed: int = 0, eos_id: Optional[int] = None, device=None,
                continuous: bool = False,
                spec_k: Optional[int] = None) -> ServeEngine:
    """Engine factory (the group engine; the continuous and speculative
    engines are ROADMAP items A7/A8)."""
    if continuous or spec_k is not None:
        raise NotImplementedError("the continuous paged engine and "
                                  "speculative decoding are ROADMAP items "
                                  "A7/A8 of the port")
    return ServeEngine(cfg, batch=batch, max_len=max_len, params=params,
                       seed=seed, eos_id=eos_id, device=device)


_QUANTS = {"none": "NONE", "fp8-mgs-serve": "FP8_MGS_SERVE",
           "fp8-mgs-serve-kv": "FP8_MGS_SERVE_KV"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--quant", default="none", choices=sorted(_QUANTS),
                    help="quant preset (the reference CLI serves the arch's "
                         "own config, dtype none)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    for flag in ("--mesh", "--replicas", "--scheduler", "--spec-k",
                 "--draft-layers"):
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS)
    for flag in ("--continuous", "--no-deterministic"):
        ap.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    later = [f for f in ("mesh", "replicas", "scheduler", "spec_k",
                         "draft_layers", "continuous", "no_deterministic")
             if getattr(args, f) not in (None, False)]
    if later:
        ap.error(f"--{later[0].replace('_', '-')} belongs to a later slice "
                 "of the port (ROADMAP A7, A8, A12)")

    from repro_torch.quant import config as qconfig
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    cfg = dataclasses.replace(cfg, quant=getattr(qconfig, _QUANTS[args.quant]))
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, args.prompt_len
                                               ).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.n_requests)]
    engine = make_engine(cfg, batch=args.batch,
                         max_len=args.prompt_len + args.max_new + 1,
                         device=args.device)
    stats = engine.run(reqs)
    print(stats)
    for r in reqs[:2]:
        print(f"req {r.rid}: {r.out_tokens[:10]}")


if __name__ == "__main__":
    main()
