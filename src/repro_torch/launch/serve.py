"""Serving engines of the port: fixed-group and continuous batching.

The port's ``repro.launch.serve``:

* :class:`ServeEngine` — requests are served in groups of ``batch``, each
  group left-padded to a shared prompt bucket, prefilled into a fresh
  cache and decoded step by step;
* :class:`ContinuousBatchingEngine` — slot-level admission over the paged
  packed-FP8 KV pool: batch-1 prefill, adoption into free blocks, one
  ``(slots, 1)`` decode step for every resident request, release on
  completion; with ``spec_k`` each round drafts ``spec_k - 1`` tokens with
  the first ``draft_layers`` layers and verifies all of them in one
  multi-query step, bitwise equal to sequential decode.

Static weights are quantized and encoded once at construction
(``quant.prepare_params`` + ``prepare_logits_head``); ``PREP_STATS``
stays flat while serving.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the tests do); a default-device engine without CUDA raises. Calibration
and the replica fleet are later slices (ROADMAP A9, A12).

  python -m repro_torch.launch.serve --arch deepseek-7b --reduced \\
      --batch 4 --prompt-len 32 --max-new 16 --quant fp8-mgs-serve-kv
  python -m repro_torch.launch.serve --reduced --continuous --spec-k 2 \\
      --draft-layers 1 --quant fp8-mgs-serve-paged --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import (adopt_slot, cast_params, decode_step,
                                decode_step_paged, draft_step_paged,
                                init_cache, init_paged_cache, init_params,
                                prefill, release_slot, rewind_slots,
                                verify_step_paged)
from repro_torch.quant import (BlockAllocator, prepare_logits_head,
                               prepare_params)

__all__ = ["ServeEngine", "ContinuousBatchingEngine", "Request",
           "bucket_for", "make_engine", "main", "resolve_device"]


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


@dataclasses.dataclass
class _Slot:
    """Book-keeping for one occupied decode slot (host-side only)."""
    req: Request
    blocks: List[int]
    arrival: float
    admit_s: float
    cur: int                       # token to feed at the next decode step


class ContinuousBatchingEngine(ServeEngine):
    """Slot-level continuous batching over the paged KV pool.

    Each of the ``slots`` decode lanes holds one request; new requests are
    admitted into free lanes between decode steps of the in-flight ones
    (batch-1 prefill at a bucket length, then ``adopt_slot`` copies the
    prefill cache into allocated pool blocks), and a finished request
    releases its lane and blocks at once. The decode step is always
    ``(slots, 1)`` over the shared pool (``models.decode_step_paged``).

    Determinism contract: a request's logits and tokens are bitwise equal
    to a run of that request alone on the same engine, whatever the
    admission order, slot, neighbours or block placement. This needs
    ``quant.per_row_act`` (enforced here) on top of the packed cache.

    With ``spec_k`` each round runs ``spec_k - 1`` truncated-layer draft
    steps and one multi-query verify (``models.verify_step_paged``), and
    accepts the longest draft prefix equal to the verify argmaxes; the
    rejected tail is zeroed out of the pool (``models.rewind_slots``), so
    tokens and logits rows are bitwise those of sequential decode.
    ``stats["spec"]`` reports the acceptance rate.

    Calibration hooks (the reference's pinned per-slot amax, fenced table
    swaps and replay) are ROADMAP item A9.
    """

    def __init__(self, cfg: ModelConfig, *, slots: int, max_len: int,
                 n_blocks: Optional[int] = None, params=None, seed: int = 0,
                 eos_id: Optional[int] = None,
                 spec_k: Optional[int] = None, device=None):
        if not cfg.quant.per_row_act:
            raise ValueError(
                "ContinuousBatchingEngine requires quant.per_row_act=True: "
                "per-tensor activation scales couple co-scheduled slots "
                "through a shared absmax, breaking the traffic-invariance "
                "contract (use e.g. quant.config.FP8_MGS_SERVE_PAGED)")
        if spec_k is not None and spec_k < 1:
            raise ValueError(f"spec_k must be >= 1 (got {spec_k}); use "
                             f"spec_k=None for plain sequential decode")
        self.spec_k = spec_k
        super().__init__(cfg, batch=1, max_len=max_len, params=params,
                         seed=seed, eos_id=eos_id, device=device)
        self.slots = slots
        self.block_size = cfg.quant.block_k
        self.n_table = -(-max_len // self.block_size)
        # default pool: every slot can hold a full table of live blocks
        # (+ the reserved trash block 0)
        self.n_blocks = (slots * self.n_table + 1 if n_blocks is None
                         else n_blocks)
        self.cache = init_paged_cache(cfg, slots, max_len, self.n_blocks,
                                      device=self.device)
        self.alloc = BlockAllocator(self.n_blocks)
        self._free_slots = deque(range(slots))
        self._cur = np.zeros((slots, 1), np.int64)
        self._logits_log: Optional[Dict[int, List[np.ndarray]]] = None

    @torch.no_grad()
    def warmup(self, plen_buckets, *, max_new: int = 1, seed: int = 0):
        """Serve one dummy request per bucket through the real
        admit/decode/release cycle (builds the kernels) and fix the buckets
        that admission pads to. The pool is empty again on return."""
        buckets = sorted({int(b) for b in plen_buckets})
        pad = self.spec_k - 1 if self.spec_k else 0
        bad = [b for b in buckets
               if b <= 0
               or -(-(b + max_new + pad) // self.block_size) > self.n_table]
        if bad:
            raise ValueError(f"warmup buckets {bad} out of range for "
                             f"max_len={self.max_len}, max_new={max_new}")
        self._buckets = buckets
        rng = np.random.default_rng(seed)
        for plen in buckets:
            req = Request(rid=-1,
                          prompt=rng.integers(1, self.cfg.vocab, plen)
                          .astype(np.int32),
                          max_new_tokens=max_new)
            self.serve([req])
        return buckets

    def _admit(self, req: Request, arrival: float, t0: float,
               active: Dict[int, _Slot]) -> Optional[_Slot]:
        """Try to admit one request; None if no slot/blocks right now."""
        plen = len(req.prompt)
        bucket = bucket_for(plen, self._buckets, block=self.block_size)
        # reserve spec_k - 1 extra rows: a verify round starting at the
        # last sequential position appends that far past it before the
        # rejected tail is rewound
        pad = self.spec_k - 1 if self.spec_k else 0
        n_alloc = -(-(bucket + req.max_new_tokens + pad)
                    // self.block_size)
        if n_alloc > self.n_table:
            raise ValueError(
                f"request {req.rid}: bucket {bucket} + "
                f"max_new {req.max_new_tokens} (+ {pad} speculative "
                f"headroom) needs {n_alloc} blocks > "
                f"table width {self.n_table} (raise max_len)")
        if not self._free_slots or self.alloc.n_free < n_alloc:
            return None
        slot = self._free_slots.popleft()
        blocks = self.alloc.alloc(n_alloc)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, bucket - plen:] = req.prompt          # left-pad
        pcache = init_cache(self.cfg, 1, bucket, device=self.device)
        logits, pcache = prefill(self.params, self.cfg,
                                 {"tokens": self._tokens(toks)}, pcache)
        phys = np.zeros(self.n_table, np.int32)       # tail -> trash block
        phys[:n_alloc] = blocks
        adopt_slot(self.cache, pcache, slot, phys)
        row = logits[0].float().cpu().numpy()
        st = _Slot(req=req, blocks=blocks, arrival=arrival,
                   admit_s=time.monotonic() - t0, cur=int(row.argmax()))
        active[slot] = st
        self._harvest(slot, st, active, row)
        return st

    def _harvest(self, slot: int, st: _Slot, active: Dict[int, _Slot],
                 logits_row: np.ndarray):
        """Record one generated token; release the slot when done."""
        st.req.out_tokens.append(st.cur)
        if self._logits_log is not None:
            self._logits_log.setdefault(st.req.rid, []).append(
                logits_row.copy())
        if (self.eos_id is not None and st.cur == self.eos_id) \
                or len(st.req.out_tokens) >= st.req.max_new_tokens:
            st.req.done = True
            release_slot(self.cache, slot)
            self.alloc.free(st.blocks)
            self._free_slots.append(slot)
            self._cur[slot, 0] = 0
            del active[slot]

    def _spec_round(self, cur: torch.Tensor):
        """``spec_k - 1`` chained draft steps, then one verify of
        ``[cur, drafts]``. Returns ``(tokens (slots, k), logits
        (slots, k, V))``."""
        toks = [cur]
        for j in range(self.spec_k - 1):
            dlog, _ = draft_step_paged(self.params, self.cfg, toks[-1],
                                       self.cache, j)
            toks.append(dlog.argmax(dim=-1)[:, None])
        tokens = torch.cat(toks, dim=1)
        logits, _ = verify_step_paged(self.params, self.cfg, tokens,
                                      self.cache)
        return tokens, logits

    @torch.no_grad()
    def serve(self, requests: List[Request], *, arrivals=None,
              record_logits: bool = False, feed=None,
              on_done=None) -> Dict[str, Any]:
        """Serve requests with continuous (slot-level) admission.

        ``arrivals``: optional per-request arrival offsets in seconds (same
        order as ``requests``); a request becomes admissible once that much
        wall-clock has elapsed (default: all at once, in list order).
        ``feed``: optional zero-arg callable polled once per scheduling
        round; the requests it returns join the queue mid-flight.
        ``on_done``: optional callback per finished request.

        Returns ``prefill_tokens``, ``decode_tokens``, ``steps`` (decode
        steps, or speculative rounds), ``step_s`` (host-clock seconds of
        each step or round, its logits read back included),
        ``mid_flight_admissions`` (requests admitted beside a resident one
        after decoding began), ``wall_s``,
        ``decode_tok_per_s``, per-request ``timing[rid] = (arrival_s,
        admit_s, done_s)``, ``spec`` under speculation, and the float32
        logits row behind every token under ``logits`` when
        ``record_logits``.
        """
        if arrivals is None:
            arrivals = [0.0] * len(requests)
        if len(arrivals) != len(requests):
            raise ValueError("arrivals must parallel requests")
        self._logits_log = {} if record_logits else None
        t0 = time.monotonic()
        waiting = deque(zip(arrivals, requests))
        active: Dict[int, _Slot] = {}
        timing: Dict[int, Any] = {}
        step_s: List[float] = []
        n_prefill = n_decode = n_mid = 0
        n_drafted = n_accepted = 0

        def finish(req: Request, arrival: float, admit_s: float):
            nonlocal n_decode
            n_decode += len(req.out_tokens)
            timing[req.rid] = (arrival, admit_s, time.monotonic() - t0)
            if on_done is not None:
                on_done(req)

        while True:
            now = time.monotonic() - t0
            if feed is not None:
                for req in feed():
                    waiting.append((now, req))
            decoding = bool(active)      # residents of earlier rounds
            while waiting and waiting[0][0] <= now:
                arr, req = waiting[0]
                st = self._admit(req, arr, t0, active)
                if st is None:
                    break
                waiting.popleft()
                n_mid += decoding
                n_prefill += bucket_for(len(req.prompt), self._buckets,
                                        block=self.block_size)
                if req.done:                      # done at first token
                    finish(req, arr, st.admit_s)
            if not active:
                if waiting:
                    time.sleep(min(1e-3, max(0.0, waiting[0][0] - now)))
                    continue
                break
            for slot, st in active.items():
                self._cur[slot, 0] = st.cur
            cur = self._tokens(self._cur)
            t_step = time.perf_counter()
            if self.spec_k:
                k = self.spec_k
                tokens, logits = self._spec_round(cur)
                targets = logits.argmax(dim=-1).cpu().numpy()
                tokens_np = tokens.cpu().numpy()
                rows = logits.float().cpu().numpy()   # (slots, k, vocab)
                step_s.append(time.perf_counter() - t_step)
                keep = np.zeros(self.slots, np.int32)
                for slot in list(active):
                    st = active[slot]
                    # exact acceptance: drafts survive while they equal
                    # the verify argmax at their position
                    a = 0
                    while (a + 1 < k and tokens_np[slot, a + 1]
                           == targets[slot, a]):
                        a += 1
                    n_drafted += k - 1
                    n_accepted += a
                    keep[slot] = a + 1
                    for j in range(a + 1):
                        st.cur = int(targets[slot, j])
                        self._harvest(slot, st, active, rows[slot, j])
                        if st.req.done:
                            finish(st.req, st.arrival, st.admit_s)
                            break
                # released slots have pos == 0 and are skipped; live ones
                # advance by their accepted count and shed the rejected rows
                rewind_slots(self.cache, keep, k)
            else:
                logits, _ = decode_step_paged(self.params, self.cfg, cur,
                                              self.cache)
                rows = logits.float().cpu().numpy()
                step_s.append(time.perf_counter() - t_step)
                for slot in list(active):
                    st = active[slot]
                    st.cur = int(rows[slot].argmax())
                    self._harvest(slot, st, active, rows[slot])
                    if st.req.done:
                        finish(st.req, st.arrival, st.admit_s)
        dt = time.monotonic() - t0
        stats: Dict[str, Any] = {
            "prefill_tokens": n_prefill, "decode_tokens": n_decode,
            "steps": len(step_s), "step_s": step_s,
            "mid_flight_admissions": n_mid, "wall_s": dt,
            "decode_tok_per_s": n_decode / max(dt, 1e-9),
            "timing": timing}
        if self.spec_k:
            stats["spec"] = {
                "k": self.spec_k,
                "draft_layers": self.cfg.quant.draft_layers,
                "drafted": n_drafted, "accepted": n_accepted,
                "acceptance_rate": n_accepted / max(n_drafted, 1),
                "tokens_per_round": n_decode / max(len(step_s), 1)}
        if record_logits:
            stats["logits"] = self._logits_log
        self._logits_log = None
        return stats

    def run(self, requests: List[Request], **kw) -> Dict[str, Any]:
        """The group-mode entry point is replaced by :meth:`serve`."""
        if kw:
            raise NotImplementedError(
                "the continuous engine serves via .serve(); "
                f"ServeEngine.run keywords {sorted(kw)} do not apply")
        return self.serve(requests)


def make_engine(cfg: ModelConfig, *, batch: int, max_len: int, params=None,
                seed: int = 0, eos_id: Optional[int] = None, device=None,
                continuous: bool = False,
                spec_k: Optional[int] = None) -> ServeEngine:
    """Engine factory: a :class:`ServeEngine`, or with ``continuous=True`` a
    :class:`ContinuousBatchingEngine` with ``batch`` decode slots
    (``spec_k`` turns on speculative decoding there)."""
    if continuous:
        return ContinuousBatchingEngine(
            cfg, slots=batch, max_len=max_len, params=params, seed=seed,
            eos_id=eos_id, spec_k=spec_k, device=device)
    if spec_k is not None:
        raise ValueError("spec_k requires continuous=True: speculative "
                         "decoding runs on the paged continuous engine")
    return ServeEngine(cfg, batch=batch, max_len=max_len, params=params,
                       seed=seed, eos_id=eos_id, device=device)


_QUANTS = {"none": "NONE", "fp8-mgs-serve": "FP8_MGS_SERVE",
           "fp8-mgs-serve-kv": "FP8_MGS_SERVE_KV",
           "fp8-mgs-serve-paged": "FP8_MGS_SERVE_PAGED"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="group size, or decode slots with --continuous")
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--quant", default="none", choices=sorted(_QUANTS),
                    help="quant preset (the reference CLI serves the arch's "
                         "own config, dtype none)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--continuous", action="store_true",
                    help="slot-level continuous batching over the paged KV "
                         "pool (needs --quant fp8-mgs-serve-paged)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative depth for --continuous: k-1 drafts "
                         "and one k-token verify per round (0 = off)")
    ap.add_argument("--draft-layers", type=int, default=0,
                    help="layers of the self-draft pass (0 = half the "
                         "stack)")
    for flag in ("--mesh", "--replicas", "--scheduler"):
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--no-deterministic", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    later = [f for f in ("mesh", "replicas", "scheduler", "no_deterministic")
             if getattr(args, f) not in (None, False)]
    if later:
        ap.error(f"--{later[0].replace('_', '-')} belongs to a later slice "
                 "of the port (ROADMAP A12)")

    from repro_torch.quant import config as qconfig
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    quant = getattr(qconfig, _QUANTS[args.quant])
    if args.continuous:
        if not quant.per_row_act:
            ap.error("--continuous needs per-row activation scales: "
                     "--quant fp8-mgs-serve-paged")
        if args.spec_k:
            quant = quant.replace(draft_layers=args.draft_layers
                                  or max(1, cfg.n_layers // 2))
    elif args.spec_k:
        ap.error("--spec-k requires --continuous (speculation runs on the "
                 "paged continuous engine)")
    cfg = dataclasses.replace(cfg, quant=quant)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, args.prompt_len
                                               ).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.n_requests)]
    engine = make_engine(cfg, batch=args.batch,
                         max_len=(args.prompt_len + args.max_new + 1
                                  + max(args.spec_k - 1, 0)),
                         device=args.device, continuous=args.continuous,
                         spec_k=args.spec_k or None)
    if args.continuous:
        engine.warmup([args.prompt_len], max_new=1)
        stats = engine.serve(reqs)
        stats.pop("step_s")
    else:
        stats = engine.run(reqs)
    print(stats)
    for r in reqs[:2]:
        print(f"req {r.rid}: {r.out_tokens[:10]}")


if __name__ == "__main__":
    main()
