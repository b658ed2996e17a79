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

Calibration (``quant.calibrate``, ``quant.streaming``): ``calibrate``
records per-site activation limb sigmas and the decode-query absmax in one
pass; ``apply_calibration`` installs a table as a new version, whose
runtime state (per-site flush periods, the static decode-query amax) the
engine applies around every model call; every request records the
version it was served under, and ``replay`` re-serves it under that
version bitwise, after any number of swaps. A swap builds nothing and
prepares nothing. ``enable_streaming`` + ``maybe_refresh_calibration``
refresh the table from gated shadow passes over live traffic.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the tests do); a default-device engine without CUDA raises. ``run``'s
``injector`` / ``deadline_s`` / ``should_abort`` are the seam of the
replica fleet (``launch.replica``), which ``--replicas`` serves through.

Sharded serving: ``ServeEngine(..., mesh=)`` on a
:class:`~repro_torch.parallel.comm.RankMesh` (one ``torch.distributed``
rank per mesh position, each constructing the engine) serves dense and MoE
stacks under the reference's ``make_rules(mesh, "serve",
shard_batch=False)``: every rank builds its slice of the prepared planes,
batch-indexed activations are replicated, and each request's logits and
tokens are bitwise the one-device engine's.
``ContinuousBatchingEngine(..., mesh=)`` does the same for the paged
engine (dense stacks, speculation included): the pool holds the rank's kv
heads, and the ranks agree once a scheduling round on how many waiting
requests to admit. ``--mesh DxM`` starts the ranks
(``parallel.comm.launch``; ``--share-device`` puts them all on one card
over gloo) and rank 0's result is printed. The other families, numerics
other than the fused exact kernels (B1 / B3), calibration, ``feed=`` and
``--no-deterministic`` on a mesh are ROADMAP A12.2c.

  python -m repro_torch.launch.serve --arch deepseek-7b --reduced \\
      --batch 4 --prompt-len 32 --max-new 16 --quant fp8-mgs-serve-kv
  python -m repro_torch.launch.serve --reduced --continuous --spec-k 2 \\
      --draft-layers 1 --quant fp8-mgs-serve-paged --device cpu
  python -m repro_torch.launch.serve --arch deepseek-7b --reduced \\
      --replicas 2 --device cpu
  python -m repro_torch.launch.serve --arch deepseek-7b --reduced \\
      --mesh 1x2 --quant fp8-mgs-serve-kv --device cpu
  python -m repro_torch.launch.serve --arch deepseek-7b --reduced \\
      --mesh 1x2 --continuous --spec-k 2 --quant fp8-mgs-serve-paged \\
      --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.markov import plan_flush_period
from repro_torch.models import (adopt_slot, cast_params, decode_step,
                                decode_step_paged, draft_step_paged,
                                init_cache, init_paged_cache, init_params,
                                prefill, release_slot, rewind_slots,
                                verify_step_paged)
from repro_torch.models.transformer import _require_paged_arch, param_dims
from repro_torch.parallel.sharding import make_rules, use_rules
from repro_torch.quant import (BlockAllocator, PreparedWeight, calibrating,
                               prepare_logits_head, prepare_params)
from repro_torch.quant.calibrate import CalibrationTable, applied_calib_state
from repro_torch.quant.streaming import StreamingCalibrator, sample_gate
from repro_torch.runtime.fault_tolerance import DeadlineExceeded

__all__ = ["ServeEngine", "ContinuousBatchingEngine", "Request",
           "bucket_for", "make_engine", "main", "resolve_device",
           "mesh_refusal"]


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


def _site_of(path) -> Optional[str]:
    """The calibration site of a prepared weight at ``path``: the
    ``parent.name`` convention of the model's call sites (``"ffn.wg"``,
    ``"attn.wq"``, ...); the unembedding weights are ``"logits"``."""
    if path and path[-1] in ("unembed", "unembed_prepared"):
        return "logits"
    return f"{path[-2]}.{path[-1]}" if len(path) >= 2 else None


def _stamp_act_sigmas(params, table: CalibrationTable):
    """Stamp each PreparedWeight with its call site's observed act sigma
    (planes shared, nothing rebuilt)."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, PreparedWeight):
            sigma = table.sigma(_site_of(path))
            if sigma is not None:
                return node.with_act_sigma(sigma)
        return node

    return walk(params, ())


def mesh_refusal(cfg: ModelConfig) -> Optional[str]:
    """Why ``cfg`` cannot be served on a mesh of ranks in this slice
    (``None``: it can)."""
    q = cfg.quant
    if (cfg.is_hybrid or cfg.is_ssm_only or cfg.encoder_layers
            or cfg.vision_prefix):
        return (f"{cfg.name}: sharded serving covers dense and MoE stacks; "
                "SSM / hybrid / encoder-decoder / VLM on a mesh is ROADMAP "
                "A12.2c")
    if not (q.is_fp8 and q.accum == "mgs_exact" and q.use_kernel
            and q.fused):
        return ("sharded serving runs the fused exact kernels, B1 or B3 "
                "(fp8, mgs_exact, use_kernel, fused; --quant fp8-mgs-serve"
                "[-kv|-paged]): raw float weights, B4 / B5 and the integer "
                "configs on a mesh are ROADMAP A12.2c")
    return None


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray             # (prompt_len,) int32
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    #: calibration-table version the request was served under (stamped at
    #: group start by the group engine, at admission by the continuous
    #: one); ``replay`` re-installs exactly this version
    table_version: int = 0


class ServeEngine:
    """Fixed-batch prefill/decode engine with greedy sampling.

    Args:
      cfg: model config (any family; an encoder-decoder or a VLM gets the
        reference's stub side inputs: zero frame / patch embeddings);
        ``cfg.quant`` selects the numerics.
      batch: requests per group.
      max_len: cache length (prompt bucket + new tokens must fit).
      params: parameter tree (``init_params`` layout) on ``device``;
        ``None`` draws random weights from ``seed`` on the device.
      calibration: a :class:`~repro_torch.quant.calibrate.CalibrationTable`
        to start from (installed as version 1, or its own version if
        higher); later tables go through :meth:`apply_calibration`.
      device: ``"cuda"`` (default) or ``"cpu"``.
      mesh: a :class:`~repro_torch.parallel.comm.RankMesh` of this
        process's rank (``launch.mesh.make_mesh`` / ``make_serve_mesh``);
        every rank constructs the engine on the same ``params`` (or
        ``seed``) and serves the same requests. Dense and MoE stacks under
        the fused exact kernels (``use_kernel``, ``fused``, ``mgs_exact``;
        B1, or B3 under a stationary ``schedule``); the rest raises
        (ROADMAP A12.2c). Raw leaves (embedding table, norms) stay
        whole on every rank: the lookup is a gather, and a table cut over
        vocab would need a masked sum that turns -0.0 into +0.0.
    """

    def __init__(self, cfg: ModelConfig, *, batch: int, max_len: int,
                 params=None, seed: int = 0, eos_id: Optional[int] = None,
                 calibration: Optional[CalibrationTable] = None,
                 device=None, mesh=None):
        self.device = resolve_device(device)
        if mesh is not None and mesh.size == 1:
            mesh = None
        self.mesh = mesh
        self.rules = None
        if mesh is not None:
            why = mesh_refusal(cfg)
            if why is None and calibration is not None:
                why = "calibration on a mesh is ROADMAP A12.2c"
            if why is not None:
                raise NotImplementedError(why)
            if mesh.device != self.device:
                raise ValueError(f"the mesh's rank runs on {mesh.device}, "
                                 f"the engine on {self.device}")
            self.rules = make_rules(mesh, "serve", shard_batch=False)
        if calibration is not None:
            cfg = dataclasses.replace(
                cfg, quant=cfg.quant.with_calibration(calibration))
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.eos_id = eos_id
        self._buckets: Optional[List[int]] = None
        if params is None:
            params = init_params(cfg, seed, device=self.device)
        dims = param_dims(cfg) if mesh is not None else None
        params = prepare_params(params, cfg.quant, hybrid=cfg.is_hybrid,
                                dims=dims, rules=self.rules)
        params = prepare_logits_head(params, cfg.quant,
                                     tied=cfg.tie_embeddings,
                                     rules=self.rules)
        if calibration is not None:
            params = _stamp_act_sigmas(params, calibration)
        self.params = cast_params(params, cfg)
        self._init_calib_runtime(calibration)

    # -- versioned runtime calibration state ---------------------------

    def _init_calib_runtime(self, calibration: Optional[CalibrationTable]):
        """Version bookkeeping and the runtime calibration state.

        ``self._calib_state`` is what the engine applies around each model
        call (``quant.calibrate.applied_calib_state``): ``{"flush": {site:
        period}}`` under ``flush_target`` and the decode-query amax under
        ``static_q_scale``. A swap replaces the state; versions and tables
        stay on the host.
        """
        self._site_wsigmas = self._collect_limb_sigmas(self.params)
        sites = set(self._site_wsigmas)
        if calibration is not None:
            sites |= {s for s, _ in calibration.to_pairs()
                      if not s.endswith(".amax")}
        self._flush_sites = sorted(sites)
        self._flush_host: Dict[str, int] = {}
        self._amax_value = 0.0
        self._tables: Dict[int, CalibrationTable] = {}
        self.table_version = 0
        if calibration is not None:
            v = calibration.version if calibration.version > 0 else 1
            if calibration.version != v:
                calibration = CalibrationTable.from_pairs(
                    calibration.to_pairs(), version=v)
            self._tables[v] = calibration
            self.table_version = v
        self._calib_state = self._build_calib_state(calibration)
        self._streaming: Optional[StreamingCalibrator] = None
        self._stream_seed = 0
        self._stream_index = 0
        self._replaying = False
        # guards the (version, state, host mirrors) swap against readers on
        # other threads; re-entrant for the continuous engine's override
        self._calib_lock = threading.RLock()

    @staticmethod
    def _collect_limb_sigmas(params) -> Dict[str, float]:
        """Per-site PreparedWeight limb sigma, keyed like the stamps."""
        out: Dict[str, float] = {}

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,))
            elif isinstance(node, PreparedWeight):
                site = _site_of(path)
                if site is not None:
                    out[site] = float(node.limb_sigma)

        walk(params, ())
        return out

    def _q_amax_state(self, values) -> Dict[str, Any]:
        """The decode-query amax entries of a state: the device tensor (a
        scalar or one per slot), its host-known range, and the cache of its
        per-row expansions."""
        a = np.asarray(values, np.float32)
        return {"q_amax": torch.as_tensor(a, device=self.device),
                "q_amax_min": float(a.min()), "q_amax_max": float(a.max()),
                "q_amax_rows": {}}

    def _build_calib_state(self, table: Optional[CalibrationTable]):
        """Runtime state for ``table`` (``None`` = uncalibrated plan): a
        pure function of the config, the weights' limb sigmas, the flush
        sites and ``table``, so replay rebuilds any version's values."""
        q = self.cfg.quant
        state: Dict[str, Any] = {}
        if q.flush_target is not None:
            self._flush_host = self._plan_flush_host(table)
            state["flush"] = self._flush_host
        if q.static_q_scale:
            a = table.sigma("attn.q.amax") if table is not None else None
            self._amax_value = float(a) if a is not None and a > 0 else 0.0
            state.update(self._q_amax_state(self._amax_value))
        return state or None

    def _plan_flush_host(self, table: Optional[CalibrationTable]
                         ) -> Dict[str, int]:
        """The flush plan ``table`` implies (pure, installs nothing); the
        continuous engine fences a swap whose plan differs."""
        q = self.cfg.quant
        if q.flush_target is None:
            return {}
        # clamped to the kernels' C int: any period past K flushes once
        return {
            s: min(2**31 - 1, plan_flush_period(
                q.block_k, target_overflow=q.flush_target,
                sigma_limb_x=(table.sigma(s) if table is not None
                              else None),
                sigma_limb_w=self._site_wsigmas.get(s)))
            for s in self._flush_sites}

    @contextlib.contextmanager
    def _pinned_state(self, version: int):
        """Temporarily re-install ``version``'s runtime state (replay);
        streaming observation is muted meanwhile."""
        if version != 0 and version not in self._tables:
            raise KeyError(f"no calibration table recorded for version "
                           f"{version} (known: {sorted(self._tables)})")
        table = self._tables.get(version)
        prev = (self._calib_state, self._flush_host, self._amax_value,
                self.table_version, self._replaying)
        rec = self._streaming.recorder if self._streaming else None
        prev_mute = rec.muted if rec is not None else None
        try:
            self._calib_state = self._build_calib_state(table)
            self.table_version = version
            self._replaying = True
            if rec is not None:
                rec.muted = True
            yield
        finally:
            (self._calib_state, self._flush_host, self._amax_value,
             self.table_version, self._replaying) = prev
            if rec is not None:
                rec.muted = prev_mute

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(toks, dtype=torch.int64, device=self.device)

    def _make_batch(self, toks: np.ndarray) -> Dict[str, Any]:
        """The prefill batch: the tokens, and the reference's stub side
        inputs (zero patch / frame embeddings in bfloat16) where the
        family takes them."""
        batch = {"tokens": self._tokens(toks)}
        B, cfg = toks.shape[0], self.cfg
        if cfg.vision_prefix:
            batch["vision_embeds"] = torch.zeros(
                (B, cfg.vision_prefix, cfg.d_model), dtype=torch.bfloat16,
                device=self.device)
        if cfg.encoder_layers:
            batch["audio_embeds"] = torch.zeros(
                (B, cfg.encoder_len, cfg.d_model), dtype=torch.bfloat16,
                device=self.device)
        return batch

    def _check_fits(self, plen: int, steps: int):
        """A prompt bucket, the vision prefix before it and the entries of
        ``steps`` decode steps must fit the cache (``max_len``)."""
        prefix = self.cfg.vision_prefix
        if plen <= 0 or prefix + plen + steps > self.max_len:
            raise ValueError(
                f"prompt bucket {plen} + {steps} decode steps"
                + (f" after the {prefix}-token vision prefix" if prefix
                   else "")
                + f" out of range for max_len={self.max_len}")

    def _prefill(self, toks: np.ndarray, cache, cs):
        with applied_calib_state(cs), use_rules(self.rules):
            return prefill(self.params, self.cfg, self._make_batch(toks),
                           cache)

    def _decode(self, cur: torch.Tensor, cache, cs):
        with applied_calib_state(cs), use_rules(self.rules):
            return decode_step(self.params, self.cfg, cur, cache)

    def _init_cache(self, batch: int):
        return init_cache(self.cfg, batch, self.max_len, device=self.device,
                          rules=self.rules)

    @torch.no_grad()
    def warmup(self, plen_buckets, *, max_new: int = 1, seed: int = 0):
        """Run each prompt bucket once (prefill + ``max_new`` decode steps)
        before traffic: builds the kernels and fixes the buckets that
        :meth:`run` pads to. Returns the sorted bucket list."""
        buckets = sorted({int(b) for b in plen_buckets})
        for b in buckets:
            self._check_fits(b, max_new)
        rng = np.random.default_rng(seed)
        for plen in buckets:
            toks = rng.integers(1, self.cfg.vocab, (self.batch, plen))
            cache = self._init_cache(self.batch)
            logits, cache = self._prefill(toks, cache, self._calib_state)
            for _ in range(max_new):
                cur = logits.argmax(dim=-1)[:, None]
                logits, cache = self._decode(cur, cache, self._calib_state)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self._buckets = buckets
        return buckets

    def apply_calibration(self, table: CalibrationTable) -> int:
        """Install a calibration table; returns its version.

        The first table also goes on the config and is stamped onto every
        :class:`~repro_torch.quant.PreparedWeight` (``act_sigma``; planes
        shared). Every table replaces the runtime state (flush periods,
        the static decode-query amax), which the next model call applies:
        nothing is rebuilt or prepared, so a swap is safe between decode
        steps under traffic. In-flight work keeps its plan: the group
        engine snapshots the state per group, the continuous engine pins
        the amax per slot at admission and fences plan changes until the
        resident requests drain.

        The version is monotone per engine: ``table.version`` when it
        advances the counter, else ``current + 1``. Every version's table
        is kept for :meth:`replay`.
        """
        with self._calib_lock:
            v = (table.version if table.version > self.table_version
                 else self.table_version + 1)
            if table.version != v:
                table = CalibrationTable.from_pairs(table.to_pairs(),
                                                    version=v)
            first = not self._tables
            self._tables[v] = table
            new_sites = {s for s, _ in table.to_pairs()
                         if not s.endswith(".amax")} - set(self._flush_sites)
            if new_sites:
                self._flush_sites = sorted(set(self._flush_sites)
                                           | new_sites)
            self.table_version = v
            if first:
                self.cfg = dataclasses.replace(
                    self.cfg, quant=self.cfg.quant.with_calibration(table))
                self.params = _stamp_act_sigmas(self.params, table)
            self._calib_state = self._build_calib_state(table)
            if self._streaming is not None:
                self._streaming.table = table
            return v

    def _record_pass(self, toks: np.ndarray, recorder=None):
        """One prefill + one decode step over ``toks`` under
        ``calibrating(recorder)``, outside any applied state, on the
        engine's device and kernels; returns the recorder."""
        if self.mesh is not None:
            raise NotImplementedError(
                "calibration on a mesh (per-rank histograms of K-sharded "
                "activations summed) is ROADMAP A12.2c")
        cache = init_cache(self.cfg, toks.shape[0], self.max_len,
                           device=self.device)
        with calibrating(recorder) as rec:
            logits, cache = prefill(self.params, self.cfg,
                                    self._make_batch(toks), cache)
            decode_step(self.params, self.cfg,
                        logits.argmax(dim=-1)[:, None], cache)
        return rec

    @torch.no_grad()
    def calibrate(self, prompts: Optional[List[np.ndarray]] = None, *,
                  update: bool = True, seed: int = 0) -> CalibrationTable:
        """One recording pass: a prefill over ``prompts`` (default: random
        tokens) and one decode step, under ``calibrating()``: every
        site-tagged matmul records its quantized activation's limb
        histogram, the decode query its absmax. Returns the
        :class:`CalibrationTable`; with ``update`` it is installed
        (:meth:`apply_calibration`)."""
        if prompts is None:
            rng = np.random.default_rng(seed)
            n = min(self.max_len - 1 - self.cfg.vision_prefix, 16)
            prompts = [rng.integers(1, self.cfg.vocab, n)
                       for _ in range(self.batch)]
        plen = max(len(p) for p in prompts)
        toks = np.zeros((self.batch, plen), np.int64)
        for j, p in enumerate(prompts[:self.batch]):
            toks[j, plen - len(p):] = p
        table = self._record_pass(toks).table()
        if update:
            self.apply_calibration(table)
        return table

    # -- streaming calibration (quant.streaming) -----------------------

    def enable_streaming(self, calibrator: Optional[StreamingCalibrator]
                         = None, *, seed: Optional[int] = None,
                         sample_period: int = 4,
                         **thresholds) -> StreamingCalibrator:
        """Attach a streaming calibrator: every ``sample_gate``-admitted
        unit of traffic (a group here, an admission on the continuous
        engine) also runs a shadow pass over its tokens under
        ``calibrating(recorder)``, beside the served pass, whose bits it
        never touches. ``thresholds`` go to :class:`StreamingCalibrator`.
        """
        if self.mesh is not None:
            raise NotImplementedError(
                "streaming calibration on a mesh is ROADMAP A12.2c")
        if calibrator is None:
            calibrator = StreamingCalibrator(
                self._tables.get(self.table_version,
                                 CalibrationTable({})),
                seed=seed if seed is not None else 0,
                sample_period=sample_period, **thresholds)
        self._streaming = calibrator
        self._stream_seed = seed if seed is not None else calibrator.seed
        return calibrator

    def maybe_refresh_calibration(self):
        """Drift-check the streaming statistics; swap in a refreshed table
        on drift. Returns the justifying ``DriftReport``, else ``None``."""
        if self._streaming is None:
            return None
        return self._streaming.maybe_refresh(self.apply_calibration)

    def _maybe_shadow(self, toks: np.ndarray):
        """The gated shadow pass of one unit of live traffic."""
        if self._streaming is None or self._replaying:
            return
        idx = self._stream_index
        self._stream_index += 1
        if sample_gate(self._stream_seed, idx, self._streaming.sample_period):
            self._shadow_pass(toks)

    @torch.no_grad()
    def _shadow_pass(self, toks: np.ndarray):
        """:meth:`calibrate`'s pass over gated traffic tokens into the
        streaming recorder; the outputs are discarded."""
        self._record_pass(toks, self._streaming.recorder)

    def replay(self, request: Request, version: Optional[int] = None, *,
               group: Optional[List[Request]] = None):
        """Re-serve a logged request under its recorded table version.

        Returns ``(replayed_request, stats)``; ``stats["logits"]`` holds
        the float32 logits row behind every token, bitwise those of the
        original run however many swaps happened since. ``version``
        defaults to ``request.table_version``. ``group``: the request's
        original co-members in order, required with per-tensor activation
        scales (``per_row_act=False``), where a member's quantization
        depends on the whole group.
        """
        version = request.table_version if version is None else version
        members = list(group) if group is not None else [request]
        idx = next((i for i, r in enumerate(members) if r is request), None)
        if idx is None:
            raise ValueError("request must be a member of its group")
        if group is None and not self.cfg.quant.per_row_act and \
                self.batch > 1:
            raise ValueError(
                "per-tensor activation scales couple group members: pass "
                "group=<the request's original co-members> to replay "
                "(per_row_act=False quant)")
        copies = [dataclasses.replace(r, out_tokens=[], done=False)
                  for r in members]
        with self._pinned_state(version):
            stats = self._replay_run(copies)
        return copies[idx], stats

    def _replay_run(self, copies: List[Request]) -> Dict[str, Any]:
        return self.run(copies, record_logits=True)

    @torch.no_grad()
    def run(self, requests: List[Request], *, injector=None,
            deadline_s: Optional[float] = None, should_abort=None,
            record_logits: bool = False) -> Dict[str, Any]:
        """Serve ``requests`` in fixed-size groups; fills ``out_tokens``.

        Each group runs under one snapshot of the runtime calibration
        state, stamped on its requests (``table_version``): a swap landing
        mid-group takes effect at the next group.

        The fault-tolerance seam the replica fleet threads through
        (``runtime.fault_tolerance``):

        * ``injector`` — an object with ``before_group()`` and
          ``on_decode(step)`` hooks, called as each group starts and
          before each decode step (a bound ``FaultInjector`` view);
        * ``deadline_s`` — per-group watchdog: a group (prefill + decode)
          past this wall-clock budget raises ``DeadlineExceeded`` at the
          next step boundary (cooperative: it catches hangs that surface
          between device calls);
        * ``should_abort`` — a callable polled at the same boundaries; True
          raises ``DeadlineExceeded`` (the supervisor's abort).

        After a raise the engine stays serviceable (each group builds its
        cache afresh), but the group's requests may hold partial
        ``out_tokens``: the caller resets them before a re-run.

        Returns stats (``prefill_tokens``, ``decode_tokens``, ``steps``
        (decode steps run), ``wall_s``, ``decode_tok_per_s``), plus the
        float32 logits row behind every emitted token under ``logits`` when
        ``record_logits``.
        """
        t_start = time.time()
        n_prefill = n_decode = n_steps = 0
        logits_log: Dict[int, List[np.ndarray]] = {}
        for i in range(0, len(requests), self.batch):
            group = requests[i:i + self.batch]
            t_group = time.time()
            with self._calib_lock:
                cs = self._calib_state
                ver = self.table_version
            for r in group:
                r.table_version = ver

            def watchdog():
                if should_abort is not None and should_abort():
                    raise DeadlineExceeded("aborted by supervisor")
                if (deadline_s is not None
                        and time.time() - t_group > deadline_s):
                    raise DeadlineExceeded(
                        f"group exceeded deadline_s={deadline_s}")

            if injector is not None:
                injector.before_group()
            watchdog()
            plen = bucket_for(max(len(r.prompt) for r in group),
                              self._buckets)
            max_new = max(r.max_new_tokens for r in group)
            self._check_fits(plen, max_new - 1)   # the last token: no step
            toks = np.zeros((self.batch, plen), np.int64)
            for j, r in enumerate(group):
                toks[j, plen - len(r.prompt):] = r.prompt   # left-pad
            self._maybe_shadow(toks)
            cache = self._init_cache(self.batch)
            logits, cache = self._prefill(toks, cache, cs)
            n_prefill += plen * len(group)
            watchdog()
            cur = logits.argmax(dim=-1)[:, None]
            for step in range(max_new):
                if injector is not None:
                    injector.on_decode(step + 1)
                watchdog()
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
                logits, cache = self._decode(cur, cache, cs)
                n_steps += 1
                cur = logits.argmax(dim=-1)[:, None]
            for r in group:
                r.done = True
        if self.device.type == "cuda":
            # this thread's stream only: a fleet's replicas share a card
            # on streams of their own
            torch.cuda.current_stream(self.device).synchronize()
        dt = time.time() - t_start
        stats: Dict[str, Any] = {
            "prefill_tokens": n_prefill, "decode_tokens": n_decode,
            "steps": n_steps, "wall_s": dt,
            "decode_tok_per_s": n_decode / max(dt, 1e-9)}
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

    Calibration: each slot pins the static decode-query amax of the table
    current at its admission (the state's per-slot vector, rebuilt on the
    device only at admission, release and swap), so a swap never moves a
    resident request's scale; a swap that changes the flush plan is fenced
    until the resident requests drain (:meth:`apply_calibration`).

    ``mesh``: as for :class:`ServeEngine`. The pool holds this rank's kv
    heads (``models.init_paged_cache(rules=)``; whole where they do not
    divide the model axis), each prefill cache is built under the rules and
    gathered whole along any cut of its sequence at adoption, and every
    model call runs under the rules. Decisions taken from logits (argmax,
    EOS, speculative acceptance, the rewind) are the same on every rank,
    because the logits are gathered whole and bitwise alike. Admission
    alone reads each rank's clock, so :meth:`serve` agrees once a
    scheduling round on how many waiting requests to admit (the most any
    rank's clock allows: ``RankMesh.agree``); slot and block availability
    is the same on every rank, because the allocators see the same calls.
    Calibration and ``feed=`` on a mesh are ROADMAP A12.2c.
    """

    def __init__(self, cfg: ModelConfig, *, slots: int, max_len: int,
                 n_blocks: Optional[int] = None, params=None, seed: int = 0,
                 eos_id: Optional[int] = None,
                 calibration: Optional[CalibrationTable] = None,
                 spec_k: Optional[int] = None, device=None, mesh=None):
        _require_paged_arch(cfg)    # before any weight is drawn or prepared
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
                         seed=seed, eos_id=eos_id, calibration=calibration,
                         device=device, mesh=mesh)
        self.slots = slots
        self.block_size = cfg.quant.block_k
        self.n_table = -(-max_len // self.block_size)
        # default pool: every slot can hold a full table of live blocks
        # (+ the reserved trash block 0)
        self.n_blocks = (slots * self.n_table + 1 if n_blocks is None
                         else n_blocks)
        self.cache = init_paged_cache(cfg, slots, max_len, self.n_blocks,
                                      device=self.device, rules=self.rules)
        self.alloc = BlockAllocator(self.n_blocks)
        self._free_slots = deque(range(slots))
        self._cur = np.zeros((slots, 1), np.int64)
        self._logits_log: Optional[Dict[int, List[np.ndarray]]] = None
        # per-slot decode-query amax pinned at admission (0 = free slot:
        # the dynamic reduce, never read); its device copy is rebuilt on
        # the next step after a change
        self._slot_amax = np.zeros(slots, np.float32)
        self._slot_state: Optional[Dict[str, Any]] = None
        # a flush-plan-changing table waits here until the slots drain
        self._pending: Optional[CalibrationTable] = None
        self._serving = False

    def _set_slot_amax(self, slot: int, value: float):
        self._slot_amax[slot] = value
        self._slot_state = None

    def _cs_decode(self):
        """The decode steps' state: the admission-pinned per-slot amaxes
        in place of the scalar."""
        cs = self._calib_state
        if cs is None or "q_amax" not in cs:
            return cs
        if self._slot_state is None:
            self._slot_state = self._q_amax_state(self._slot_amax)
        return {**cs, **self._slot_state}

    def _decode_paged(self, cur: torch.Tensor):
        """One paged decode step over every slot under the pinned state."""
        with applied_calib_state(self._cs_decode()), use_rules(self.rules):
            logits, _ = decode_step_paged(self.params, self.cfg, cur,
                                          self.cache)
        return logits

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
        self._maybe_shadow(toks)
        with self._calib_lock:
            # one consistent read: the version stamp, the slot's pinned
            # amax and the state the prefill runs under
            req.table_version = self.table_version
            self._set_slot_amax(slot, self._amax_value)
            cs = self._calib_state
        pcache = init_cache(self.cfg, 1, bucket, device=self.device,
                            rules=self.rules)
        logits, pcache = self._prefill(toks, pcache, cs)
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
            self._set_slot_amax(slot, 0.0)
            del active[slot]

    def _spec_round(self, cur: torch.Tensor):
        """``spec_k - 1`` chained draft steps, then one verify of
        ``[cur, drafts]``, under the pinned state. Returns ``(tokens
        (slots, k), logits (slots, k, V))``."""
        toks = [cur]
        with applied_calib_state(self._cs_decode()), use_rules(self.rules):
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
        wall-clock has elapsed (default: all at once, in list order). On a
        mesh the ranks agree each round on how many to admit: a request is
        admitted on every rank once any rank's clock has reached it.
        ``feed``: optional zero-arg callable polled once per scheduling
        round; the requests it returns join the queue mid-flight (not on a
        mesh: ROADMAP A12.2c).
        ``on_done``: optional callback per finished request. A fenced
        table (:meth:`apply_calibration`) pauses admission until the
        resident requests drain, installs, and admission resumes under it.

        Returns ``prefill_tokens``, ``decode_tokens``, ``steps`` (decode
        steps, or speculative rounds), ``step_s`` (host-clock seconds of
        each step or round, its logits read back included),
        ``mid_flight_admissions`` (requests admitted beside a resident one
        after decoding began), ``rounds`` (scheduling rounds; on a mesh,
        one agreement each), ``admit_rounds[rid]`` (the round that
        admitted each request), ``wall_s``,
        ``decode_tok_per_s``, per-request ``timing[rid] = (arrival_s,
        admit_s, done_s)``, ``spec`` under speculation, and the float32
        logits row behind every token under ``logits`` when
        ``record_logits``.
        """
        if feed is not None and self.mesh is not None:
            raise NotImplementedError(
                "feed= on a mesh (each rank's feed would join its queue at "
                "its own round) is ROADMAP A12.2c")
        if arrivals is None:
            arrivals = [0.0] * len(requests)
        if len(arrivals) != len(requests):
            raise ValueError("arrivals must parallel requests")
        self._logits_log = {} if record_logits else None
        t0 = time.monotonic()
        waiting = deque(zip(arrivals, requests))
        active: Dict[int, _Slot] = {}
        timing: Dict[int, Any] = {}
        admit_rounds: Dict[int, int] = {}
        step_s: List[float] = []
        n_prefill = n_decode = n_mid = rounds = 0
        n_drafted = n_accepted = 0

        def finish(req: Request, arrival: float, admit_s: float):
            nonlocal n_decode
            n_decode += len(req.out_tokens)
            timing[req.rid] = (arrival, admit_s, time.monotonic() - t0)
            if on_done is not None:
                on_done(req)

        self._serving = True
        try:
            while True:
                now = time.monotonic() - t0
                rounds += 1
                if feed is not None:
                    for req in feed():
                        waiting.append((now, req))
                if (self._pending is not None and not active
                        and not self._replaying):
                    # the fence: the slots drained, install the parked
                    # table and resume admission under it
                    ServeEngine.apply_calibration(self, self._pending)
                    self._pending = None
                decoding = bool(active)      # residents of earlier rounds
                ready = 0                    # the waiting whose time came
                while ready < len(waiting) and waiting[ready][0] <= now:
                    ready += 1
                if self.mesh is not None:
                    ready = self.mesh.agree([ready])[0]
                while ready and (self._pending is None or self._replaying):
                    arr, req = waiting[0]
                    st = self._admit(req, arr, t0, active)
                    if st is None:
                        break
                    waiting.popleft()
                    ready -= 1
                    admit_rounds[req.rid] = rounds
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
                    rows = logits.float().cpu().numpy()  # (slots, k, vocab)
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
                    # released slots have pos == 0 and are skipped; live
                    # ones advance by their accepted count and shed the
                    # rejected rows
                    rewind_slots(self.cache, keep, k)
                else:
                    rows = self._decode_paged(cur).float().cpu().numpy()
                    step_s.append(time.perf_counter() - t_step)
                    for slot in list(active):
                        st = active[slot]
                        st.cur = int(rows[slot].argmax())
                        self._harvest(slot, st, active, rows[slot])
                        if st.req.done:
                            finish(st.req, st.arrival, st.admit_s)
        finally:
            self._serving = False
        dt = time.monotonic() - t0
        stats: Dict[str, Any] = {
            "prefill_tokens": n_prefill, "decode_tokens": n_decode,
            "steps": len(step_s), "step_s": step_s,
            "mid_flight_admissions": n_mid, "rounds": rounds,
            "admit_rounds": admit_rounds, "wall_s": dt,
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

    def apply_calibration(self, table: CalibrationTable) -> int:
        """Install a table, behind a drain fence if it changes the plan.

        Flush periods are shared by every slot of a step, so a table whose
        flush plan differs cannot install while requests are resident: it
        is parked, admission pauses, the resident slots drain, and it
        installs at the next empty scheduling round (no request dropped,
        nothing rebuilt). A swap with the same plan (an amax-only refresh,
        a re-install of the same content) installs at once: resident slots
        keep their pinned amax. Returns the installed version, or the
        current one when the table was fenced.
        """
        with self._calib_lock:
            if (self._serving and self._tables
                    and self._plan_flush_host(table) != self._flush_host):
                self._pending = table
                return self.table_version
            return super().apply_calibration(table)

    def _replay_run(self, copies: List[Request]) -> Dict[str, Any]:
        return self.serve(copies, record_logits=True)

    def run(self, requests: List[Request], **kw) -> Dict[str, Any]:
        """The group-mode entry point is replaced by :meth:`serve`; the
        fault-injection / deadline seams are group-mode only."""
        if kw:
            raise NotImplementedError(
                "the continuous engine serves via .serve(); "
                f"ServeEngine.run keywords {sorted(kw)} do not apply")
        return self.serve(requests)


def make_engine(cfg: ModelConfig, *, batch: int, max_len: int, params=None,
                seed: int = 0, eos_id: Optional[int] = None, device=None,
                calibration: Optional[CalibrationTable] = None,
                continuous: bool = False,
                spec_k: Optional[int] = None, mesh=None) -> ServeEngine:
    """Engine factory: a :class:`ServeEngine`, or with ``continuous=True`` a
    :class:`ContinuousBatchingEngine` with ``batch`` decode slots
    (``spec_k`` turns on speculative decoding there); ``calibration``
    starts either pre-calibrated. ``mesh``: this rank's
    :class:`~repro_torch.parallel.comm.RankMesh`, for either engine."""
    if continuous:
        return ContinuousBatchingEngine(
            cfg, slots=batch, max_len=max_len, params=params, seed=seed,
            eos_id=eos_id, calibration=calibration, spec_k=spec_k,
            device=device, mesh=mesh)
    if spec_k is not None:
        raise ValueError("spec_k requires continuous=True: speculative "
                         "decoding runs on the paged continuous engine")
    return ServeEngine(cfg, batch=batch, max_len=max_len, params=params,
                       seed=seed, eos_id=eos_id, calibration=calibration,
                       device=device, mesh=mesh)


def _parse_mesh(text: str, device) -> Optional[tuple]:
    """``"DxM"`` -> ``(D, M)``; ``"auto"`` -> ``(1, visible cards)``;
    ``None`` for ``1x1``."""
    if text == "auto":
        if resolve_device(device).type != "cuda":
            raise ValueError("--mesh auto takes every visible card; on the "
                             "CPU give the shape (--mesh DxM)")
        shape = (1, torch.cuda.device_count())
    else:
        try:
            shape = tuple(int(v) for v in text.lower().split("x"))
        except ValueError:
            shape = ()
        if len(shape) != 2 or min(shape) < 1:
            raise ValueError(f"--mesh {text!r}: expected DxM (data x "
                             "model ranks) or auto")
    return None if shape == (1, 1) else shape


def _serve_cli(engine: ServeEngine, reqs: List[Request], warm: int):
    """The CLI's run: a continuous engine warmed at bucket ``warm``, then
    served (its per-step times dropped); a group engine run."""
    if not isinstance(engine, ContinuousBatchingEngine):
        return engine.run(reqs)
    engine.warmup([warm], max_new=1)
    stats = engine.serve(reqs)
    stats.pop("step_s")
    return stats


def _serve_rank(rank: int, shape, cfg: ModelConfig, batch: int,
                max_len: int, reqs: List[Request], continuous: bool = False,
                spec_k: Optional[int] = None, warm: int = 0):
    """One rank of ``--mesh``: the engine on this rank's slice, the
    requests served (``_serve_cli``); returns (stats, tokens per
    request)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.comm import COMM_STATS, rank_device
    mesh = make_mesh(shape, ("data", "model"))
    stats = _serve_cli(make_engine(cfg, batch=batch, max_len=max_len,
                                   device=rank_device(), mesh=mesh,
                                   continuous=continuous, spec_k=spec_k),
                       reqs, warm)
    stats["mesh"] = f"{shape[0]}x{shape[1]}"
    stats["collectives"] = COMM_STATS["calls"]
    return stats, [r.out_tokens for r in reqs]


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
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through R replica engines "
                         "(launch.replica.ReplicaServeDriver): every request "
                         "stays bitwise equal to one engine's; on --device "
                         "cpu they take R CPU slots, on the card one visible "
                         "card each")
    ap.add_argument("--scheduler", default="round_robin",
                    choices=("round_robin", "least_loaded"),
                    help="replica dispatch policy (--replicas > 1)")
    ap.add_argument("--mesh", default="1x1",
                    help="serve on a DxM (data x model) mesh of ranks, or "
                         "auto (1 x every visible card): tokens bitwise the "
                         "1x1 engine's")
    ap.add_argument("--share-device", action="store_true",
                    help="with --mesh on the card: every rank on one card, "
                         "over gloo (NCCL needs a card per rank)")
    ap.add_argument("--no-deterministic", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.replicas > 1 and args.no_deterministic:
        ap.error("--no-deterministic is incompatible with --replicas > 1: "
                 "the replica driver exists to provide data-parallel "
                 "throughput *with* the deterministic layout")
    if args.no_deterministic:
        ap.error("--no-deterministic (batch over data: K-sharded weights "
                 "then need gathering) is ROADMAP A12.2c")
    try:
        mesh_shape = _parse_mesh(args.mesh, args.device)
    except ValueError as e:
        ap.error(str(e))
    if mesh_shape is not None and args.replicas > 1:
        ap.error("--mesh with --replicas (the fleet over tensor-parallel "
                 "sub-meshes) is ROADMAP A12.2c")
    if args.continuous and args.replicas > 1:
        ap.error("--continuous is a single-engine mode here (use "
                 "ReplicaServeDriver(continuous=True))")

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
    if mesh_shape is not None and mesh_refusal(cfg) is not None:
        ap.error(f"--mesh: {mesh_refusal(cfg)}")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, args.prompt_len
                                               ).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.n_requests)]
    max_len = (cfg.vision_prefix + args.prompt_len + args.max_new + 1
               + max(args.spec_k - 1, 0))
    if mesh_shape is not None:
        from repro_torch.parallel.comm import launch
        dev = resolve_device(args.device)
        results = launch(_serve_rank, mesh_shape[0] * mesh_shape[1],
                         args=(mesh_shape, cfg, args.batch, max_len, reqs,
                               args.continuous, args.spec_k or None,
                               args.prompt_len),
                         device=dev, share_device=args.share_device,
                         threads=1 if dev.type == "cpu" else None,
                         timeout=3600.0)
        stats, tokens = results[0]      # rank 0 reports
        print(stats)
        for r, toks in list(zip(reqs, tokens))[:2]:
            print(f"req {r.rid}: {toks[:10]}")
        return
    if args.replicas > 1:
        from repro_torch.launch.mesh import virtual_devices
        from repro_torch.launch.replica import ReplicaServeDriver
        on_cpu = resolve_device(args.device).type == "cpu"
        with ReplicaServeDriver(
                cfg, args.replicas, batch=args.batch, max_len=max_len,
                scheduler=args.scheduler,
                devices=(virtual_devices("cpu", args.replicas) if on_cpu
                         else None)) as driver:
            driver.warmup(prompt_len=args.prompt_len, max_new=args.max_new)
            stats = driver.run(reqs)
        print(stats)
        for r in reqs[:2]:
            print(f"req {r.rid}: {r.out_tokens[:10]}")
        return
    try:
        engine = make_engine(cfg, batch=args.batch, max_len=max_len,
                             device=args.device, continuous=args.continuous,
                             spec_k=args.spec_k or None)
    except NotImplementedError as e:
        ap.error(f"{cfg.name}: {e}")
    stats = _serve_cli(engine, reqs, args.prompt_len)
    print(stats)
    for r in reqs[:2]:
        print(f"req {r.rid}: {r.out_tokens[:10]}")


if __name__ == "__main__":
    main()
