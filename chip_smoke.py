#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--layers N]

Phases, in order; any failure raises and the script exits non-zero:

1. build the hand-written kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source or compile unit, all started together);
2. B1 (exact limb-fused matmul) against its plain twin with
   ``torch.equal`` at the group path's shapes, the verify step's 16 rows
   and an unaligned shape with a shared weight, each with no epilogue,
   with scale + bias, at ``flush_period=1`` and at ``block_k=64,
   flush_period=2``; then B3 (the stationary
   schedules of the same matmul) against B1 and its twin at the
   continuous path's shapes, in both schedules, logging each shape as
   stationary or fallback with the K splits of the kernel that runs it;
3. B2 (flash-decode attention) against its twin at 128 slices, head dim
   128, chunk 128, ragged lengths up to 1024; then its paged and verify
   entries through a permuted block table with stale and trash blocks at
   the continuous path's width, at granite-20b's rows (one kv head, 48
   query rows, 192 at a ``spec_k=4`` verify), at gemma3-27b's head dim 168
   in E3M4, and at a long context (lengths 4096, 0, 2000, 1);
4. serve 8 requests (batch 4, prompt 32, 16 new tokens) through
   ``repro_torch.launch.serve.ServeEngine`` with deepseek-7b at full width
   under ``FP8_MGS_SERVE_KV`` in bf16 (``--layers`` of its 30 layers, 12
   by default), counting each kernel's launches; then a reduced model
   served on the GPU and on the CPU (twins) must give the same tokens;
5. time B1 and B2 (median of per-call CUDA-event times; B2 also through
   its paged decode and verify entries at the continuous path's width and
   with every slot at 256, 1024 and 4096 live keys)
   beside the twin, a PyTorch yardstick call and the bound, and profile a
   group decode step;
6. serve 8 ragged requests (prompts 16-160 tokens, 16 new tokens, four
   at t = 0, the rest through ``arrivals``) through
   ``ContinuousBatchingEngine.serve`` on the same weights under
   ``FP8_MGS_SERVE_PAGED.replace(schedule="activation")`` (4 slots,
   max_len 256, block 128; seed-0 weights with the residual output
   projections scaled by 8, so that the tokens vary), counting launches; the same traffic under
   ``schedule="output"``, under ``spec_k=4`` with 8 draft layers, and two
   requests served alone must give bitwise equal logits; ``PREP_STATS``
   and the kernel builds stay flat; then time the continuous decode step,
   the speculative round and B3 at the decode shapes, and profile one
   paged decode step;
7. the paper's numerics: B4 (exact matmul over pre-decomposed limb
   planes) == B1 == twin and B5 (per-product-rounded dMAC matmul over
   packed codes) == twin == B5's float entry with ``torch.equal`` at the
   group path's shapes (decode, prefill, the batched score / value
   contractions; B4 also at the verify and unaligned shapes of phase 2,
   at ``flush_period=1`` and ``block_k=64, flush_period=2``; B5 also at
   E5M2, E3M4 and
   E4M3 with the subnormal gate on and off, and B5's device rounding
   tables against the twin's); a reduced
   model under ``FP8_MGS`` and ``FP8_MGS_EXACT`` (kernel tier) on the GPU
   and the CPU; then the group traffic of phase 4 on one bf16 parameter
   set (seed 0, full width) under the unquantized model and (a)
   ``FP8_MGS`` (B5), (b) ``FP8_MGS_EXACT`` (B4), (c) ``FP8_WIDE``, (d)
   ``FP8_MGS_SERVE`` (B1), (e) ``INT8_DMAC``, all with the float KV cache:
   launch counts equal the prediction, ``PREP_STATS`` and the builds stay
   flat, (b) gives (d)'s greedy tokens with logits within 5% of their
   scale, and each configuration's logit error and token agreement
   against the unquantized model is printed; a decode step of (a)-(e) is
   profiled and
   B4 / B5 are timed at the shapes above (B5 through both entries and
   with both of its bin updates);
8. calibration on the weights of phases 4 and 6 (nothing prepared
   again): the group engine under ``FP8_MGS_SERVE_KV`` with
   ``flush_target=1e-6`` serves a group on v0, ``calibrate()``s to v1
   (the table and planned periods logged), serves, installs a refreshed
   v2 and swaps to v3 mid-group through an injector, and replays v0, v1
   and the torn group bitwise, each run launching phase 4's kernels; the
   continuous engine (``spec_k=4``, static decode-query scale,
   ``flush_target=1e-6``) ``calibrate()``s, takes a plan-changing swap
   mid-traffic that must fence (late arrivals on the new version, none
   dropped), replays every era bitwise and refreshes its table from
   streaming shadow passes; ``PREP_STATS`` and the builds stay flat; the
   time of ``calibrate()`` and of a shadow pass, and a paged decode step
   under the static scale profiled beside phase 6's dynamic one (B3 / B2
   launches equal);
9. the other families on the group path: B1 == twin at every shape the
   two models below launch it at (granite-moe-1b-a400m's attention
   projections, prefill scores / values, router, experts in one launch
   over all 32 with per-expert scales, an all-zero expert slice and the
   silu epilogue, and its 49155-column head; falcon-mamba-7b's seven
   projections at decode and prefill and its 65024-column head) and B2 ==
   twin at granite-moe's heads; reduced granite-moe and falcon-mamba on
   the card and the CPU give the same tokens; then granite-moe-1b-a400m
   (24 layers) and falcon-mamba-7b (16 of its 64 layers) at full width in
   bf16 under ``FP8_MGS_SERVE_KV`` serve phase 4's traffic, launch counts
   equal the prediction, every B1 launch is at a checked shape,
   ``PREP_STATS`` and the builds stay flat, a decode step of each is
   profiled, each model is freed before the next; B1 / B2 are timed at
   those shapes;
10. the hybrid, encoder-decoder and VLM families on the group path: B1 ==
   twin at every shape whisper-tiny's and internvl2-2b's full-width runs
   launch it at (whisper's encoder over 1500 frames, the cross K / V
   projections of its output and the cross scores / values, internvl2's
   projections over the 256-token vision prefix and the prompt) and at
   every shape of one full-width jamba-1.5-large-398b period (computed
   from its config; the twin held in slices where its planes would pass
   4 GB); B2 == twin at whisper's cross-attention (1500 live of 1536
   keys, a non-causal bias row) and self-attention, internvl2's and
   jamba's heads; reduced jamba, whisper and internvl2 served on the card
   and the CPU give the same tokens, and whisper / internvl2 also at model
   level with seeded random audio / vision embeddings (whisper's decode
   then runs B2 over its cross planes); then whisper-tiny (4 + 4 layers)
   and internvl2-2b (24 layers, max_len 256 + 32 + 16 + 1) at full width
   serve phase 4's traffic with phase 9's checks;
11. the paper's accumulation analysis, each result on the card equal to
   the CPU's bitwise: Fig. 3's traffic (E4M3 Gaussian pairs, lengths 16 to
   4096, 16 trials each in one call) through the sequential / pairwise /
   Kahan sums in a 4-bit-mantissa accumulator, ``mgs_dot_narrow_clipped``,
   ``mgs_dot_exact`` in both modes and the ``mgs_dot_dmac`` emulator
   (value and counters; its value == ``mgs_dot_exact(mode="dmac")``),
   printing each one's mean % error; Fig. 4b's integer dMAC counters (K
   576, 64 dots, narrow 8 / 9 / 10 / 12 bits), printing the average
   accumulator bits and overflow rates; Table 3's sparsity sweep of FP8
   dMAC counters at K 4096 fed to the energy model (weights from a seeded
   normal pool), and the paper-rate rows; ``qmatmul`` at the decode ``wq``
   shape (4 x 4096 @ 4096 x 4096) under fp8 ``swamp``, ``INT8_DMAC`` and
   int8 ``clip`` / ``wrap`` (narrow 16 / 24 bits), printing each error
   against the float64 product beside ``FP8_MGS``'s; reduced deepseek-7b
   under ``INT8_DMAC`` and fp8 ``swamp`` on the card and the CPU give the
   same tokens;
12. training and Table 1 / Fig. 9 (``benchmarks/table1_accuracy.py`` and
   ``fig9_pareto.py``' traffic): B1 and B5 == twin at every shape the
   teacher-forced forward of full-width mgs-paper-eval over 8 x 64 tokens
   launches them at (the projections over 512 rows, the batched score /
   value contractions, the 32768-column tied head); mgs-paper-eval (12
   layers, d 384, vocab 32768) trained at full width through
   ``launch.train.train_loop`` for 150 steps of ``SyntheticLM`` batches,
   checkpoints in a temporary directory (the loss must fall by more than
   0.3; the last checkpoint restores the final state bitwise) and one step
   profiled; every B1 / B5 launch of an eval forward recorded at a checked
   shape; Table 1's six modes (``dmac_mgs`` on B5, ``mgs_exact`` on B1)
   scored by top-1 over 4 held-out batches, each kernel launching
   ``eval_launches`` times a forward; Fig. 9's int8 ``clip`` / ``wrap`` at
   narrow 12 / 14 / 16 / 20 bits against int8 ``mgs_exact`` on one batch;
   reduced mgs-paper-eval's forward under both kernels on the card and the
   CPU gives the same greedy tokens; granite-moe-1b-a400m (24 layers,
   1.33 B parameters) takes 3 full-width train steps of 8 x 512 tokens
   with ``remat="layer"`` and its aux loss, the last profiled, peak memory
   printed; B1 / B5 timed at the forward's shapes;
13. the replica fleet (``launch.replica.ReplicaServeDriver``), run right
   after phase 8 while phases 4 and 6's prepared weights are alive
   (nothing prepared again), its replicas on slots of the one card
   (``launch.mesh.virtual_devices``), a CUDA stream each: 2 replicas over
   4 slots serve phase 4's 8 requests twice with slot 0 poisoned at decode
   step 2 of replica 0's second group (tokens bitwise phase 4's, nothing
   dropped, one failover, one rebuild on 1 slot without slot 0, no retry,
   both replicas healthy), then the 8 again, a group on each replica,
   the rebuilt one's included (tokens bitwise, its prefill logits bitwise
   one engine's); one engine serves the same requests, timed beside the
   fleet; a transient fault on replica 1 at decode step 2 is retried in
   place; a calibration push under traffic (``calibrate()``, then
   ``apply_calibration`` of a second table) with slot 0 poisoned at
   replica 0's second group: the rebuilt replica holds its donor's table
   versions and replays a v1 request with the donor's bits; 2 continuous
   replicas serve phase 6's ragged traffic at its arrival times (tokens
   bitwise phase 6's); each run's B1 / B2 / B3 launches equal the
   prediction (the continuous fleet's from the engines' own decode-step
   count, held inside the traffic's bounds), ``PREP_STATS`` and the builds
   stay flat; each wall beside one engine's, ``busy_s``
   and ``recovery_s`` printed;
14. sharded serving, after phase 12 (with phase 4's tokens and
   logits, phase 6's run (a) and phase 9's granite-moe tokens): B1's
   partials entry over K cut into 2 and 3 pieces at offsets that are no
   multiple of ``block_k``, the pieces' int32 partials summed, and its
   flush entry == one B1 call == the twin at decode wd and prefill wg/wu,
   flush periods 1, 4, the 1e-6 plan and none; B3's partials entry the
   same way in both stationary schedules at decode wd, the verify's 16
   rows and a short K whose pieces admit the weight-stationary stripe
   (each piece on B3's partials where its stripe is admitted, else B1's);
   B2 over 128 slices == two launches of 64; the entries timed at rank 0's
   half of decode wd; then deepseek-7b (``--layers``) and
   granite-moe-1b-a400m (24 layers) at full width on a 1x2 mesh of
   ``torch.distributed`` ranks sharing the card over gloo
   (``parallel.comm.launch(share_device=True)``; the ranks load phase 1's
   build) serve phase 4's traffic: tokens bitwise the one-card runs',
   deepseek's every logits row bitwise phase 4's, launches by entry and
   collectives (calls, bytes, bytes staged through the host) a decode step
   and a run == ``sharded_prediction``; the deepseek ranks then serve
   phase 6's weights and traffic on the continuous engine, sequential and
   ``spec_k=4`` with 8 draft layers: every token and logits row bitwise
   phase 6's run (a), the ranks' scheduling rounds alike, launches and
   collectives a decode step, a speculative round and a run ==
   ``continuous_sharded_prediction``; ``PREP_STATS`` and the builds flat;
   it prints what a shared card cannot show (NCCL, inter-GPU bandwidth,
   any speed of tensor parallelism);
17. the paper's numerics on a mesh of ranks, after phase 14 (reusing phase
   1's build and phase 7's runs): B5's partials entry over K cut into 2
   and 3 pieces at offsets that are no multiple of its 128-code K tile,
   the pieces' bins summed as int32, and its combine entry (with a scale)
   == one B5 call == the twin at decode wd and prefill wg/wu, E4M3 and
   E5M2, the gate on and off; B4's partials entry the same way, flushed by
   B1's flush entry, == one B4 call == B1 == the twin at flush periods 1,
   4 and none; the three entries timed at rank 0's half of decode wd
   beside their bounds and an f32 ``torch.matmul`` of the cut; then
   deepseek-7b at full width (``--layers``) on a 1x2 mesh of gloo ranks
   sharing the card serves phase 7's first group (4 requests, 32-token
   prompts, 16 new tokens, float cache) under the unquantized model and
   (a)-(e): (a), (b), (d), (e) give phase 7's tokens and every logits row
   bitwise, the unquantized model and (c) its greedy tokens with logits
   within the whole-model bar (5% max, 1% mean of the scale; the largest
   error printed), launches by entry and collectives a decode step and a
   run == ``sharded_prediction(quant=...)``, ``PREP_STATS`` and the builds
   flat;
15. training on meshes of ranks sharing the card over gloo
   (``train_sharded_phase``), every compared run a process of its own
   under ``torch.use_deterministic_algorithms`` (``CUBLAS_WORKSPACE_CONFIG``
   set before the spawns): mgs-paper-eval at full width (no remat, 8 x 64
   tokens) trains 4 steps on a 2x2 mesh (``launch.train.train_loop`` on
   each rank's slice by the train specs, batch over (data, model): D =
   4) with a checkpoint, ``runtime.elastic.make_elastic_mesh(2)`` over 4
   slots with 2 excluded gives 1x2 (D = 2), the ranks restore from the
   checkpoint (``shardings=``) and train 4 more; every step's loss / aux /
   tokens / grad norm, every rank's final slices and the final checkpoint
   are bitwise one card at ``grad_accum`` 4 then 2 through its own
   checkpoint, and the final params' ``mgs_exact`` (B1) logits bitwise;
   granite-moe-1b-a400m at full width but 6 of its 24 layers
   (``MOE_TRAIN_LAYERS``; remat per layer, 8 x 512) takes one step on the
   same 1x2 ranks bitwise one card at ``grad_accum`` 2, peak memory a rank
   printed; the one-card process runs both parts beside the meshes;
   every step's collectives (calls, bytes, host bytes) ==
   ``train_sharded_prediction``; it prints what a shared card cannot show
   (NCCL, 2+ cards, any speed of data parallelism);
16. the dry run (``repro_torch.launch.dryrun``) against the card, reusing
   what phases 4-6 built: the growth of ``torch.cuda.memory_allocated``
   over phase 4's group engine (its weights; one cache) and phase 6's
   continuous engine (weights and pool) == the dry run's resident bytes
   within ``RESIDENT_TOL_*``; the group run's peak over its resident beside
   the dry run's cache and transient; the kernels' bound of a group and a
   paged decode step (``launch/roofline.py``) beside the profiled busy
   time of phases 5 and 6; the dry run's records of deepseek-7b at all 30
   layers for every shape on 1x1, 1x8 and 16x16 under FP8_MGS_SERVE_KV and
   no quantization, in at most 30 s. The kernels' bounds and every launch
   and collective prediction above come from ``launch/roofline.py`` and
   ``launch/dryrun.py``. Last, print the card's name and power limit, a
   JSON line of kernel results, and ``{"ok": true, "device": {...}}``.

Needs a CUDA device and the repository's ``src/`` beside this file.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"
if (SRC / "repro_torch").is_dir():
    sys.path.insert(0, str(SRC))
try:
    # the kernels' bounds and the per-step launch and collective
    # predictions live in the package
    from repro_torch.launch.dryrun import (  # noqa: E402
        continuous_sharded_prediction, eval_b1_shapes, eval_launches,
        family_b1_shapes, fleet_group_launches, group_launches,
        sharded_prediction, train_sharded_prediction)
    from repro_torch.launch.roofline import (  # noqa: E402
        b1_bound, b1_flush_bound, b1_partials_bound, b2_bound, b4_bound,
        b4_partials_bound, dmac_bound, dmac_combine_bound,
        dmac_partials_bound)
except ImportError:     # outside a checkout: main() says so and stops
    pass

SEED = 0
# deepseek-7b layers the serving phases (4-8, 13) run by default, of 30:
# depth is cut so that the script stays well inside its time limit
DEPTH = 12


def log(*a):
    print(*a, flush=True)


# device cycles spun before a timed run (~10 ms at 1.98 GHz): longer than the
# host takes to enqueue the run's calls
SPIN_CYCLES = 20_000_000


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Median device time of one call (CUDA events around each call). The
    device spins first, so the host enqueues every call ahead of it and no
    call's time holds the host's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(SPIN_CYCLES)
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    ts = sorted(a.elapsed_time(b) for a, b in ev)
    return ts[len(ts) // 2]


def fp8_codes(torch, shape, dev, gen, scale=1.0, fmt=None):
    """Codes of per-tensor-quantized Gaussian values (weights/activations);
    past 2**28 elements, per leading slice (bounds the float
    temporaries)."""
    from repro_torch.core.formats import E4M3, encode_bits
    from repro_torch.quant.quantize import quantize_fp8
    fmt = fmt or E4M3
    if len(shape) > 1 and shape[0] > 1 and math.prod(shape) > 2**28:
        out = torch.empty(shape, dtype=torch.uint8, device=dev)
        for i in range(shape[0]):
            out[i] = fp8_codes(torch, shape[1:], dev, gen, scale, fmt)
        return out
    x = torch.randn(shape, generator=gen, device=dev) * scale
    return encode_bits(quantize_fp8(x, fmt).q, fmt)


# ---------------------------------------------------------------------------
# phase 2: B1
# ---------------------------------------------------------------------------

B1_SHAPES = [  # (name, Bt, M, K, N)
    ("decode wq/wk/wv/wo", 1, 4, 4096, 4096),
    ("decode wg/wu", 1, 4, 4096, 11008),
    ("decode wd", 1, 4, 11008, 4096),
    ("decode logits", 1, 4, 4096, 102400),
    ("prefill wq/wk/wv/wo", 1, 128, 4096, 4096),
    ("prefill wg/wu", 1, 128, 4096, 11008),
    ("prefill wd", 1, 128, 11008, 4096),
    ("prefill scores", 128, 32, 128, 1024),
    ("prefill values", 128, 32, 1024, 128),
]


# B1 / B4 beyond the timed shapes: the verify step's 16 rows (K split across
# blocks), and 2 slices of 13 x 300 @ 300 x 197 with one shared weight (rows
# not 16-byte aligned: the plain-load staging path)
EXACT_EXTRA = [  # (name, Bt, M, K, N)
    ("verify wq/wk/wv/wo", 1, 16, 4096, 4096),
    ("verify wd", 1, 16, 11008, 4096),
    ("unaligned, shared w", 2, 13, 300, 197),
]
# the flush cadences every B1 / B4 shape is checked at
EXACT_CADENCES = (("", {}), ("flush_period=1", {"flush_period": 1}),
                  ("block_k=64,fp=2", {"block_k": 64, "flush_period": 2}))


def _weight_shape(name, Bt, K, N):
    """(K, N) shared by every slice for the unaligned shape, else per slice."""
    return (K, N) if "shared w" in name else (Bt, K, N)


def check_b1(torch, dev, gen):
    from repro_torch.core.formats import E4M3
    from repro_torch.kernels.mgs_matmul import (
        mgs_matmul_exact_fused, mgs_matmul_exact_fused_plain)
    worst = 0.0
    for name, Bt, M, K, N in B1_SHAPES + EXACT_EXTRA:
        x = fp8_codes(torch, (Bt, M, K), dev, gen)
        w = fp8_codes(torch, _weight_shape(name, Bt, K, N), dev, gen)
        scale = torch.rand((Bt, 1, 1), generator=gen, device=dev) * 1e-4
        bias = torch.randn((N,), generator=gen, device=dev)
        for tag, kw in (("none", {}),
                        ("scale+bias", {"scale": scale, "bias": bias}),
                        *EXACT_CADENCES[1:],
                        ("scale+silu", {"scale": scale,
                                        "activation": "silu"})):
            if tag == "scale+silu" and M != 4:
                continue
            out = mgs_matmul_exact_fused(x, w, E4M3, **kw)
            twin = mgs_matmul_exact_fused_plain(x, w, E4M3, **kw)
            torch.cuda.synchronize()
            err = (out - twin).abs().max().item()
            worst = max(worst, err)
            eq = torch.equal(out, twin)
            log(f"B1 {name:22s} {Bt}x({M}x{K} @ {K}x{N}) {tag:15s} "
                f"equal={eq} max_abs_err={err:.3g}")
            if not eq:
                raise AssertionError(f"B1 kernel != twin at {name} {tag}")
            if not torch.isfinite(out).all():
                raise AssertionError(f"B1 non-finite output at {name}")
    return worst


# the continuous path's B3 shapes: decode at 4 slots, the verify step's 16
# rows, a batch-1 prefill at 64 tokens and its score / value contractions
# (32 heads, chunked at 1024 keys), and the 192-token bucket's
B3_DECODE = [  # (name, Bt, M, K, N)
    ("decode wq/wk/wv/wo", 1, 4, 4096, 4096),
    ("decode wg/wu", 1, 4, 4096, 11008),
    ("decode wd", 1, 4, 11008, 4096),
    ("decode logits", 1, 4, 4096, 102400),
]
B3_OTHER = [
    ("verify wq/wk/wv/wo", 1, 16, 4096, 4096),
    ("verify wd", 1, 16, 11008, 4096),
    ("prefill-64 wq/wk/wv/wo", 1, 64, 4096, 4096),
    ("prefill-64 wd", 1, 64, 11008, 4096),
    ("prefill-64 scores", 32, 64, 128, 1024),
    ("prefill-64 values", 32, 64, 1024, 128),
    ("prefill-192 scores", 32, 192, 128, 1024),
    ("prefill-192 values", 32, 192, 1024, 128),
]


def route_of(schedule: str, M: int, K: int) -> str:
    """What the dispatch runs for this shape: the schedule itself (B3) or
    the warned fallback to ``"output"`` (B1)."""
    from repro_torch.kernels.ops import _fused_schedule
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return _fused_schedule(schedule, M, K, 128)


def check_b3(torch, dev, gen):
    from repro_torch.core.formats import E4M3
    from repro_torch.kernels.mgs_matmul import (
        mgs_matmul_exact_fused, mgs_matmul_stationary_plain, split_plan,
        stationary_plan)
    worst = 0.0
    for name, Bt, M, K, N in B3_DECODE + B3_OTHER:
        x = fp8_codes(torch, (Bt, M, K), dev, gen)
        w = fp8_codes(torch, (Bt, K, N), dev, gen)
        scale = torch.rand((Bt, 1, 1), generator=gen, device=dev) * 1e-4
        bias = torch.randn((N,), generator=gen, device=dev)
        for schedule in ("activation", "weight"):
            route = route_of(schedule, M, K)
            stationary = route == schedule
            plan = (stationary_plan(Bt, M, K, N, 128, None, schedule)
                    if stationary else split_plan(Bt, M, K, N, 128, None))
            log(f"B3 {name:22s} {Bt}x({M}x{K} @ {K}x{N}) {schedule:10s} -> "
                f"{'stationary (B3)' if stationary else 'fallback (B1)'}, "
                f"splits {plan.splits}")
            if name.startswith("decode") and schedule == "activation" \
                    and not stationary:
                raise AssertionError(f"B3 must run at decode shape {name}")
            if not stationary:
                continue
            for tag, kw in (("none", {}),
                            ("scale+bias", {"scale": scale, "bias": bias}),
                            ("scale+silu", {"scale": scale,
                                            "activation": "silu"}),
                            ("flush_period=1", {"flush_period": 1})):
                out = mgs_matmul_exact_fused(x, w, E4M3, schedule=schedule,
                                             **kw)
                b1 = mgs_matmul_exact_fused(x, w, E4M3, **kw)
                twin = mgs_matmul_stationary_plain(x, w, E4M3,
                                                   schedule=schedule, **kw)
                torch.cuda.synchronize()
                err = (out - twin).abs().max().item()
                worst = max(worst, err)
                eq = torch.equal(out, b1) and torch.equal(out, twin)
                log(f"   {tag:15s} B3 == B1 == twin: {eq} "
                    f"max_abs_err={err:.3g}")
                if not eq:
                    raise AssertionError(f"B3 != B1/twin at {name} "
                                         f"{schedule} {tag}")
                if not torch.isfinite(out).all():
                    raise AssertionError(f"B3 non-finite output at {name}")
    return worst


# ---------------------------------------------------------------------------
# phase 3: B2
# ---------------------------------------------------------------------------


def b2_inputs(torch, dev, gen, N=128, T=1, D=128, chunk=128, S=1024,
              live=None, most=None):
    """Dense-entry inputs: ``N`` slices of ``T`` query rows, head dim
    ``D``, ``S`` keys; each slice's live keys ragged up to ``most``
    (default ``S``; slices 0, 1, 2: ``most``, 0, 1), or all ``live``; the
    bias row masks the rest."""
    from repro_torch.core.formats import E4M3, encode_bits
    from repro_torch.quant.kvcache import quantize_kv
    from repro_torch.quant.quantize import quantize_fp8
    kc, ks = quantize_kv(torch.randn((N, S, D), generator=gen, device=dev),
                         E4M3)
    vc, vs = quantize_kv(torch.randn((N, S, D), generator=gen, device=dev),
                         E4M3)
    qt = quantize_fp8(torch.randn((N, T * D), generator=gen, device=dev),
                      E4M3, axis=1)
    qc = encode_bits(qt.q.reshape(N, T, D), E4M3)
    if live is not None:
        lengths = torch.full((N,), live, device=dev)
    else:
        most = S if most is None else most
        lengths = torch.randint(0, most + 1, (N,), generator=gen, device=dev)
        lengths[0], lengths[1], lengths[2] = most, 0, 1
    lengths = lengths.to(torch.int32)
    pos = torch.arange(S, device=dev)[None]
    bias = torch.where(pos < lengths[:, None], 0.0, -1e30).to(torch.float32)
    qk = (qt.scale * ks) * (D ** -0.5)
    nb = S // chunk
    bt = torch.arange(N * nb, dtype=torch.int32, device=dev).reshape(N, nb)
    return dict(q_codes=qc, k_pool=kc.reshape(N * nb, chunk, D),
                v_pool=vc.reshape(N * nb, chunk, D), bt=bt, live=lengths,
                qk_scale=qk[:, None].contiguous(),
                v_scale=vs[:, None].contiguous(),
                bias=bias[:, None].contiguous(), q_scale=qt.scale, ks=ks)


def check_b2(torch, dev, gen, **shape):
    """The dense entry == twin (``shape``: ``b2_inputs``' N, T, D, chunk,
    S; phase 3 takes the defaults)."""
    from repro_torch.core.formats import E4M3
    from repro_torch.kernels import mgs_attention as ma
    a = b2_inputs(torch, dev, gen, **shape)
    args = [a[k] for k in ("q_codes", "k_pool", "v_pool", "bt", "live",
                           "qk_scale", "v_scale", "bias")]
    out = ma.mgs_flash_blocks(*args, E4M3)
    twin = ma._flash_plain(*args, E4M3)
    torch.cuda.synchronize()
    err = (out - twin).abs().max().item()
    eq = torch.equal(out, twin)
    N, T, D = a["q_codes"].shape
    log(f"B2 {N} slices x ({T} x {D}) over {a['live'].min().item()}-"
        f"{a['live'].max().item()} live of "
        f"{a['bt'].shape[1] * a['k_pool'].shape[1]} keys, chunk "
        f"{a['k_pool'].shape[1]}: equal={eq} max_abs_err={err:.3g}")
    if not eq:
        raise AssertionError("B2 kernel != twin")
    dead = a["live"] == 0
    if not torch.isfinite(out).all() or (
            dead.any() and out[dead].abs().max().item() != 0.0):
        raise AssertionError("B2 output not finite, or a dead slice is "
                             "not exactly zero")
    return err, a


def b2_paged_case(torch, dev, gen, lens, *, KV=32, R=1, D=128, bs=128, T=4,
                  fmt=None):
    """Paged decode and verify inputs: ``len(lens)`` slots x ``KV`` kv heads
    (``R`` query rows each), head dim ``D``, block ``bs``, through a
    permuted table whose unused blocks hold random (stale) codes. A slot
    with length 0 is free (its table row points at the trash block 0), and
    blocks past a slot's length are unallocated (trash). ``lens`` are the
    decode lengths; verify scores ``T`` tokens a slot, token ``t``
    attending to ``lens - (T - 1) + t`` keys (at least 1), so token
    ``T - 1`` is the decode step."""
    from repro_torch.core.formats import E4M3, round_to_format
    fmt = fmt or E4M3
    slots = len(lens)
    nb = max(1, -(-max(lens) // bs))
    S, P = nb * bs, slots * nb + 1
    kp = fp8_codes(torch, (P * KV, bs, D), dev, gen, fmt=fmt)
    vp = fp8_codes(torch, (P * KV, bs, D), dev, gen, fmt=fmt)
    perm = 1 + torch.randperm(P - 1, generator=gen, device=dev)
    bt = perm[:slots * nb].reshape(slots, nb).to(torch.int32)
    dec = torch.tensor(lens, dtype=torch.int64, device=dev)
    bt[torch.arange(nb, device=dev)[None] * bs >= dec[:, None]] = 0
    bt_nk = (bt[:, None, :] * KV + torch.arange(KV, device=dev)[None, :, None]
             ).reshape(slots * KV, nb)
    lengths = torch.where(dec[:, None] > 0, torch.clamp_min(
        dec[:, None] - (T - 1) + torch.arange(T, device=dev)[None], 1), 0)
    lengths = lengths.to(torch.int32).repeat_interleave(KV, dim=0)
    N = slots * KV
    q = round_to_format(torch.randn((N, T, R, D), generator=gen, device=dev)
                        * 20, fmt)
    pos = torch.arange(S, device=dev)
    live = pos[None, None] < lengths[:, :, None]
    qk = torch.where(live, torch.rand((N, T, S), generator=gen, device=dev)
                     * 1e-3, 0.0)
    vs = torch.where(live, torch.rand((N, T, S), generator=gen, device=dev)
                     * 1e-2, 0.0)
    bias = torch.where(live, 0.0, -1e30)
    return dict(q=q, kp=kp, vp=vp, bt=bt_nk, lengths=lengths, qk=qk, vs=vs,
                bias=bias, fmt=fmt, KV=KV, lens=list(lens))


def b2_entries(p, use_kernel: bool):
    """The paged decode entry (token ``T - 1``'s rows, all ``R`` query rows
    of a slice) and the verify entry on one case."""
    from repro_torch.kernels import mgs_attention as ma
    q, kp, vp, bt, lengths = (p[k] for k in ("q", "kp", "vp", "bt",
                                             "lengths"))
    dec = ma.mgs_paged_flash_attention(
        q[:, -1], kp, vp, bt, lengths[:, -1], p["qk"][:, -1], p["vs"][:, -1],
        p["bias"][:, -1], p["fmt"], use_kernel=use_kernel)
    ver = ma.mgs_paged_verify_attention(q, kp, vp, bt, lengths, p["qk"],
                                        p["vs"], p["bias"], p["fmt"],
                                        use_kernel=use_kernel)
    return dec, ver


def check_b2_case(torch, p, label: str):
    """Both entries == twin bitwise on one case; verify's last token ==
    decode; every free slot's rows exactly zero; all finite."""
    outs = {k: b2_entries(p, k) for k in (True, False)}
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item()
              for a, b in zip(outs[True], outs[False]))
    dec, ver = outs[True]
    eq = all(torch.equal(a, b) for a, b in zip(outs[True], outs[False]))
    N, T, R, D = p["q"].shape
    log(f"B2 {label}: {N} slices x ({T} x {R} rows, {D}), decode lengths "
        f"{p['lens']}, {p['fmt'].name}: kernel == twin {eq}, verify token "
        f"{T - 1} == decode {torch.equal(ver[:, -1], dec)}, "
        f"max_abs_err={err:.3g}")
    if not eq or not torch.equal(ver[:, -1], dec):
        raise AssertionError(f"B2 {label}: paged/verify entries != twin")
    free = [i for i, n in enumerate(p["lens"]) if n == 0]
    KV = p["KV"]
    if any(ver[i * KV:(i + 1) * KV].abs().max().item() != 0.0 for i in free) \
            or not torch.isfinite(ver).all():
        raise AssertionError(f"B2 {label}: a free slot is not exactly zero")
    return err


def check_b2_paged(torch, dev, gen):
    """The paged and verify entries at the continuous path's width (4 slots
    x 32 heads, head dim 128, block 128, verify T = 4, table width 2), at
    granite-20b's rows (one kv head, 48 query rows a slice, 192 at a
    ``spec_k=4`` verify), at gemma3-27b's head dim 168 (16 kv heads x 2
    rows) in E3M4, and at a long context (lengths 4096, 0, 2000, 1: 32
    chunks, four passes of the cluster)."""
    from repro_torch.core.formats import E3M4
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import mgs_attention as ma
    for rows, D in ((4, 128), (192, 128), (8, 168)):
        smem = ma._kernel().mgs_flash_attention_smem(rows, D, 128)
        log(f"B2: {rows} rows x D={D}, chunk 128 need {smem} B of shared "
            f"memory (limit {_cuda.SMEM_LIMIT})")
        if not 0 < smem <= _cuda.SMEM_LIMIT:
            raise AssertionError("B2 does not fit shared memory")
    p = b2_paged_case(torch, dev, gen, [201, 0, 126, 2])
    err = check_b2_case(torch, p, "paged + verify")
    cases = [
        ("granite-20b rows", dict(KV=1, R=48, lens=[300, 0, 129, 1])),
        ("gemma3-27b D=168", dict(KV=16, R=2, D=168, fmt=E3M4,
                                  lens=[640, 0, 257, 3])),
        ("long context", dict(lens=[4096, 0, 2000, 1])),
    ]
    for label, kw in cases:
        err = max(err, check_b2_case(
            torch, b2_paged_case(torch, dev, gen, kw.pop("lens"), **kw),
            label))
    return err, p


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------


def serve_full(torch, arch: str, layers: int, mem=None):
    """``arch`` at full width (``layers`` of its depth) in bf16 under
    FP8_MGS_SERVE_KV through the group engine: 8 requests of 32 prompt
    tokens at batch 4, 16 new tokens each. Launch counts equal
    ``group_launches``, ``PREP_STATS`` and the builds stay flat, 8 x 16
    finite logits rows. Returns (launches, stats, engine, requests, the
    logits rows behind each request's tokens); ``mem`` (a dict) receives
    the growth of ``torch.cuda.memory_allocated`` over the engine's
    construction (its weights) and over one of its caches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import BUILDS, LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.quant import PREP_STATS
    from repro_torch.quant.config import FP8_MGS_SERVE_KV
    import numpy as np
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers, quant=FP8_MGS_SERVE_KV)
    want, _ = group_launches(cfg)
    log(f"serve: {arch} full width (d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.family}), "
        f"depth {cfg.n_layers} of {full.n_layers} layers, "
        f"{cfg.compute_dtype}, FP8_MGS_SERVE_KV; predicted launches {want}")
    t0 = time.time()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    eng = ServeEngine(cfg, batch=4, max_len=cfg.vision_prefix + 32 + 16 + 1,
                      seed=SEED)
    torch.cuda.synchronize()
    log(f"serve: random weights + preparation {time.time() - t0:.1f} s, "
        f"PREP_STATS {PREP_STATS}")
    if mem is not None:
        m1 = torch.cuda.memory_allocated()
        cache = eng._init_cache(eng.batch)
        torch.cuda.synchronize()
        mem.update(group_cfg=cfg, group_max_len=eng.max_len,
                   group_weights=m1 - m0,
                   group_cache=torch.cuda.memory_allocated() - m1)
        del cache
    eng.warmup([32], max_new=1)
    rng = np.random.default_rng(SEED)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, 32).astype(
        np.int32), max_new_tokens=16) for i in range(8)]
    prep0, builds0 = dict(PREP_STATS), dict(BUILDS)
    reset_launch_counts()
    if mem is not None:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    stats = eng.run(reqs, record_logits=True)
    launches = dict(LAUNCHES)
    if mem is not None:
        mem["group_run_peak"] = torch.cuda.max_memory_allocated() - base
    logits = stats.pop("logits")
    log(f"serve: stats {stats}")
    log(f"serve: launches during the run {launches}")
    for r in reqs[:2]:
        log(f"serve: req {r.rid} first tokens {r.out_tokens[:10]}")
    expect = {k: want.get(k, 0) for k in launches}
    if launches != expect:
        raise AssertionError(f"{arch}: launch counts {launches} != "
                             f"predicted {expect}")
    if dict(PREP_STATS) != prep0 or dict(BUILDS) != builds0:
        raise AssertionError(f"{arch}: serving re-prepared weights or "
                             "rebuilt a kernel")
    if stats["decode_tokens"] != 8 * 16:
        raise AssertionError(f"decode tokens {stats['decode_tokens']}")
    for r in reqs:
        rows = np.stack(logits[r.rid])
        if rows.shape != (16, cfg.vocab) or not np.isfinite(rows).all():
            raise AssertionError(f"request {r.rid} logits {rows.shape} "
                                 "not finite")
        if not all(0 <= t < cfg.vocab for t in r.out_tokens):
            raise AssertionError("token out of range")
    return launches, stats, eng, reqs, logits


def serve_reduced_gpu_vs_cpu(torch, quant=None, label="FP8_MGS_SERVE_KV",
                             arch="deepseek-7b", edit=None):
    """The same reduced model on the card (kernels) and the CPU (twins);
    ``edit`` may change the weights in place first."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.models import init_params
    from repro_torch.quant.config import FP8_MGS_SERVE_KV
    import numpy as np
    cfg = dataclasses.replace(reduced_config(arch),
                              compute_dtype="float32",
                              quant=quant or FP8_MGS_SERVE_KV)
    params = init_params(cfg, SEED)
    if edit is not None:
        edit(params)
    out = {}
    for dev in ("cuda", "cpu"):
        eng = ServeEngine(cfg, batch=2, max_len=cfg.vision_prefix + 24,
                          params=_tree_to(params, dev), device=dev)
        rng = np.random.default_rng(SEED)
        reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, 12).astype(
            np.int32), max_new_tokens=8) for i in range(4)]
        st = eng.run(reqs, record_logits=True)
        out[dev] = (reqs, st["logits"])
    (rg, lg), (rc, lc) = out["cuda"], out["cpu"]
    for a, b in zip(rg, rc):
        if a.out_tokens != b.out_tokens:
            raise AssertionError(f"reduced model: GPU tokens {a.out_tokens} "
                                 f"!= CPU tokens {b.out_tokens}")
        x, y = np.stack(lg[a.rid]), np.stack(lc[b.rid])
        scale = np.abs(y).max()
        err = np.abs(x - y)
        if err.max() > 5e-2 * scale or err.mean() > 1e-2 * scale:
            raise AssertionError(f"reduced model logits differ: max "
                                 f"{err.max() / scale:.3g} of scale")
    worst = max(np.abs(np.stack(lg[r.rid]) - np.stack(lc[r.rid])).max()
                for r in rg)
    log(f"reduced {arch} ({cfg.n_layers} layers, f32, {label}): GPU kernels "
        f"and CPU twins give equal tokens {[r.out_tokens for r in rg[:2]]}; "
        f"max logit diff {worst:.3g}")


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev).clone()


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------


def time_b1(torch, dev, gen, shapes=B1_SHAPES):
    """Per-shape times (with the shape's epilogue activation, if it names
    one); weights cycle through enough copies to leave L2."""
    from repro_torch.core.formats import E4M3, decode_bits
    from repro_torch.kernels.mgs_matmul import (
        mgs_matmul_exact_fused, mgs_matmul_exact_fused_plain, split_plan)
    rows = []
    for name, Bt, M, K, N, *act in shapes:
        copies = max(1, min(8, -(-200_000_000 // (Bt * K * N))))
        xs = fp8_codes(torch, (Bt, M, K), dev, gen)
        ws = [fp8_codes(torch, (Bt, K, N), dev, gen) for _ in range(copies)]
        epi = dict(scale=torch.full((Bt, 1, 1), 1e-4, device=dev),
                   activation=act[0] if act else "none")
        it = iter(range(10**9))

        def kern():
            mgs_matmul_exact_fused(xs, ws[next(it) % copies], E4M3, **epi)

        def plain():
            mgs_matmul_exact_fused_plain(xs, ws[next(it) % copies], E4M3,
                                         **epi)
        xv = decode_bits(xs, E4M3)
        wv = [decode_bits(w, E4M3) for w in ws]

        def lib():
            torch.matmul(xv, wv[next(it) % copies])
        ms = time_ms(torch, kern, 20)
        plain_ms = time_ms(torch, plain, 3, warmup=1)
        lib_ms = time_ms(torch, lib, 20)
        b_ms, b_by = b1_bound(Bt, M, K, N)
        rows.append(dict(shape=name, Bt=Bt, M=M, K=K, N=N, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                         bound_by=b_by,
                         splits=split_plan(Bt, M, K, N, 128, None).splits))
        log(f"time B1 {name:22s} {Bt}x({M}x{K} @ {K}x{N}): kernel {ms:.4f} "
            f"ms, twin {plain_ms:.4f} ms, torch.matmul f32 {lib_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        del ws, wv
    return rows


def device_breakdown(torch, fn):
    """One call of ``fn`` under ``torch.profiler``: host-clock time, the
    device time of its GPU events summed by kernel (B1-B5, other) and the
    idle share; ``result`` holds what ``fn`` returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    by = {k: [0.0, 0] for k in ("B1", "B3", "B2", "B4", "B5", "other")}
    for e in prof.key_averages():
        us = e.self_device_time_total
        if e.device_type != DeviceType.CUDA or us <= 0:
            continue
        key = ("B5" if "dmac_kernel" in e.key else
               "B3" if "exact_fused_stationary_kernel" in e.key else
               "B4" if "exact_kernel<true" in e.key else
               "B1" if "exact_kernel<false" in e.key else
               "B2" if "flash_kernel" in e.key else "other")
        by[key][0] += us / 1e3
        by[key][1] += e.count
    busy = sum(v[0] for v in by.values())
    return dict(profiled_step_ms=prof_wall, device_ms=busy,
                idle_share=(1 - busy / prof_wall) if busy else None,
                **{f"{k}_ms": v[0] for k, v in by.items()},
                **{f"{k}_kernels": v[1] for k, v in by.items()},
                result=result)


def _breakdown_text(row):
    idle = row["idle_share"]
    idle = "n/a" if idle is None else f"{idle:.0%}"
    return (f"profiled {row['profiled_step_ms']:.2f} ms with device busy "
            f"{row['device_ms']:.2f} ms, idle {idle} (" + ", ".join(
                f"{k} {row[k + '_ms']:.2f} ms in {row[k + '_kernels']} "
                "launches" for k in ("B1", "B3", "B2", "B4", "B5", "other"))
            + ")")


def profile_step(torch, step, label: str):
    """Where one step's time goes: host-clock step time (median of 5
    unprofiled steps after one more), then one step under
    ``torch.profiler`` with the device time of its GPU events summed by
    kernel."""
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    step_ms = sorted(walls[1:])[2]
    row = device_breakdown(torch, step)
    del row["result"]
    row = dict(step_ms=step_ms, **row)
    log(f"profile {label}: {step_ms:.2f} ms unprofiled; "
        + _breakdown_text(row))
    return row


def profile_decode_step(torch, eng):
    """A group decode step at batch 4 after a 32-token prefill."""
    from repro_torch.models import decode_step, init_cache, prefill
    import numpy as np
    rng = np.random.default_rng(SEED)
    batch = eng._make_batch(rng.integers(1, eng.cfg.vocab, (eng.batch, 32)))
    cache = init_cache(eng.cfg, eng.batch, eng.max_len, device=eng.device)
    logits, cache = prefill(eng.params, eng.cfg, batch, cache)
    cur = logits.argmax(dim=-1)[:, None]
    return profile_step(torch, lambda: decode_step(eng.params, eng.cfg, cur,
                                                   cache),
                        f"group decode step ({eng.cfg.n_layers} layers, "
                        f"batch {eng.batch})")


def time_b2(torch, a):
    from repro_torch.core.formats import E4M3, decode_bits
    from repro_torch.kernels import mgs_attention as ma
    import torch.nn.functional as F
    args = [a[k] for k in ("q_codes", "k_pool", "v_pool", "bt", "live",
                           "qk_scale", "v_scale", "bias")]
    N, T, D = a["q_codes"].shape
    chunk = a["k_pool"].shape[1]
    S = a["bt"].shape[1] * chunk
    ms = time_ms(torch, lambda: ma.mgs_flash_blocks(*args, E4M3), 50)
    plain_ms = time_ms(torch, lambda: ma._flash_plain(*args, E4M3), 3, 1)
    # yardstick: SDPA over the dequantized cache (not the same function
    # bit for bit: float scores and weights, no FP8 re-quantization)
    k = (decode_bits(a["k_pool"].reshape(N, S, D), E4M3)
         * a["ks"][..., None])[:, None]
    v = (decode_bits(a["v_pool"].reshape(N, S, D), E4M3)
         * a["v_scale"][:, 0, :, None])[:, None]
    q = (decode_bits(a["q_codes"], E4M3) * a["q_scale"][:, :, None])[:, None]
    mask = a["bias"][:, None]
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), 50)
    live = a["live"].to(torch.int64)
    keys = int(((live + chunk - 1) // chunk * chunk).sum())
    b_ms, b_by = b2_bound(N, T, D, keys, a["bt"].numel())
    log(f"time B2 {N} slices x ({T} x {D}), {keys} live keys (chunk "
        f"{chunk}): kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, SDPA f32 "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by)


def time_b2_paged(torch, p, label=""):
    """B2 as its paged decode and verify entries launch it (one
    ``b2_paged_case``): the kernel call on the arguments the entries pass
    it (query codes, per-row scale and bias rows, the block table), beside
    the twin on the same arguments, SDPA over the gathered, dequantized
    cache (the gather outside the timed call; not the same function bit for
    bit) and the bound over the live blocks. The entries' own host-side
    preparation is left out: with it, each call's host time exceeds its
    device time and the queue drains."""
    from repro_torch.core.formats import decode_bits
    from repro_torch.kernels import mgs_attention as ma
    import torch.nn.functional as F
    q, kp, vp, bt, fmt = (p[k] for k in ("q", "kp", "vp", "bt", "fmt"))
    N, T, _, D = q.shape
    bs = kp.shape[1]
    S = bt.shape[1] * bs
    kg = decode_bits(kp[bt.long()].reshape(N, S, D), fmt)[:, None]
    vg = decode_bits(vp[bt.long()].reshape(N, S, D), fmt)
    rows = {}
    for entry, t in (("paged", 1), ("verify", T)):
        args = b2_kernel_args(torch, p, t)
        live = args[4]
        ms = time_ms(torch, lambda: ma.mgs_flash_blocks(*args, fmt), 50)
        plain_ms = time_ms(torch, lambda: ma._flash_plain(*args, fmt), 3,
                           1)
        qf = q[:, T - t:, 0][:, None]
        v = (vg * p["vs"][:, -1, :, None])[:, None]
        mask = p["bias"][:, T - t:][:, None]
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qf, kg, v, attn_mask=mask), 50)
        keys = int(((live.to(torch.int64) + bs - 1) // bs * bs).sum())
        b_ms, b_by = b2_bound(N, t, D, keys, bt.numel(), scale_rows=t)
        log(f"time B2 {label}{entry:6s} {N} slices x ({t} x {D}), {keys} "
            f"live keys (block {bs}): kernel {ms:.4f} ms, twin "
            f"{plain_ms:.4f} ms, SDPA f32 {lib_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        rows[entry] = dict(rows=t, live_keys=keys, ms=ms, plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    return rows


def b2_kernel_args(torch, p, t):
    """``mgs_flash_blocks``'s arguments as the paged entry (``t = 1``: the
    last token, its ``R`` rows sharing one scale row) or the verify entry
    (``t = T``: ``T * R`` rows, a scale row each) pass them."""
    from repro_torch.core.formats import encode_bits
    N, T, R, D = p["q"].shape
    live = p["lengths"][:, T - t:].amax(dim=1).to(torch.int32)
    rows = [p[k][:, T - t:].contiguous() for k in ("qk", "vs", "bias")]
    if t > 1 and R > 1:
        rows = [x.repeat_interleave(R, dim=1) for x in rows]
    return [encode_bits(p["q"][:, T - t:].reshape(N, t * R, D), p["fmt"]),
            p["kp"], p["vp"], p["bt"], live, *rows]


# live keys a slot at which phase 5 times B2's paged and verify entries
B2_CONTEXTS = (256, 1024, 4096)


def time_b2_contexts(torch, dev, gen):
    """B2 at 4 slots x 32 heads with every slot at 256, 1024 and 4096 live
    keys (``B2_CONTEXTS``), through both entries."""
    out = []
    for keys in B2_CONTEXTS:
        p = b2_paged_case(torch, dev, gen, [keys] * 4)
        for entry, row in time_b2_paged(torch, p, f"{keys} keys ").items():
            out.append(dict(entry=entry, context=keys, **row))
        del p
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 6: continuous serving, speculation, B3 timing
# ---------------------------------------------------------------------------


def _logits_equal(a, b) -> bool:
    return len(a) == len(b) and all(
        x.shape == y.shape and (x == y).all() for x, y in zip(a, b))


#: phase 6's engine: 4 slots over a pool of max_len 256, prompt buckets
CONT_SLOTS, CONT_MAX_LEN, CONT_BUCKETS = 4, 256, [64, 128, 192]
# phase 14's speculative run serves four of phase 6's 8 requests, not all
# (the script's time): rids 1, 2, 5 and 6 (buckets 128, 128, 64, 64; two
# at the start, two 1 and 1.5 s later). Rids 3-7 accept every draft, so
# two of rids 0-2 go in for a rewind. Its prefills are predicted from the
# requests SPEC_ALONE served alone in phase 6, one of each bucket
SPEC_RIDS, SPEC_ALONE = (1, 2, 5, 6), (1, 6)


def continuous_cfg(layers: int):
    """Phase 6's configuration: deepseek-7b at full width, ``layers`` deep,
    under FP8_MGS_SERVE_PAGED activation-stationary (B3)."""
    from repro_torch.configs import get_config
    from repro_torch.quant.config import FP8_MGS_SERVE_PAGED
    return dataclasses.replace(
        get_config("deepseek-7b"), n_layers=layers,
        quant=FP8_MGS_SERVE_PAGED.replace(schedule="activation"))


def continuous_params(cfg, device):
    """Phase 6's weights: the seed-0 random init with the residual output
    projections (``wo``, ``wd``) scaled by 8: at the plain init the tied
    embeddings dominate the residual, every request repeats one token and
    every draft is accepted, so neither the speculative rewind nor a
    mid-flight admission would run."""
    from repro_torch.models import init_params
    params = init_params(cfg, SEED, device=device)
    params["layers"]["attn"]["wo"] *= 8.0
    params["layers"]["ffn"]["wd"] *= 8.0
    return params


def serve_continuous(torch, layers: int, mem=None):
    """Phase 6 (a)-(e). Returns the engine, the launches of run (a), its
    stats and the speculative run's stats; ``mem`` (a dict) receives the
    growth of ``torch.cuda.memory_allocated`` over the first engine's
    weights and pool (its raw weights freed, before its warm-up)."""
    from repro_torch.kernels import BUILDS, LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import (ContinuousBatchingEngine, Request,
                                          bucket_for)
    from repro_torch.quant import PREP_STATS
    import numpy as np
    cfg = continuous_cfg(layers)
    quant = cfg.quant
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    params = continuous_params(cfg, "cuda")
    buckets = CONT_BUCKETS

    def engine(q, params, **kw):
        eng = ContinuousBatchingEngine(
            dataclasses.replace(cfg, quant=q), slots=CONT_SLOTS,
            max_len=CONT_MAX_LEN, params=params, **kw)
        eng.warmup(buckets)
        torch.cuda.synchronize()
        return eng

    log(f"continuous: deepseek-7b full width, depth {layers} of 30, "
        f"{cfg.compute_dtype}, FP8_MGS_SERVE_PAGED schedule=activation, "
        f"4 slots, max_len 256, block {quant.block_k}, buckets {buckets}")
    t0 = time.time()
    eng = ContinuousBatchingEngine(cfg, slots=CONT_SLOTS,
                                   max_len=CONT_MAX_LEN, params=params)
    del params                      # the engine holds the prepared tree
    torch.cuda.synchronize()
    if mem is not None:
        mem.update(cont_cfg=cfg, cont_blocks=eng.n_blocks,
                   continuous=torch.cuda.memory_allocated() - m0)
    eng.warmup(buckets)
    torch.cuda.synchronize()
    log(f"continuous: engine + warmup {time.time() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    plens = rng.integers(16, 161, 8)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in plens]
    arrivals = [0.0] * 4 + [0.5, 1.0, 1.5, 2.0]

    def reqs():
        return [Request(rid=i, prompt=p.copy(), max_new_tokens=16)
                for i, p in enumerate(prompts)]

    prep0, builds0 = dict(PREP_STATS), dict(BUILDS)
    reset_launch_counts()
    ra = reqs()
    a = eng.serve(ra, arrivals=arrivals, record_logits=True)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    log(f"continuous (a): prompts {plens.tolist()}, {a['steps']} steps, "
        f"{a['decode_tokens']} tokens in {a['wall_s']:.2f} s, mid-flight "
        f"admissions {a['mid_flight_admissions']}; launches {launches}")
    if a["decode_tokens"] != 8 * 16 or any(len(r.out_tokens) != 16
                                          for r in ra):
        raise AssertionError("continuous run did not serve 8 x 16 tokens")
    for name in ("mgs_matmul_exact_fused",
                 "mgs_matmul_exact_fused_stationary", "mgs_flash_attention"):
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched by the "
                                 "continuous run")
    for r in ra:
        rows = np.stack(a["logits"][r.rid])
        if rows.shape != (16, cfg.vocab) or not np.isfinite(rows).all():
            raise AssertionError(f"request {r.rid} logits not finite")

    def same(stats, rr, what):
        bad = [r.rid for r in rr if r.out_tokens != ra[r.rid].out_tokens
               or not _logits_equal(stats["logits"][r.rid],
                                    a["logits"][r.rid])]
        log(f"continuous {what}: tokens and logits bitwise equal to (a) "
            f"for {len(rr) - len(bad)} of {len(rr)} requests")
        if bad:
            raise AssertionError(f"{what}: requests {bad} differ from (a)")

    eng_b = engine(quant.replace(schedule="output"), eng.params)
    rb = reqs()
    b = eng_b.serve(rb, arrivals=arrivals, record_logits=True)
    same(b, rb, "(b) schedule=output")
    del eng_b
    eng_c = engine(quant.replace(draft_layers=8), eng.params, spec_k=4)
    rc = reqs()
    c = eng_c.serve(rc, arrivals=arrivals, record_logits=True)
    spec = c["spec"]
    log(f"continuous (c) spec_k=4, 8 draft layers: {c['steps']} rounds, "
        f"acceptance rate {spec['acceptance_rate']:.3f}, "
        f"{spec['tokens_per_round']:.2f} tokens per round, mid-flight "
        f"admissions {c['mid_flight_admissions']}")
    same(c, rc, "(c) spec_k=4")
    del eng_c
    alone = []
    for i in SPEC_ALONE:
        r = Request(rid=i, prompt=prompts[i].copy(), max_new_tokens=16)
        reset_launch_counts()
        alone.append((r, eng.serve([r], record_logits=True),
                      dict(LAUNCHES)))
    for r, st, _ in alone:
        same(st, [r], f"(d) request {r.rid} alone")
    log(f"continuous (e): PREP_STATS {PREP_STATS} (before {prep0}), nvcc "
        f"builds {BUILDS} (before {builds0})")
    if dict(PREP_STATS) != prep0 or dict(BUILDS) != builds0:
        raise AssertionError("serving re-prepared weights or rebuilt a "
                             "kernel")
    # phase 13 serves this traffic again; phase 14 predicts its cut
    # speculative run's prefills from the runs alone, by bucket
    a["requests"], a["arrivals"], a["launches"] = ra, arrivals, launches
    a["alone"] = {bucket_for(len(r.prompt), buckets, block=quant.block_k):
                  dict(launches=got, steps=st["steps"])
                  for r, st, got in alone}
    return eng, launches, a, c


def four_slots(eng):
    """Admit four requests into ``eng``'s slots (outside ``serve``); returns
    the decode step's current tokens."""
    from repro_torch.launch.serve import Request
    import numpy as np
    rng = np.random.default_rng(SEED + 1)
    active = {}
    t0 = time.monotonic()
    for i, plen in enumerate((40, 100, 150, 64)):
        # 61 new tokens: two blocks a slot with or without spec_k=4's
        # 3 rows of headroom
        req = Request(rid=900 + i, prompt=rng.integers(
            1, eng.cfg.vocab, plen).astype(np.int32), max_new_tokens=61)
        eng._admit(req, 0.0, t0, active)
    cur = np.zeros((eng.slots, 1), np.int64)
    for slot, st in active.items():
        cur[slot, 0] = st.cur
    return eng._tokens(cur)


def profile_paged_step(torch, eng):
    """Four slots admitted, then the host-clock time of 5 paged decode
    steps and one step under ``torch.profiler`` by kernel; ``live`` is each
    slot's key count at the profiled step."""
    cur = four_slots(eng)
    row = profile_step(torch, lambda: eng._decode_paged(cur),
                       f"paged decode step ({eng.cfg.n_layers} layers, "
                       "4 slots)")
    row["live"] = [int(p) for p in eng.cache["pos"].tolist()]
    return row


def time_b3(torch, dev, gen):
    """B3 (activation-stationary) at the decode shapes beside B1, the
    twin, torch.matmul over the decoded values and the bound."""
    from repro_torch.core.formats import E4M3, decode_bits
    from repro_torch.kernels.mgs_matmul import (
        mgs_matmul_exact_fused, mgs_matmul_stationary_plain,
        stationary_plan)
    rows = []
    for name, Bt, M, K, N in B3_DECODE:
        copies = max(1, min(8, -(-200_000_000 // (Bt * K * N))))
        xs = fp8_codes(torch, (Bt, M, K), dev, gen)
        ws = [fp8_codes(torch, (Bt, K, N), dev, gen) for _ in range(copies)]
        scale = torch.full((Bt, 1, 1), 1e-4, device=dev)
        it = iter(range(10**9))

        def kern():
            mgs_matmul_exact_fused(xs, ws[next(it) % copies], E4M3,
                                   scale=scale, schedule="activation")

        def b1():
            mgs_matmul_exact_fused(xs, ws[next(it) % copies], E4M3,
                                   scale=scale)

        def plain():
            mgs_matmul_stationary_plain(xs, ws[next(it) % copies], E4M3,
                                        scale=scale, schedule="activation")
        xv = decode_bits(xs, E4M3)
        wv = [decode_bits(w, E4M3) for w in ws]

        def lib():
            torch.matmul(xv, wv[next(it) % copies])
        b1_ms = time_ms(torch, b1, 20)
        ms = time_ms(torch, kern, 20)
        ms2 = time_ms(torch, kern, 20)
        b1_ms2 = time_ms(torch, b1, 20)
        plain_ms = time_ms(torch, plain, 3, warmup=1)
        lib_ms = time_ms(torch, lib, 20)
        b_ms, b_by = b1_bound(Bt, M, K, N)
        plan = stationary_plan(Bt, M, K, N, 128, None, "activation")
        rows.append(dict(shape=name, Bt=Bt, M=M, K=K, N=N,
                         ms=statistics.median([ms, ms2]),
                         b1_ms=statistics.median([b1_ms, b1_ms2]),
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by, splits=plan.splits,
                         tiles_per_block=plan.tiles_per_group))
        log(f"time B3 {name:22s} {Bt}x({M}x{K} @ {K}x{N}), splits "
            f"{plan.splits} x {plan.tiles_per_group} tiles a block: kernel "
            f"{ms:.4f}/{ms2:.4f} ms, B1 {b1_ms:.4f}/{b1_ms2:.4f} ms, twin "
            f"{plain_ms:.4f} ms, torch.matmul f32 {lib_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        del ws, wv
    return rows


# ---------------------------------------------------------------------------
# phase 7: the paper's numerics (B4, B5) on the group serving path
# ---------------------------------------------------------------------------

# the group path's shapes for B4 and B5: decode (4 rows), prefill (4 x 32
# rows), the score / value contractions over 32 heads x 4 requests against
# the float cache (max_len 49) at decode and, padded to the 1024-key chunk,
# at prefill
B45_SHAPES = B1_SHAPES[:7] + [
    ("decode scores", 128, 1, 128, 49),
    ("decode values", 128, 1, 49, 128),
    ("prefill scores", 128, 32, 128, 1024),
    ("prefill values", 128, 32, 1024, 128),
]


def _margin_values(torch, shape, dev, gen, fmt=None):
    """Values quantized as the dmac path quantizes its operands (absmax
    into sqrt(max_finite)), so products reach the saturation clamp."""
    from repro_torch.core.formats import E4M3
    from repro_torch.quant.quantize import quantize_fp8
    fmt = fmt or E4M3
    x = torch.randn(shape, generator=gen, device=dev)
    return quantize_fp8(x, fmt, axis=tuple(range(1, len(shape))),
                        margin=fmt.max_finite ** -0.5).q


def _b5_equal(torch, x, w, fmt, gate, what):
    """B5's codes entry == its twin == the float entry (torch.equal)."""
    from repro_torch.core.formats import encode_bits
    from repro_torch.kernels.mgs_matmul import (
        mgs_matmul_dmac, mgs_matmul_dmac_codes, mgs_matmul_dmac_codes_plain)
    xc, wc = encode_bits(x, fmt), encode_bits(w, fmt)
    out = mgs_matmul_dmac_codes(xc, wc, fmt, gate)
    flt = mgs_matmul_dmac(x, w, fmt, gate)
    twin = mgs_matmul_dmac_codes_plain(xc, wc, fmt, gate)
    torch.cuda.synchronize()
    err = (out - twin).abs().max().item()
    eq = torch.equal(out, twin) and torch.equal(flt, out)
    log(f"B5 {what} {fmt.name} gate={gate}: codes == twin == float entry "
        f"{eq} max_abs_err={err:.3g}")
    if not eq or not torch.isfinite(out).all():
        raise AssertionError(f"B5 != twin at {what} {fmt.name} gate={gate}")
    return err


def check_b4_b5(torch, dev, gen):
    """B4 == B1 == twin and B5 == twin (torch.equal) at the group path's
    shapes; B4 also at flush_period=1; B5's codes and float entries, and at
    E5M2 / E3M4 / E4M3 with the gate on and off; B5's device rounding
    tables == the twin's."""
    from repro_torch.core.formats import E3M4, E4M3, E5M2, decode_bits
    from repro_torch.kernels.mgs_matmul import (
        dmac_table, dmac_table_plain, limb_decompose, mgs_matmul_exact,
        mgs_matmul_exact_fused, mgs_matmul_exact_plain)
    for fmt in (E4M3, E5M2, E3M4):
        for gate in (True, False):
            same = torch.equal(dmac_table(dev, fmt, gate).cpu(),
                               dmac_table_plain(fmt, gate))
            log(f"B5 rounding table {fmt.name} gate={gate}: device == twin "
                f"{same}")
            if not same:
                raise AssertionError(f"B5 table != twin at {fmt.name}")
    worst4 = worst5 = 0.0
    for name, Bt, M, K, N in B45_SHAPES + EXACT_EXTRA:
        xc = fp8_codes(torch, (Bt, M, K), dev, gen)
        wc = fp8_codes(torch, _weight_shape(name, Bt, K, N), dev, gen)
        xl = limb_decompose(decode_bits(xc, E4M3)).movedim(0, 1)
        wl = limb_decompose(decode_bits(wc, E4M3)).movedim(0, -3)
        for tag, kw in EXACT_CADENCES:
            out = mgs_matmul_exact(xl, wl, E4M3, **kw)
            b1 = mgs_matmul_exact_fused(xc, wc, E4M3, **kw)
            twin = mgs_matmul_exact_plain(xl, wl, E4M3, **kw)
            torch.cuda.synchronize()
            err = (out - twin).abs().max().item()
            worst4 = max(worst4, err)
            eq = torch.equal(out, b1) and torch.equal(out, twin)
            log(f"B4 {name:22s} {Bt}x({M}x{K} @ {K}x{N}) {tag or 'default':15s}"
                f": B4 == B1 == twin {eq} max_abs_err={err:.3g}")
            if not eq or not torch.isfinite(out).all():
                raise AssertionError(f"B4 != B1/twin at {name} {tag}")
        del xl, wl, xc, wc
        if (name, Bt, M, K, N) in EXACT_EXTRA:
            continue
        x = _margin_values(torch, (Bt, M, K), dev, gen)
        w = _margin_values(torch, (Bt, K, N), dev, gen)
        worst5 = max(worst5, _b5_equal(
            torch, x, w, E4M3, True, f"{name:22s} {Bt}x({M}x{K} @ {K}x{N})"))
        del x, w
    for fmt in (E5M2, E3M4, E4M3):
        x = _margin_values(torch, (3, 13, 300), dev, gen, fmt)
        w = _margin_values(torch, (3, 300, 75), dev, gen, fmt)
        for gate in (True, False):
            worst5 = max(worst5, _b5_equal(torch, x, w, fmt, gate,
                                           "3x(13x300 @ 300x75)"))
    return worst4, worst5


def paper_configs():
    """The paper phase's configurations in run order: key -> (name,
    quant config)."""
    from repro_torch.quant import config as q
    return {"none": ("unquantized bf16", q.NONE),
            "a": ("FP8_MGS (B5)", q.FP8_MGS.replace(use_kernel=True)),
            "b": ("FP8_MGS_EXACT (B4)",
                  q.FP8_MGS_EXACT.replace(use_kernel=True)),
            "c": ("FP8_WIDE", q.FP8_WIDE),
            "d": ("FP8_MGS_SERVE (B1)", q.FP8_MGS_SERVE),
            "e": ("INT8_DMAC", q.INT8_DMAC)}


def serve_paper(torch, layers: int):
    """Group serving of deepseek-7b at full width under the unquantized
    model and configurations (a)-(e) on one bf16 parameter set: launches,
    tokens, logits, PREP_STATS / nvcc flat, and a profiled decode step of
    (a)-(e). Prepared planes are dropped between runs; (e) ``INT8_DMAC``
    prepares nothing (integer configs keep raw weights) and launches no
    kernel (its integer sums are exact float64 matmuls)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.kernels import BUILDS, LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.models import cast_params, init_params
    from repro_torch.quant import PREP_STATS, clear_prepared_cache
    import numpy as np

    def release():
        clear_prepared_cache()
        gc.collect()
        torch.cuda.empty_cache()

    release()
    base = dataclasses.replace(get_config("deepseek-7b"), n_layers=layers)
    params = cast_params(init_params(base, SEED, device="cuda"), base)
    torch.cuda.synchronize()
    prompts = paper_prompts(base.vocab)
    # 2 groups x (prefill: 9 per layer + 1 logits head; 15 decode steps:
    # 9 per layer (7 projections + the score / value contractions against
    # the float cache) + 1 logits head)
    per_run = 2 * ((9 * layers + 1) + 15 * (9 * layers + 1))
    want = {"none": {}, "a": {"mgs_matmul_dmac": per_run},
            "b": {"mgs_matmul_exact": per_run}, "c": {},
            "d": {"mgs_matmul_exact_fused": per_run}, "e": {}}
    runs, steps = {}, {}
    for key, (name, quant) in paper_configs().items():
        cfg = dataclasses.replace(base, quant=quant)
        t0 = time.time()
        eng = ServeEngine(cfg, batch=4, max_len=32 + 16 + 1, params=params)
        eng.warmup([32], max_new=1)
        t_build = time.time() - t0
        reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=16)
                for i, p in enumerate(prompts)]
        prep0, builds0 = dict(PREP_STATS), dict(BUILDS)
        reset_launch_counts()
        stats = eng.run(reqs, record_logits=True)
        launches = dict(LAUNCHES)
        logits = stats.pop("logits")
        log(f"paper ({key}) {name}: engine + warmup "
            f"{t_build:.1f} s; {stats['decode_tokens']} tokens in "
            f"{stats['wall_s']:.2f} s; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        expect = {k: want[key].get(k, 0) for k in launches}
        if launches != expect:
            raise AssertionError(f"({key}) launch counts {launches} != "
                                 f"predicted {expect}")
        if dict(PREP_STATS) != prep0 or dict(BUILDS) != builds0:
            raise AssertionError(f"({key}) serving re-prepared weights or "
                                 "rebuilt a kernel")
        rows = {r.rid: np.stack(logits[r.rid]) for r in reqs}
        if stats["decode_tokens"] != 8 * 16 or any(
                v.shape != (16, base.vocab) or not np.isfinite(v).all()
                for v in rows.values()):
            raise AssertionError(f"({key}) did not serve 8 x 16 finite rows")
        runs[key] = dict(tokens={r.rid: list(r.out_tokens) for r in reqs},
                         logits=rows, launches=launches, stats=stats)
        if key != "none":
            steps[key] = profile_decode_step(torch, eng)
        del eng
        release()
    del params
    release()
    return runs, steps


def paper_accuracy(runs):
    """(b) against (d), and every configuration against the unquantized
    model: greedy-token agreement and logit error relative to the
    reference's logit scale."""
    import numpy as np
    names = {k: v[0] for k, v in paper_configs().items()}
    ref = runs["none"]
    acc = {}
    for key in ("a", "b", "c", "d", "e"):
        r = runs[key]
        agree = [a == b for rid in ref["tokens"]
                 for a, b in zip(r["tokens"][rid], ref["tokens"][rid])]
        first = [r["tokens"][rid][0] == ref["tokens"][rid][0]
                 for rid in ref["tokens"]]
        diff = np.stack([r["logits"][i] - ref["logits"][i]
                         for i in ref["logits"]]).astype(np.float64)
        scale = max(np.abs(v).max() for v in ref["logits"].values())
        acc[key] = dict(token_agreement=float(np.mean(agree)),
                        first_token_agreement=float(np.mean(first)),
                        max_logit_err=float(np.abs(diff).max() / scale),
                        rms_logit_err=float(np.sqrt((diff ** 2).mean())
                                            / scale),
                        first_step_max_logit_err=float(
                            np.abs(diff[:, 0]).max() / scale))
        log(f"paper accuracy {names[key]} vs the unquantized bf16 "
            f"model: greedy tokens agree {acc[key]['token_agreement']:.3f} "
            f"(first token {acc[key]['first_token_agreement']:.3f}); logit "
            f"error max {acc[key]['max_logit_err']:.4g}, rms "
            f"{acc[key]['rms_logit_err']:.4g} of the logit scale (first "
            f"step max {acc[key]['first_step_max_logit_err']:.4g})")
    b, d = runs["b"], runs["d"]
    same = all(b["tokens"][i] == d["tokens"][i] for i in d["tokens"])
    scale = max(np.abs(v).max() for v in d["logits"].values())
    worst = max(np.abs(b["logits"][i] - d["logits"][i]).max()
                for i in d["logits"]) / scale
    log(f"paper (b) vs (d): greedy tokens equal {same}; largest logit "
        f"difference {worst:.4g} of the logit scale (bound 0.05)")
    if not same or worst > 0.05:
        raise AssertionError("FP8_MGS_EXACT (B4) and FP8_MGS_SERVE (B1) "
                             "disagree beyond the bound")
    acc["b_vs_d_max_logit_diff"] = float(worst)
    return acc


def time_b45(torch, dev, gen):
    """B4 and B5 at the group path's shapes beside their bounds, twins and
    torch.matmul in float32 over the decoded values; weights cycle through
    enough copies to leave L2. B5 is timed through its codes entry (the
    path's) and through its float entry (the encode included)."""
    from repro_torch.core.formats import E4M3, encode_bits
    from repro_torch.kernels.mgs_matmul import (
        limb_decompose, mgs_matmul_dmac, mgs_matmul_dmac_codes,
        mgs_matmul_dmac_codes_plain, mgs_matmul_exact,
        mgs_matmul_exact_plain, split_plan)
    rows = []
    for name, Bt, M, K, N in B45_SHAPES:
        copies = max(1, min(8, -(-200_000_000 // (Bt * K * N))))
        x = _margin_values(torch, (Bt, M, K), dev, gen)
        ws = [_margin_values(torch, (Bt, K, N), dev, gen)
              for _ in range(copies)]
        xl = limb_decompose(x).movedim(0, 1).contiguous()
        wls = [limb_decompose(w).movedim(0, 1).contiguous() for w in ws]
        xc = encode_bits(x, E4M3)
        wcs = [encode_bits(w, E4M3) for w in ws]
        it = iter(range(10**9))

        def nxt():
            return next(it) % copies
        b4 = time_ms(torch, lambda: mgs_matmul_exact(xl, wls[nxt()]), 20)
        b4_plain = time_ms(torch, lambda: mgs_matmul_exact_plain(
            xl, wls[nxt()]), 3, warmup=1)
        b5 = time_ms(torch, lambda: mgs_matmul_dmac_codes(xc, wcs[nxt()]),
                     20)
        b5_float = time_ms(torch, lambda: mgs_matmul_dmac(x, ws[nxt()]), 20)
        b5_plain = time_ms(torch, lambda: mgs_matmul_dmac_codes_plain(
            xc, wcs[nxt()]), 2, warmup=1)
        lib = time_ms(torch, lambda: torch.matmul(x, ws[nxt()]), 20)
        b4_b, b4_by = b4_bound(Bt, M, K, N)
        b5_b, b5_by = dmac_bound(Bt, M, K, N)
        b1_b, b1_by = b1_bound(Bt, M, K, N)
        rows.append(dict(shape=name, Bt=Bt, M=M, K=K, N=N, b1_bound_ms=b1_b,
                         b1_bound_by=b1_by, b4_ms=b4,
                         b4_plain_ms=b4_plain, b4_bound_ms=b4_b,
                         b4_bound_by=b4_by,
                         b4_splits=split_plan(Bt, M, K, N, 128, None).splits,
                         b5_ms=b5, b5_float_ms=b5_float,
                         b5_plain_ms=b5_plain,
                         b5_bound_ms=b5_b, b5_bound_by=b5_by,
                         library_ms=lib))
        log(f"time {name:22s} {Bt}x({M}x{K} @ {K}x{N}): B4 {b4:.4f} ms "
            f"(twin {b4_plain:.4f}, bound {b4_b:.4f} {b4_by}); B5 {b5:.4f} "
            f"ms (float entry {b5_float:.4f}, twin {b5_plain:.4f}, bound "
            f"{b5_b:.4f} {b5_by}); torch.matmul f32 {lib:.4f} ms; B1 bound "
            f"{b1_b:.4f} {b1_by}")
        del x, ws, xl, wls, xc, wcs
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 8: calibration on the card (both engines, the phase 4 / 6 weights)
# ---------------------------------------------------------------------------


class _SwapAtDecode:
    """Injector: a table swap at one decode step inside a group."""

    def __init__(self, engine, table, step):
        self.engine, self.table, self.step = engine, table, step
        self.fired = False

    def before_group(self):
        pass

    def on_decode(self, step):
        if step == self.step and not self.fired:
            self.fired = True
            self.engine.apply_calibration(self.table)


def _flat_or_raise(what, prep0, builds0):
    from repro_torch.kernels import BUILDS
    from repro_torch.quant import PREP_STATS
    if dict(PREP_STATS) != prep0 or dict(BUILDS) != builds0:
        raise AssertionError(f"{what}: PREP_STATS {PREP_STATS} (before "
                             f"{prep0}) or nvcc builds {BUILDS} (before "
                             f"{builds0}) moved")


def _replay_or_raise(eng, req, logged, what, group=None):
    rep, st = eng.replay(req, group=group)
    if rep.out_tokens != req.out_tokens or not _logits_equal(
            st["logits"][req.rid], logged):
        raise AssertionError(f"{what}: replay of request {req.rid} under "
                             f"v{req.table_version} is not bitwise")
    log(f"calibration {what}: request {req.rid} replayed bitwise under "
        f"v{req.table_version}")


def calibrate_group(torch, params, layers: int):
    """Phase 8, group engine: serve v0, ``calibrate()`` to v1, serve, a
    refreshed v2 with a mid-group swap to v3 through an injector, replay
    v0, v1 and the torn group bitwise; launches per run as phase 4's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import BUILDS, LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.quant import PREP_STATS
    from repro_torch.quant.config import FP8_MGS_SERVE_KV
    import numpy as np
    quant = FP8_MGS_SERVE_KV.replace(flush_target=1e-6)
    cfg = dataclasses.replace(get_config("deepseek-7b"), n_layers=layers,
                              quant=quant)
    new = 8
    eng = ServeEngine(cfg, batch=4, max_len=32 + new + 1, params=params)
    eng.warmup([32], max_new=1)
    prep0, builds0 = dict(PREP_STATS), dict(BUILDS)
    rng = np.random.default_rng(SEED + 8)

    def reqs(rid0):
        return [Request(rid=rid0 + i, prompt=rng.integers(
            1, cfg.vocab, 32).astype(np.int32), max_new_tokens=new)
            for i in range(4)]

    # one group: prefill 9 per layer + head, then new - 1 decode steps
    want = {"mgs_matmul_exact_fused": (9 * layers + 1)
            + (new - 1) * (7 * layers + 1),
            "mgs_flash_attention": (new - 1) * layers}

    def serve(rr, **kw):
        reset_launch_counts()
        st = eng.run(rr, record_logits=True, **kw)
        got = {k: LAUNCHES[k] for k in want}
        if got != want:
            raise AssertionError(f"group launches {got} != {want}")
        return {r.rid: st["logits"][r.rid] for r in rr}

    r0 = reqs(0)
    l0 = serve(r0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t1 = eng.calibrate()
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    log(f"calibration group: calibrate() {calib_s:.3f} s -> v"
        f"{eng.table_version} {t1}")
    log(f"calibration group: planned flush periods {eng._flush_host}")
    r1 = reqs(10)
    l1 = serve(r1)
    t2 = t1.refreshed([(s, v * 1.5) for s, v in t1.to_pairs()])
    if eng.apply_calibration(t2) != 2:
        raise AssertionError("refresh did not install v2")
    t3 = t2.refreshed([(s, v * 0.75) for s, v in t2.to_pairs()])
    r2 = reqs(20)
    probe = _SwapAtDecode(eng, t3, step=3)
    l2 = serve(r2, injector=probe)
    stamps = [r.table_version for r in r0 + r1 + r2]
    if not probe.fired or eng.table_version != 3 or stamps != (
            [0] * 4 + [1] * 4 + [2] * 4):
        raise AssertionError(f"versions {stamps}, head v{eng.table_version}")
    log(f"calibration group: stamps {stamps}, a swap to v3 at decode step "
        f"3 of v2's group; launches per run {want} (phase 4's 7L + 1 B1 "
        f"and L B2 a decode step) with and without a table")
    for rr, logged, what in ((r0, l0, "group v0"), (r1, l1, "group v1"),
                             (r2, l2, "group torn by a mid-group swap")):
        _replay_or_raise(eng, rr[0], logged[rr[0].rid], what, group=rr)
    _flat_or_raise("group calibration", prep0, builds0)
    return {"calibrate_s": calib_s, "versions": eng.table_version,
            "table": dict(t1.to_pairs()),
            "flush_periods": dict(eng._flush_host),
            "launches_per_run": want}


def calibrate_continuous(torch, params, layers: int, dyn_step):
    """Phase 8, continuous engine (``spec_k=4``, static decode-query scale,
    ``flush_target``): ``calibrate()``, a plan-changing swap mid-traffic
    that must fence (late arrivals on the new version, nothing dropped),
    replay of every era bitwise, a streaming refresh; a profiled paged
    decode step under the static scale beside phase 6's dynamic one."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import BUILDS
    from repro_torch.launch.serve import ContinuousBatchingEngine, Request
    from repro_torch.quant import PREP_STATS
    from repro_torch.quant.config import FP8_MGS_SERVE_PAGED
    import numpy as np
    quant = FP8_MGS_SERVE_PAGED.replace(schedule="activation",
                                        static_q_scale=True,
                                        flush_target=1e-6, draft_layers=8)
    cfg = dataclasses.replace(get_config("deepseek-7b"), n_layers=layers,
                              quant=quant)
    eng = ContinuousBatchingEngine(cfg, slots=4, max_len=256, params=params,
                                   spec_k=4)
    eng.warmup([64, 128, 192])
    torch.cuda.synchronize()
    prep0, builds0 = dict(PREP_STATS), dict(BUILDS)
    rng = np.random.default_rng(SEED + 9)

    def mk(rid, new=8):
        n = int(rng.integers(16, 161))
        return Request(rid=rid, prompt=rng.integers(1, cfg.vocab, n).astype(
            np.int32), max_new_tokens=new)

    def serve(rr, **kw):
        return eng.serve(rr, record_logits=True, **kw)["logits"]

    r0 = [mk(0), mk(1)]
    l0 = serve(r0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t1 = eng.calibrate()
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    if not eng._amax_value > 0.0:
        raise AssertionError("calibrate() left no static decode-query amax")
    log(f"calibration continuous: calibrate() {calib_s:.3f} s -> v"
        f"{eng.table_version}, attn.q.amax {eng._amax_value:.4f}")
    r1 = [mk(10), mk(11)]
    l1 = serve(r1)
    t2 = t1.refreshed([(s, v * 4.0) for s, v in t1.to_pairs()])
    if eng._plan_flush_host(t2) == eng._flush_host:
        raise AssertionError("the x4 table does not change the flush plan")
    state = {"round": 0, "late": None, "fenced": None}

    def feed():
        state["round"] += 1
        if state["round"] == 2:
            eng.apply_calibration(t2)
            state["fenced"] = eng._pending is not None
            state["late"] = [mk(30, 6), mk(31, 6)]
            return state["late"]
        return []

    resident = [mk(20, 16), mk(21, 16)]
    l2 = serve(resident, feed=feed)
    late = state["late"]
    stamps = [r.table_version for r in r0 + r1 + resident + late]
    drops = sum(len(r.out_tokens) != r.max_new_tokens
                for r in resident + late)
    if (not state["fenced"] or drops or eng._pending is not None
            or stamps != [0, 0, 1, 1, 1, 1, 2, 2]):
        raise AssertionError(f"fence: fenced {state['fenced']}, drops "
                             f"{drops}, stamps {stamps}")
    log(f"calibration continuous: a plan-changing swap at round 2 fenced; "
        f"stamps {stamps}, {drops} dropped")
    for req, logged, what in ((r0[0], l0, "continuous v0"),
                              (r1[0], l1, "continuous v1"),
                              (resident[0], l2, "continuous v1, fenced"),
                              (late[0], l2, "continuous v2, after fence")):
        _replay_or_raise(eng, req, logged[req.rid], what)
    cal = eng.enable_streaming(seed=1, sample_period=2, sigma_rtol=0.0,
                               min_calls=1)
    r3 = [mk(40), mk(41)]
    serve(r3)
    if not any(cal.recorder.calls(s) for s in cal.recorder.sites):
        raise AssertionError("no shadow pass recorded")
    v_before = eng.table_version
    report = eng.maybe_refresh_calibration()
    if report is None or eng.table_version != v_before + 1:
        raise AssertionError("the streaming refresh did not bump the table")
    log(f"calibration continuous: streaming refresh v{v_before} -> "
        f"v{eng.table_version} (drifted sites {len(report.drifted_sites)})")
    toks = np.zeros((1, 128), np.int64)
    toks[0] = rng.integers(1, cfg.vocab, 128)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._shadow_pass(toks)
    torch.cuda.synchronize()
    shadow_s = time.perf_counter() - t0
    log(f"calibration continuous: one shadow pass (128-token prefill + a "
        f"decode step) {shadow_s:.3f} s")
    _flat_or_raise("continuous calibration", prep0, builds0)
    step = profile_paged_step(torch, eng)
    for k in ("B3", "B2"):
        if step[f"{k}_kernels"] != dyn_step[f"{k}_kernels"]:
            raise AssertionError(f"{k} launches a step {step[f'{k}_kernels']}"
                                 f" != phase 6's {dyn_step[f'{k}_kernels']}")
    log(f"calibration continuous: paged decode step, static vs dynamic "
        f"(phase 6) query scale: device busy {step['device_ms']:.2f} / "
        f"{dyn_step['device_ms']:.2f} ms, other kernels "
        f"{step['other_kernels']} / {dyn_step['other_kernels']}, B3 "
        f"{step['B3_kernels']}, B2 {step['B2_kernels']}")
    return {"calibrate_s": calib_s, "shadow_pass_s": shadow_s,
            "q_amax": eng._amax_value, "versions": eng.table_version,
            "stamps": stamps, "static_step": step,
            "flush_periods": dict(eng._flush_host)}


# ---------------------------------------------------------------------------
# phase 9: the other families (MoE, SSM) on the group serving path
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("granite-moe-1b-a400m", "falcon-mamba-7b")
# the families' served depth where it is cut (full width): falcon-mamba-7b
# at 64 layers took 70.2 s of a 124.8 s phase, and the script 1130.4 s, on
# an H100
FAMILY_DEPTHS = {"falcon-mamba-7b": 16}
# the B1 launches of phase 4's traffic (batch 4, 32-token prompts) that a
# check's settings cover: no bias, block_k 128, the worst-case flush and one
# weight per slice
B1_CHECKED = (False, 128, None, False)


def family_b1_checks():
    """B1's checked and timed shapes in phase 9: those of
    ``family_b1_shapes`` for the full-width ``FAMILY_ARCHS``."""
    from repro_torch.configs import get_config
    return [s for arch in FAMILY_ARCHS
            for s in family_b1_shapes(get_config(arch))]


@contextlib.contextmanager
def recording_b1():
    """Collects each B1 call the models make (through ``qmatmul`` and
    ``kernels.ops``) as (Bt, M, K, N, activation, bias given, block_k,
    flush_period, one weight shared by every slice)."""
    import importlib
    from repro_torch.kernels.mgs_matmul import mgs_matmul_exact_fused as b1
    mods = [importlib.import_module(m) for m in (
        "repro_torch.quant.qmatmul", "repro_torch.kernels.ops")]
    seen = set()

    def rec(x, w, *a, **kw):
        if kw.get("schedule", "output") == "output":
            Bt, M, K = x.shape if x.dim() == 3 else (1, *x.shape)
            seen.add((Bt, M, K, w.shape[-1], kw.get("activation", "none"),
                      kw.get("bias") is not None, kw.get("block_k", 128),
                      kw.get("flush_period"), x.dim() == 3 and w.dim() == 2))
        return b1(x, w, *a, **kw)
    for m in mods:
        m.mgs_matmul_exact_fused = rec
    try:
        yield seen
    finally:
        for m in mods:
            m.mgs_matmul_exact_fused = b1


def unchecked_b1(seen, shapes):
    """The recorded B1 calls (``recording_b1``) that no check at ``shapes``
    covers."""
    keys = {s[1:] for s in shapes}
    return {c for c in seen if c[:5] not in keys or c[5:] != B1_CHECKED}


# B2 at granite-moe-1b-a400m's group decode: 4 requests x 8 kv heads, 2
# query rows (16 heads) of head dim 64, a 49-token cache padded to one
# 128-key chunk
FAMILY_B2 = dict(N=32, T=2, D=64, chunk=128, S=128)


# bytes of float64 limb planes the B1 twin may hold for one call (larger
# shapes are held in slices and column chunks)
TWIN_BYTES = 4e9


def b1_twin(torch, x, w, fmt, scale=None, **kw):
    """The B1 twin on ``(Bt, M, K) @ (Bt, K, N)``, one slice and column
    chunk at a time where its float64 limb planes would pass
    ``TWIN_BYTES``: every output element depends on its own row, column
    and slice alone, so the pieces are the whole call's bits."""
    from repro_torch.kernels.mgs_matmul import mgs_matmul_exact_fused_plain
    Bt, K, N = w.shape
    if Bt * K * min(N, 16384) * 24 <= TWIN_BYTES:
        return mgs_matmul_exact_fused_plain(x, w, fmt, scale=scale, **kw)
    cols = max(128, int(TWIN_BYTES // (K * 24)) // 128 * 128)
    out = torch.empty((Bt, x.shape[1], N), dtype=torch.float32,
                      device=x.device)
    for b in range(Bt):
        for n0 in range(0, N, cols):
            out[b:b + 1, :, n0:n0 + cols] = mgs_matmul_exact_fused_plain(
                x[b:b + 1], w[b:b + 1, :, n0:n0 + cols], fmt,
                scale=None if scale is None else scale[b:b + 1], **kw)
    return out


def check_family_b1(torch, dev, gen, shapes=None):
    """B1 == twin (``torch.equal``) at ``shapes`` (``family_b1_checks()``),
    with no epilogue, with per-slice scales and with the path's
    activation; a slice of zero codes (an expert no token chose) gives
    zeros."""
    from repro_torch.core.formats import E4M3
    from repro_torch.kernels.mgs_matmul import mgs_matmul_exact_fused
    worst = 0.0
    for name, Bt, M, K, N, act in shapes or family_b1_checks():
        x = fp8_codes(torch, (Bt, M, K), dev, gen)
        if Bt > 1:
            x[1] = 0
        w = fp8_codes(torch, (Bt, K, N), dev, gen)
        scale = torch.rand((Bt, 1, 1), generator=gen, device=dev) * 1e-4
        tags = [("none", {}), ("scale", {"scale": scale})]
        if act != "none":
            tags.append((f"scale+{act}", {"scale": scale, "activation": act}))
        for tag, kw in tags:
            out = mgs_matmul_exact_fused(x, w, E4M3, **kw)
            twin = b1_twin(torch, x, w, E4M3, **kw)
            torch.cuda.synchronize()
            err = (out - twin).abs().max().item()
            worst = max(worst, err)
            eq = torch.equal(out, twin)
            log(f"B1 {name:20s} {Bt}x({M}x{K} @ {K}x{N}) {tag:11s} "
                f"equal={eq} max_abs_err={err:.3g}")
            if not eq:
                raise AssertionError(f"B1 kernel != twin at {name} {tag}")
            if not torch.isfinite(out).all() or (
                    Bt > 1 and out[1].abs().max().item() != 0.0):
                raise AssertionError(f"B1 at {name}: non-finite output, or "
                                     "a zero slice is not zero")
        del x, w
    return worst


def serve_family(torch, arch: str, layers: int, checks=None):
    """Phase 4's serving (``serve_full``) of ``arch``, then one profiled
    decode step with the predicted B1 / B2 launches; every B1 launch must
    be at a shape ``check_family_b1`` held (``checks``, by default
    ``family_b1_checks()``). The model is freed."""
    import gc
    from repro_torch.quant import clear_prepared_cache
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with recording_b1() as seen:
        launches, stats, eng, reqs, _ = serve_full(torch, arch, layers)
        _, (b1_step, b2_step) = group_launches(eng.cfg)
        step = profile_decode_step(torch, eng)
    if (step["B1_kernels"], step["B2_kernels"]) != (b1_step, b2_step):
        raise AssertionError(f"{arch}: a decode step launched "
                             f"{step['B1_kernels']} B1 / {step['B2_kernels']}"
                             f" B2, predicted {b1_step} / {b2_step}")
    missed = unchecked_b1(seen, checks or family_b1_checks())
    if missed:
        raise AssertionError(f"{arch}: B1 launched at shapes no check "
                             f"covers: {sorted(missed, key=str)}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"family {arch}: {time.time() - t0:.1f} s, peak device memory "
        f"{peak:.1f} GiB, B1 at {len(seen)} launch shapes, each checked")
    del eng
    clear_prepared_cache()
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, stats=stats, decode_step=step,
                peak_gib=peak, layers=layers,
                prompts=[r.prompt.tolist() for r in reqs],
                tokens=[r.out_tokens for r in reqs])


def _scale_ssm_out(params):
    """Seed-0 reduced falcon-mamba echoes each prompt's last token; the
    out-projections scaled by 8 make the tokens vary."""
    params["layers"]["ssm"]["wo"] *= 8.0


def family_phase(torch, dev, gen):
    """Phase 9: B1 / B2 at the families' shapes, reduced MoE / SSM models
    on the card and the CPU, the two full-width models, the kernel times."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.quant import clear_prepared_cache
    clear_prepared_cache()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    b1_err = check_family_b1(torch, dev, gen)
    b2_err, b2_args = check_b2(torch, dev, gen, **FAMILY_B2)
    log(f"family kernels: B1 == twin at {len(family_b1_checks())} shapes, B2 "
        f"== twin at granite-moe's heads ({time.time() - t0:.1f} s)")
    serve_reduced_gpu_vs_cpu(torch, arch="granite-moe-1b-a400m")
    serve_reduced_gpu_vs_cpu(torch, arch="falcon-mamba-7b",
                             edit=_scale_ssm_out)
    runs = {arch: serve_family(torch, arch, FAMILY_DEPTHS.get(
                arch, get_config(arch).n_layers)) for arch in FAMILY_ARCHS}
    b1_rows = time_b1(torch, dev, gen, family_b1_checks())
    b2_row = time_b2(torch, b2_args)
    del b2_args
    torch.cuda.empty_cache()
    return dict(b1_err=b1_err, b2_err=b2_err, runs=runs, b1_shapes=b1_rows,
                b2=b2_row)


# ---------------------------------------------------------------------------
# phase 10: the hybrid, encoder-decoder and VLM families on the group path
# ---------------------------------------------------------------------------

# served at full width (jamba-1.5-large-398b's experts alone are 77 GB in
# bf16: only its period's shapes run at full width)
LATE_ARCHS = ("whisper-tiny", "internvl2-2b")
HYBRID_ARCH = "jamba-1.5-large-398b"
# B2 at the three families' heads: whisper-tiny's cross-attention (4
# requests x 6 kv heads, one query row of head dim 64, 1500 live frames of
# 1536 keys, the rest masked by a non-causal bias row) and its
# self-attention over a 49-token cache; internvl2-2b's (8 kv heads x 2
# rows of 128) over the 305-token cache (3 chunks, up to 304 live keys);
# jamba's (8 kv heads x 8 rows of 128)
LATE_B2 = {
    "whisper-tiny cross": dict(N=24, T=1, D=64, S=1536, live=1500),
    "whisper-tiny self": dict(N=24, T=1, D=64, S=128),
    "internvl2-2b": dict(N=32, T=2, D=128, S=384, most=304),
    "jamba-1.5-large-398b": dict(N=32, T=8, D=128, S=128),
}


def late_b1_checks():
    """B1's checked shapes in phase 10: every launch shape of the two
    full-width models' runs, and of one full-width jamba period (its
    experts at prefill 16 x (20 x 8192 @ 8192 x 24576))."""
    from repro_torch.configs import get_config
    return [s for arch in LATE_ARCHS + (HYBRID_ARCH,)
            for s in family_b1_shapes(get_config(arch))]


def _scale_out(params):
    """Seed-0 reduced whisper / internvl2 echo each prompt's last token;
    the residual output projections scaled by 8 make the tokens vary."""
    for root in ("layers", "cross"):
        if root in params:
            params[root]["attn"]["wo"] *= 8.0
    params["layers"]["ffn"]["wd"] *= 8.0


def model_gpu_vs_cpu(torch, arch: str, edit=None, steps: int = 4):
    """A model-level prefill and ``steps`` decode steps of reduced ``arch``
    with seeded random audio / vision embeddings (the engine's zero stub
    gives whisper an all-zero encoder output, so its served runs never
    exercise cross-attention), on the card (kernels) and the CPU (twins):
    equal tokens, logits within the engine bar; on the card every decode
    step runs B2 once a layer, twice for an encoder-decoder (its cross
    planes)."""
    from repro_torch.configs import reduced_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models import decode_step, init_cache, init_params, \
        prefill
    from repro_torch.quant.config import FP8_MGS_SERVE_KV
    import numpy as np
    cfg = dataclasses.replace(reduced_config(arch), compute_dtype="float32",
                              quant=FP8_MGS_SERVE_KV)
    params = init_params(cfg, SEED)
    if edit is not None:
        edit(params)
    rng = np.random.default_rng(SEED)
    B, T, d = 2, 12, cfg.d_model
    side = {"tokens": rng.integers(1, cfg.vocab, (B, T))}
    if cfg.vision_prefix:
        side["vision_embeds"] = rng.normal(0, 0.1, (B, cfg.vision_prefix, d))
    if cfg.encoder_layers:
        side["audio_embeds"] = rng.normal(0, 0.1, (B, cfg.encoder_len, d))
    max_len = cfg.vision_prefix + T + steps + 1
    out = {}
    for dev in ("cuda", "cpu"):
        eng = ServeEngine(cfg, batch=B, max_len=max_len,
                          params=_tree_to(params, dev), device=dev)
        batch = {k: torch.as_tensor(v, device=dev, dtype=(
            torch.int64 if k == "tokens" else torch.float32))
            for k, v in side.items()}
        reset_launch_counts()
        logits, cache = prefill(eng.params, cfg, batch,
                                init_cache(cfg, B, max_len, device=dev))
        rows, toks = [], []
        for step in range(steps + 1):
            cur = logits.argmax(dim=-1)[:, None]
            rows.append(logits.float().cpu().numpy())
            toks.append(cur.cpu().numpy()[:, 0])
            if step < steps:
                logits, cache = decode_step(eng.params, cfg, cur, cache)
        out[dev] = (np.stack(toks, 1), np.stack(rows), dict(LAUNCHES))
    (tg, lg, launches), (tc, lc, _) = out["cuda"], out["cpu"]
    b2 = steps * cfg.n_layers * (2 if cfg.encoder_layers else 1)
    if launches["mgs_flash_attention"] != b2:
        raise AssertionError(f"{arch}: {launches['mgs_flash_attention']} B2 "
                             f"launches in {steps} decode steps, not {b2}")
    scale = np.abs(lc).max()
    err = np.abs(lg - lc)
    if not np.array_equal(tg, tc) or err.max() > 5e-2 * scale \
            or err.mean() > 1e-2 * scale:
        raise AssertionError(f"reduced {arch} with random side inputs: GPU "
                             f"tokens {tg.tolist()} vs CPU {tc.tolist()}, "
                             f"max logit diff {err.max() / scale:.3g} of "
                             "scale")
    log(f"reduced {arch} model-level prefill + {steps} decode steps with "
        f"seeded side inputs: GPU == CPU tokens {tg.tolist()}, max logit "
        f"diff {err.max():.3g}, {b2} B2 launches")


def late_phase(torch, dev, gen):
    """Phase 10: B1 at the three families' shapes (jamba's from its config),
    B2 at their heads, reduced jamba / whisper / internvl2 on the card and
    the CPU (served, and whisper / internvl2 also at model level with
    random side inputs), whisper-tiny and internvl2-2b at full width."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.quant import clear_prepared_cache
    clear_prepared_cache()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    checks = late_b1_checks()
    b1_err = check_family_b1(torch, dev, gen, checks)
    b2_err, b2_args = 0.0, {}
    for label, shape in LATE_B2.items():
        err, b2_args[label] = check_b2(torch, dev, gen, **shape)
        b2_err = max(b2_err, err)
    log(f"late family kernels: B1 == twin at {len(checks)} shapes, B2 == "
        f"twin at {len(LATE_B2)} head shapes ({time.time() - t0:.1f} s)")
    serve_reduced_gpu_vs_cpu(torch, arch=HYBRID_ARCH)
    for arch in LATE_ARCHS:
        serve_reduced_gpu_vs_cpu(torch, arch=arch, edit=_scale_out)
        model_gpu_vs_cpu(torch, arch, edit=_scale_out)
    runs = {arch: serve_family(torch, arch, get_config(arch).n_layers, checks)
            for arch in LATE_ARCHS}
    b2_row = time_b2(torch, b2_args["whisper-tiny cross"])
    del b2_args
    torch.cuda.empty_cache()
    return dict(b1_err=b1_err, b2_err=b2_err, runs=runs, b2_cross=b2_row)


# ---------------------------------------------------------------------------
# phase 11: the paper's accumulation analysis (Fig. 3, Fig. 4b, Table 3)
# ---------------------------------------------------------------------------

FIG3_LENGTHS = (16, 64, 256, 1024, 4096)
FIG3_TRIALS = 16
FIG4_K, FIG4_DOTS, FIG4_NARROW = 576, 64, (8, 9, 10, 12)
TABLE3_K, TABLE3_DOTS = 4096, 32          # deepseek-7b's d_model
TABLE3_SPARSITY = (0.0, 0.5, 0.8, 0.95)
LAYER_SHAPE = (4, 4096, 4096)             # deepseek-7b's decode wq


def _leaves(out):
    """The tensors of a result: a tensor, or (nested) tuples of them."""
    if isinstance(out, tuple):
        return [t for o in out for t in _leaves(o)]
    return [out]


def _same_on_both(torch, label, gpu, cpu):
    """``gpu`` (a result on the card) == ``cpu``, bitwise, or raise naming
    ``label``."""
    gpu, cpu = _leaves(gpu), _leaves(cpu)
    if len(gpu) != len(cpu):
        raise AssertionError(f"{label}: card and CPU results differ in form")
    for i, (a, b) in enumerate(zip(gpu, cpu)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"{label}: card != CPU (field {i})")


def on_both(torch, label, fn, *args):
    """``fn`` on the card and on the CPU (``args`` are CPU tensors); the
    results must be equal bitwise. Returns the CPU result."""
    gpu = fn(*(a.cuda() for a in args))
    cpu = fn(*args)
    torch.cuda.synchronize()
    _same_on_both(torch, label, gpu, cpu)
    return cpu


def analysis_fig3(torch):
    """Fig. 3's traffic (``benchmarks/fig3_dot_error.py``): E4M3 Gaussian
    pairs, 16 trials a length (seeds ``1000 k + t``) in one call per
    algorithm and length, the products summed in ``acc_format(4)``. Every
    algorithm on the card == the CPU; ``mgs_dot_dmac``'s value ==
    ``mgs_dot_exact(mode="dmac")``'s. Returns the mean % error (against the
    float64 sum of the rounded products; ``mgs_exact`` against the exact
    dot) per algorithm and length."""
    import numpy as np
    from repro_torch.core import formats, mgs, summation
    acc4 = summation.acc_format(4)
    E4M3 = formats.E4M3
    algos = {
        "sequential": lambda x, w, p: summation.sequential_sum(p, acc4),
        "pairwise": lambda x, w, p: summation.pairwise_sum(p, acc4),
        "kahan": lambda x, w, p: summation.kahan_sum(p, acc4),
        "mgs_narrow_clip": lambda x, w, p: mgs.mgs_dot_narrow_clipped(x, w),
        "mgs_dmac": lambda x, w, p: mgs.mgs_dot_exact(x, w, E4M3, "dmac"),
        "mgs_exact": lambda x, w, p: mgs.mgs_dot_exact(x, w, E4M3, "exact"),
        "mgs_dmac_emulator": lambda x, w, p: mgs.mgs_dot_dmac(x, w),
    }
    table = {}
    for k in FIG3_LENGTHS:
        xs, ws = [], []
        for t in range(FIG3_TRIALS):
            rng = np.random.default_rng(1000 * k + t)
            xs.append(rng.normal(0, 1, k).astype(np.float32))
            ws.append(rng.normal(0, 1, k).astype(np.float32))
        x = formats.round_to_format(torch.from_numpy(np.stack(xs)), E4M3)
        w = formats.round_to_format(torch.from_numpy(np.stack(ws)), E4M3)
        p = mgs.round_product(x * w, E4M3)[0]
        ref = p.double().sum(-1).numpy()
        true = (x.double() * w.double()).sum(-1).numpy()
        keep = np.abs(ref) >= 1e-6
        res = {}
        for name, fn in algos.items():
            out = on_both(torch, f"fig3 {name} k={k}", fn, x, w, p)
            res[name] = out
        dm_value, dm_stats = res.pop("mgs_dmac_emulator")
        if not torch.equal(dm_value, res["mgs_dmac"]):
            raise AssertionError(f"fig3 k={k}: mgs_dot_dmac's value != "
                                 "mgs_dot_exact(mode='dmac')")
        row = {}
        for name, out in res.items():
            v = (out[0] if isinstance(out, tuple) else out).double().numpy()
            want = true if name == "mgs_exact" else ref
            err = np.abs(v - want) / np.maximum(np.abs(want), 1e-9)
            row[name] = 100 * float(err[keep].mean())
        row["dmac_overflow_rate"] = float(
            dm_stats.wide_flushes.sum() / max(int(dm_stats.narrow_adds.sum()),
                                              1))
        table[k] = row
        log(f"fig3 k={k} ({int(keep.sum())} trials) mean % error: "
            + ", ".join(f"{n} {e:.4g}" for n, e in row.items()
                        if n != "dmac_overflow_rate")
            + f"; dMAC overflow rate {row['dmac_overflow_rate']:.4g}")
    return table


def analysis_fig4b(torch):
    """Fig. 4b's traffic (``benchmarks/fig4_overflow.py``): 64 dots of K 576,
    5-bit weights x 7-bit post-ReLU activations, the integer dMAC at narrow
    widths 8 / 9 / 10 / 12; the counters on the card == the CPU's. Returns
    the average accumulator bits and overflow rate per width."""
    import numpy as np
    from repro_torch.core import int_dmac
    rng = np.random.default_rng(0)
    out = {}
    for nb in FIG4_NARROW:
        ws, xs = [], []
        for _ in range(FIG4_DOTS):
            ws.append(np.clip(np.rint(rng.normal(0, 5, FIG4_K)), -15, 15))
            xs.append(np.clip(np.rint(np.abs(rng.normal(0, 21, FIG4_K))), 0,
                              127))
        w = torch.from_numpy(np.stack(ws).astype(np.int32))
        x = torch.from_numpy(np.stack(xs).astype(np.int32))
        value, st = on_both(torch, f"fig4b narrow {nb}",
                            lambda a, b: int_dmac.int_dot_dmac(a, b, nb),
                            w, x)
        if not torch.equal(value, int_dmac.int_dot_exact(w, x)):
            raise AssertionError(f"fig4b narrow {nb}: the dMAC is not exact")
        narrow = int(st.narrow_adds.sum())
        wide = int(st.wide_flushes.sum()) + FIG4_DOTS     # + final drains
        avg = float(int_dmac.average_accumulator_bits(narrow, wide, nb, 32))
        out[nb] = dict(avg_bits=avg, overflow_rate=wide / max(narrow, 1))
        log(f"fig4b narrow {nb} bits: average accumulator bits {avg:.4f}, "
            f"overflow rate {wide / max(narrow, 1):.4f}")
    return out


def analysis_table3(torch):
    """Table 3's sparsity sweep (``benchmarks/table3_energy.py``) with FP8
    dMAC counters at K 4096: 32 dots a level in one call, counters on the
    card == the CPU's, fed to ``FP8_MODEL.savings``. The reference draws
    its weights from a trained tiny LM (training is ported, phase 12, but
    the trained weight pool for Table 3 is still to come, ROADMAP A13's
    rest); here the pool is seeded normal values. Then the paper-rate rows."""
    import numpy as np
    from repro_torch.core import energy, formats, mgs
    E4M3 = formats.E4M3
    wpool = np.random.default_rng(SEED + 1).normal(0, 0.02, 200000).astype(
        np.float32)
    rng = np.random.default_rng(0)
    m = energy.FP8_MODEL
    out = {}
    for sparsity in TABLE3_SPARSITY:
        xs, ws = [], []
        for _ in range(TABLE3_DOTS):
            w = rng.choice(wpool, TABLE3_K).astype(np.float32)
            x = np.abs(rng.normal(0, 1.0, TABLE3_K)).astype(np.float32)
            x[rng.random(TABLE3_K) < sparsity] = 0.0
            ws.append(w / (np.abs(w).max() / 448 ** 0.5))
            xs.append(x / (max(np.abs(x).max(), 1e-9) / 448 ** 0.5))
        xq = formats.round_to_format(torch.from_numpy(np.stack(xs)), E4M3)
        wq = formats.round_to_format(torch.from_numpy(np.stack(ws)), E4M3)
        _, st = on_both(torch, f"table3 sparsity {sparsity}",
                        lambda a, b: mgs.mgs_dot_dmac(a, b, E4M3, 5), xq, wq)
        narrow = int(st.narrow_adds.sum())
        flush = int(st.wide_flushes.sum()) + int(st.final_flushes.sum())
        skip, macs = int(st.skipped.sum()), int(st.total_macs.sum())
        s = m.savings(narrow, flush, skip, skipping=True)
        out[sparsity] = dict(savings=s, overflow_rate=flush / max(narrow, 1),
                             skip_rate=skip / max(macs, 1))
        log(f"table3 FP8 dMAC, activation sparsity {sparsity} (weights: "
            f"seeded normal pool, not a trained LM): savings {s:.4f}, "
            f"overflow rate {flush / max(narrow, 1):.4f}, skip rate "
            f"{skip / max(macs, 1):.4f}")
    n = 10**6
    paper = {"fp8_dmac": (m.savings(n, int(0.02 * n)), 0.336),
             "fp8_dmac_skipping": (m.savings(n, int(0.02 * n),
                                             int(0.04 * n), True), 0.341),
             "int8_dmac": (energy.INT8_MODEL.savings(n, int(0.02 * n)),
                           0.154)}
    for name, (s, want) in paper.items():
        log(f"table3 {name} at the paper's 2% overflow rate: savings "
            f"{s:.4f} (paper {want})")
    for unit, row in energy.PAPER_TABLE3.items():
        log(f"table3 paper {unit}: total {row[2]} uW, savings {row[3]}")
    out["paper_rate"] = {k: v[0] for k, v in paper.items()}
    return out


def analysis_layer(torch):
    """``qmatmul`` at the decode ``wq`` shape (4 x 4096 @ 4096 x 4096) under
    fp8 ``swamp`` (``narrow_bits`` 5), ``INT8_DMAC`` and int8 ``clip`` /
    ``wrap`` at ``narrow_bits`` 16 / 24 (int8 products need 15 bits): each
    on the card == the CPU bitwise; the error of each against the float64
    product, beside ``FP8_MGS``'s (B5)."""
    import numpy as np
    from repro_torch.quant import config as q
    from repro_torch.quant.qmatmul import qmatmul
    M, K, N = LAYER_SHAPE
    g = torch.Generator().manual_seed(SEED)
    x = torch.randn((M, K), generator=g)
    w = torch.randn((K, N), generator=g) * K ** -0.5
    ref = (x.double() @ w.double()).numpy()
    scale = np.abs(ref).max()
    cfgs = {"fp8 swamp (narrow 5)": q.QuantConfig(dtype="fp8_e4m3",
                                                  accum="swamp"),
            "INT8_DMAC": q.INT8_DMAC,
            "int8 clip (narrow 16)": q.QuantConfig(dtype="int8",
                                                   accum="clip",
                                                   narrow_bits=16),
            "int8 wrap (narrow 24)": q.QuantConfig(dtype="int8",
                                                   accum="wrap",
                                                   narrow_bits=24)}
    out = {}
    for name, cfg in cfgs.items():
        t0 = time.time()
        y = on_both(torch, f"layer qmatmul {name}",
                    lambda a, b: qmatmul(a, b, cfg), x, w)
        out[name] = dict(max_err=float(np.abs(y.numpy() - ref).max() / scale),
                         rms_err=float(np.sqrt(((y.numpy() - ref) ** 2
                                                ).mean()) / scale),
                         s=time.time() - t0)
    y = qmatmul(x.cuda(), w.cuda(), q.FP8_MGS.replace(use_kernel=True))
    y = y.cpu().double().numpy()
    out["FP8_MGS (B5)"] = dict(max_err=float(np.abs(y - ref).max() / scale),
                               rms_err=float(np.sqrt(((y - ref) ** 2).mean())
                                             / scale))
    for name, r in out.items():
        log(f"layer {M} x {K} @ {K} x {N} {name}: error against the float64 "
            f"product max {r['max_err']:.4g}, rms {r['rms_err']:.4g} of its "
            f"scale" + (f" (card + CPU {r['s']:.1f} s)" if "s" in r else ""))
    return out


def analysis_phase(torch):
    """Phase 11: the paper's accumulation analysis on the card, each part
    held against the CPU bitwise, then a reduced deepseek-7b served under
    ``INT8_DMAC`` and fp8 ``swamp`` on the card and the CPU."""
    from repro_torch.quant import config as q
    out, secs = {}, {}
    for name, fn in (("fig3", analysis_fig3), ("fig4b", analysis_fig4b),
                     ("table3", analysis_table3), ("layer", analysis_layer)):
        t0 = time.time()
        out[name] = fn(torch)
        secs[name] = time.time() - t0
        log(f"analysis {name}: {secs[name]:.1f} s")
    t0 = time.time()
    serve_reduced_gpu_vs_cpu(torch, q.INT8_DMAC, "INT8_DMAC",
                             edit=_scale_out)
    serve_reduced_gpu_vs_cpu(torch, q.QuantConfig(dtype="fp8_e4m3",
                                                  accum="swamp"),
                             "fp8 swamp", edit=_scale_out)
    secs["serve_reduced"] = time.time() - t0
    log(f"analysis reduced serving: {secs['serve_reduced']:.1f} s")
    out["seconds"] = secs
    return out


# ---------------------------------------------------------------------------
# phase 12: training, then Table 1 / Fig. 9's traffic on the trained model
# ---------------------------------------------------------------------------

TRAIN_ARCH = "mgs-paper-eval"
MOE_TRAIN_ARCH = "granite-moe-1b-a400m"
# benchmarks/common.py::trained_tiny_lm's traffic: SyntheticLM batches of
# 8 x 64 tokens, 150 AdamW steps (lr 3e-3, 5 warm-up steps, cosine), then
# 4 held-out batches from step 10000
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, EVAL_BATCHES = 8, 64, 150, 4
FIG9_WIDTHS = (12, 14, 16, 20)
# granite-moe-1b-a400m: 3 steps of 8 x 512 tokens
MOE_BATCH, MOE_SEQ, MOE_STEPS = 8, 512, 3


def table1_modes():
    """``benchmarks/table1_accuracy.py``'s modes, ``dmac_mgs`` on B5 and
    ``mgs_exact`` on B1."""
    from repro_torch.quant import QuantConfig as Q
    return {"baseline_fp32": Q(),
            "int8": Q(dtype="int8", accum="wide"),
            "fp8_wide": Q(dtype="fp8_e4m3", accum="wide"),
            "dmac_mgs": Q(dtype="fp8_e4m3", accum="mgs_dmac",
                          use_kernel=True),
            "mgs_exact": Q(dtype="fp8_e4m3", accum="mgs_exact",
                           use_kernel=True, fused=True),
            "fp8_swamp_narrow": Q(dtype="fp8_e4m3", accum="swamp",
                                  narrow_bits=5)}


@contextlib.contextmanager
def recording_b5():
    """Collects each B5 call (through ``qmatmul`` and ``kernels.ops``) as
    (Bt, M, K, N)."""
    import importlib
    from repro_torch.kernels.mgs_matmul import mgs_matmul_dmac_codes as b5
    mods = [importlib.import_module(m) for m in (
        "repro_torch.quant.qmatmul", "repro_torch.kernels.ops")]
    seen = []

    def rec(xc, wc, *a, **kw):
        Bt, M, K = xc.shape if xc.dim() == 3 else (1, *xc.shape)
        seen.append((Bt, M, K, wc.shape[-1]))
        return b5(xc, wc, *a, **kw)
    for m in mods:
        m.mgs_matmul_dmac_codes = rec
    try:
        yield seen
    finally:
        for m in mods:
            m.mgs_matmul_dmac_codes = b5



def check_eval_b5(torch, dev, gen, shapes):
    """B5 == twin == float entry (``torch.equal``) at ``shapes``."""
    from repro_torch.core.formats import E4M3
    worst = 0.0
    for name, Bt, M, K, N, _ in shapes:
        x = _margin_values(torch, (Bt, M, K), dev, gen)
        w = _margin_values(torch, (Bt, K, N), dev, gen)
        worst = max(worst, _b5_equal(
            torch, x, w, E4M3, True, f"{name:22s} {Bt}x({M}x{K} @ {K}x{N})"))
        del x, w
    return worst


def time_b5(torch, dev, gen, shapes):
    """B5's codes entry at ``shapes`` beside its twin, torch.matmul in
    float32 over the values and its bound; weights cycle through enough
    copies to leave L2."""
    from repro_torch.core.formats import encode_bits
    from repro_torch.kernels.mgs_matmul import (mgs_matmul_dmac_codes,
                                                mgs_matmul_dmac_codes_plain)
    rows = []
    for name, Bt, M, K, N, _ in shapes:
        copies = max(1, min(8, -(-200_000_000 // (Bt * K * N))))
        x = _margin_values(torch, (Bt, M, K), dev, gen)
        ws = [_margin_values(torch, (Bt, K, N), dev, gen)
              for _ in range(copies)]
        xc, wcs = encode_bits(x), [encode_bits(w) for w in ws]
        it = iter(range(10**9))

        def nxt():
            return next(it) % copies
        ms = time_ms(torch, lambda: mgs_matmul_dmac_codes(xc, wcs[nxt()]), 20)
        plain = time_ms(torch, lambda: mgs_matmul_dmac_codes_plain(
            xc, wcs[nxt()]), 2, warmup=1)
        lib = time_ms(torch, lambda: torch.matmul(x, ws[nxt()]), 20)
        b_ms, b_by = dmac_bound(Bt, M, K, N)
        rows.append(dict(shape=name, Bt=Bt, M=M, K=K, N=N, ms=ms,
                         plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                         bound_by=b_by))
        log(f"time B5 {name:22s} {Bt}x({M}x{K} @ {K}x{N}): kernel {ms:.4f} "
            f"ms, twin {plain:.4f} ms, torch.matmul f32 {lib:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        del x, ws, xc, wcs
    return rows


def _to_dev(torch, hb, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in hb.items()}


def top1(torch, cfg, params, batches, dev):
    """Next-token top-1 accuracy of ``forward`` over ``batches`` (numpy)
    (``benchmarks/common.py::top1_accuracy``)."""
    from repro_torch.models import forward
    hits = total = 0
    with torch.no_grad():
        for hb in batches:
            b = _to_dev(torch, hb, dev)
            logits, _ = forward(params, cfg, b)
            hits += int((logits.argmax(-1) == b["labels"]).sum())
            total += b["labels"].numel()
    return hits / max(total, 1)


def score_table1(torch, cfg, params, evals, dev):
    """Table 1: top-1 under each mode over ``evals``, its delta against the
    float baseline, seconds, and each kernel's launches a forward, which
    must equal ``eval_launches``."""
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    rows, base = {}, None
    want = {"dmac_mgs": "mgs_matmul_dmac",
            "mgs_exact": "mgs_matmul_exact_fused"}
    for name, q in table1_modes().items():
        reset_launch_counts()
        t0 = time.time()
        acc = top1(torch, dataclasses.replace(cfg, quant=q), params, evals,
                   dev)
        secs = time.time() - t0
        base = acc if base is None else base
        per_fwd = {k: v // len(evals) for k, v in LAUNCHES.items() if v}
        rows[name] = dict(top1=acc, delta_vs_fp32=acc - base, seconds=secs,
                          launches_per_forward=per_fwd)
        pred = {want[name]: eval_launches(cfg)} if name in want else {}
        if per_fwd != pred or any(v % len(evals) for v in LAUNCHES.values()):
            raise AssertionError(f"table 1 {name}: launches "
                                 f"{dict(LAUNCHES)} over {len(evals)} "
                                 f"forwards, predicted {pred} each")
        log(f"table1 {name:16s} top1={acc:.4f} delta_vs_fp32="
            f"{acc - base:+.4f} ({secs:.1f} s, launches a forward "
            f"{per_fwd})")
    return rows


def score_fig9(torch, cfg, params, batch, dev):
    """Fig. 9 on one batch: int8 ``clip`` / ``wrap`` at each narrow width
    against int8 ``mgs_exact`` (exact at any width; its x coordinate the
    average accumulator bits of the integer dMAC on 16 sampled dots of
    d_model int8 pairs, seeded by the width)."""
    import numpy as np
    from repro_torch.core import int_dmac
    from repro_torch.quant import QuantConfig as Q
    rows = {"fp32_baseline": dict(top1=top1(torch, cfg, params, [batch],
                                            dev))}
    log(f"fig9 fp32_baseline top1={rows['fp32_baseline']['top1']:.4f}")
    for nb in FIG9_WIDTHS:
        for accum in ("clip", "wrap", "mgs_exact"):
            t0 = time.time()
            q = Q(dtype="int8", accum=accum, narrow_bits=nb)
            acc = top1(torch, dataclasses.replace(cfg, quant=q), params,
                       [batch], dev)
            row = dict(top1=acc, seconds=time.time() - t0)
            if accum == "mgs_exact":
                rng = np.random.default_rng(nb)
                n_narrow = n_wide = 0
                for _ in range(16):
                    w = torch.as_tensor(rng.integers(-127, 128, cfg.d_model))
                    x = torch.as_tensor(rng.integers(-127, 128, cfg.d_model))
                    _, st = int_dmac.int_dot_dmac(w, x, narrow_bits=nb)
                    n_narrow += int(st.narrow_adds)
                    n_wide += int(st.wide_flushes) + 1
                row["avg_bits"] = float(int_dmac.average_accumulator_bits(
                    n_narrow, n_wide, nb, 32))
            rows[f"{accum}/narrow{nb}b"] = row
            log(f"fig9 {accum:9s} narrow {nb}b top1={acc:.4f}"
                + (f" avg_bits={row['avg_bits']:.2f}" if "avg_bits" in row
                   else "") + f" ({row['seconds']:.1f} s)")
    return rows


def train_eval_gpu_vs_cpu(torch):
    """Reduced mgs-paper-eval (float32 compute), one numpy parameter set:
    the teacher-forced forward under ``dmac_mgs`` (B5) and ``mgs_exact``
    (B1) on the card and under their twins on the CPU give the same greedy
    token at every position, logits within the engine bar."""
    import numpy as np
    from repro_torch.configs import reduced_config
    from repro_torch.models import forward, init_params
    cfg = dataclasses.replace(reduced_config(TRAIN_ARCH),
                              compute_dtype="float32")
    params = init_params(cfg, SEED)
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (4, 32)).astype(np.int32)
    for name in ("dmac_mgs", "mgs_exact"):
        qcfg = dataclasses.replace(cfg, quant=table1_modes()[name])
        out = {}
        for dev in ("cuda", "cpu"):
            with torch.no_grad():
                logits, _ = forward(_tree_to(params, dev), qcfg,
                                    {"tokens": torch.from_numpy(tokens).to(
                                        dev)})
            out[dev] = logits.cpu().numpy()
        g, c = out["cuda"], out["cpu"]
        scale = np.abs(c).max()
        err = np.abs(g - c)
        if not np.array_equal(g.argmax(-1), c.argmax(-1)) or \
                err.max() > 5e-2 * scale or err.mean() > 1e-2 * scale:
            raise AssertionError(f"reduced {TRAIN_ARCH} {name}: GPU and CPU "
                                 f"greedy tokens or logits differ (max "
                                 f"{err.max() / scale:.3g} of scale)")
        log(f"reduced {TRAIN_ARCH} forward {name}: GPU kernels == CPU twins "
            f"greedy tokens at all {tokens.size} positions, max logit diff "
            f"{err.max():.3g}")


def train_mgs_paper_eval(torch, dev):
    """``train_loop`` on full-width mgs-paper-eval with checkpoints in a
    temporary directory; the loss must descend by more than 0.3 (mean of
    the last 5 against the first 5); the last checkpoint restores to the
    final state bitwise. Returns (cfg, params, history, step row)."""
    import io
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch.train import TrainLoopConfig, train_loop
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.train import OptConfig
    from repro_torch.tree import leaves as tree_leaves
    # no remat: the reference's trained_tiny_lm trains without it (its
    # reduced config), and 41 M parameters need none; granite-moe below
    # trains with it
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), remat="none")
    opt = OptConfig(lr=3e-3, warmup_steps=5, total_steps=TRAIN_STEPS)
    with tempfile.TemporaryDirectory() as d:
        loop = TrainLoopConfig(steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                               seq_len=TRAIN_SEQ, log_every=1,
                               ckpt_every=50, ckpt_dir=d, seed=SEED)
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            out = train_loop(cfg, loop, device=dev, opt_cfg=opt)
        secs = time.time() - t0
        step, restored, extra = ckpt.restore(d, template=out["state"])
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(restored), tree_leaves(out["state"])))
        if step != TRAIN_STEPS or not same or \
                extra["data"]["step"] != TRAIN_STEPS:
            raise AssertionError(f"checkpoint at step {step} does not "
                                 "restore the final state")
    losses = [h["loss"] for h in out["history"]]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    ms = sorted(h["ms"] for h in out["history"][1:])
    log(f"train {TRAIN_ARCH} ({cfg.n_layers} layers, d {cfg.d_model}, vocab "
        f"{cfg.vocab}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens): {TRAIN_STEPS} "
        f"steps in {secs:.1f} s, step {ms[len(ms) // 2]:.1f} ms median, loss "
        f"{first:.4f} -> {last:.4f} (first / last 5), checkpoint at step "
        f"{step} restores bitwise")
    if not last < first - 0.3:
        raise AssertionError(f"loss did not descend: {first} -> {last}")
    return cfg, out["state"]["params"], losses, dict(
        seconds=secs, step_ms_median=ms[len(ms) // 2], loss_first5=first,
        loss_last5=last)


def profile_train_step(torch, cfg, params, batch, label):
    """One step's time and device breakdown (``profile_step``) of
    ``make_train_step(cfg)`` from ``params`` and fresh AdamW moments at
    ``batch`` (every call takes the same step)."""
    from repro_torch.train import OptConfig, init_train_state, make_train_step
    state = init_train_state(params)
    step_fn = make_train_step(cfg, OptConfig())
    return profile_step(torch, lambda: step_fn(state, batch), label)


def train_moe(torch, dev):
    """granite-moe-1b-a400m at full width, ``remat="layer"``: ``MOE_STEPS``
    train steps (the last profiled) of ``MOE_BATCH`` x ``MOE_SEQ`` tokens;
    finite losses, a positive aux loss, the peak device memory."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.train import OptConfig, init_train_state, make_train_step
    from repro_torch.tree import leaves as tree_leaves
    cfg = get_config(MOE_TRAIN_ARCH)
    assert cfg.remat == "layer"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    state = init_train_state(init_params(cfg, SEED, device=dev))
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    torch.cuda.synchronize()
    init_s = time.time() - t0
    step_fn = make_train_step(cfg, OptConfig(lr=3e-4, warmup_steps=1,
                                             total_steps=MOE_STEPS))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=MOE_SEQ,
                                  global_batch=MOE_BATCH, seed=SEED))
    rows = []
    for i in range(MOE_STEPS - 1):
        batch = _to_dev(torch, data.make_batch(i), dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        rows.append(dict(step=i, ms=(time.perf_counter() - t1) * 1e3,
                         **{k: float(v) for k, v in m.items()}))
    batch = _to_dev(torch, data.make_batch(MOE_STEPS - 1), dev)
    t1 = time.time()
    prof = device_breakdown(torch, lambda: step_fn(state, batch))
    prof_s = time.time() - t1
    state, m = prof.pop("result")
    rows.append(dict(step=MOE_STEPS - 1, ms=prof["profiled_step_ms"],
                     **{k: float(v) for k, v in m.items()}))
    peak = torch.cuda.max_memory_allocated() / 2**30
    for r in rows:
        log(f"train {MOE_TRAIN_ARCH} step {r['step']}: loss {r['loss']:.4f} "
            f"aux {r['aux_loss']:.4f} grad norm {r['grad_norm']:.3f} "
            f"{r['ms']:.1f} ms")
    if not all(math.isfinite(r["loss"]) and r["aux_loss"] > 0 for r in rows):
        raise AssertionError(f"{MOE_TRAIN_ARCH}: a non-finite loss or no "
                             "aux loss")
    log(f"train {MOE_TRAIN_ARCH} ({cfg.n_layers} layers, {n_params / 1e9:.3f}"
        f" B parameters, {MOE_BATCH} x {MOE_SEQ} tokens, remat per layer): "
        f"init {init_s:.1f} s, {MOE_STEPS} steps in {time.time() - t0:.1f} s "
        f"(the profiled one {prof_s:.1f} s with the trace's summing), peak "
        f"device memory {peak:.1f} GiB; profiled step: "
        + _breakdown_text(prof))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return dict(steps=rows, peak_gib=peak, params=n_params, profile=prof)


def train_phase(torch, dev, gen):
    """Phase 12: B1 / B5 == twin at the eval forward's shapes; full-width
    mgs-paper-eval trained through ``train_loop``; Table 1 over the
    held-out batches and Fig. 9 on one, launches counted; the reduced
    model's forward on the card and the CPU; granite-moe-1b-a400m's full-
    width train steps."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.quant import clear_prepared_cache
    clear_prepared_cache()
    gc.collect()
    torch.cuda.empty_cache()
    secs = {}
    t0 = time.time()
    shapes = eval_b1_shapes(get_config(TRAIN_ARCH))
    b1_err = check_family_b1(torch, dev, gen, shapes)
    b5_err = check_eval_b5(torch, dev, gen, shapes)
    secs["kernels"] = time.time() - t0
    log(f"train kernels: B1 and B5 == twin at the eval forward's "
        f"{len(shapes)} shapes ({secs['kernels']:.1f} s)")

    t0 = time.time()
    cfg, params, losses, train = train_mgs_paper_eval(torch, dev)
    secs["train"] = time.time() - t0
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=SEED))
    evals = [data.make_batch(10_000 + i) for i in range(EVAL_BATCHES)]
    train["profile"] = profile_train_step(
        torch, cfg, params, _to_dev(torch, evals[0], dev),
        f"train step {TRAIN_ARCH} ({TRAIN_BATCH} x {TRAIN_SEQ})")

    t0 = time.time()
    mgs = dataclasses.replace(cfg, quant=table1_modes()["mgs_exact"])
    with recording_b1() as seen, recording_b5() as seen5:
        top1(torch, mgs, params, evals[:1], dev)
        top1(torch, dataclasses.replace(
            cfg, quant=table1_modes()["dmac_mgs"]), params, evals[:1], dev)
    missed = unchecked_b1(seen, shapes)
    missed5 = {c for c in seen5 if c not in {s[1:5] for s in shapes}}
    if missed or missed5:
        raise AssertionError(f"eval forward launched B1 / B5 at unchecked "
                             f"shapes: {sorted(missed, key=str)} "
                             f"{sorted(missed5)}")
    table1 = score_table1(torch, cfg, params, evals, dev)
    secs["table1"] = time.time() - t0
    t0 = time.time()
    fig9 = score_fig9(torch, cfg, params, evals[0], dev)
    secs["fig9"] = time.time() - t0
    t0 = time.time()
    train_eval_gpu_vs_cpu(torch)
    secs["gpu_vs_cpu"] = time.time() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.time()
    moe = train_moe(torch, dev)
    secs["moe"] = time.time() - t0
    b_rows = time_b1(torch, dev, gen, shapes)
    b5_rows = time_b5(torch, dev, gen, shapes)
    log("phase 12 seconds: " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in secs.items()))
    return dict(b1_err=b1_err, b5_err=b5_err, train=train, losses=losses,
                table1=table1, fig9=fig9, moe=moe, b1_shapes=b_rows,
                b5_shapes=b5_rows, seconds=secs,
                eval_launches=eval_launches(cfg))


# ---------------------------------------------------------------------------
# phase 13: the replica fleet (run after phase 8, on its live weights)
# ---------------------------------------------------------------------------


FLEET_SLOTS = 4


def card_name(torch) -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and \
        smi.stdout.strip() else f"{torch.cuda.get_device_name(0)}, n/a"


def _launches_or_raise(what, got, want):
    got = {k: v for k, v in got.items() if v or k in want}
    want = {k: want.get(k, 0) for k in got}
    log(f"fleet {what}: launches {got}, predicted {want}")
    if got != want:
        raise AssertionError(f"fleet {what}: launches {got} != predicted "
                             f"{want}")


def _fleet_run(driver, reqs):
    """``driver.run``: this run's stats (wall included) and the replicas'
    health after it; raises if a request was dropped or cut."""
    out = driver.run(reqs, timeout=600)
    if any(len(r.out_tokens) != r.max_new_tokens for r in reqs):
        raise AssertionError("the fleet dropped or cut a request")
    out["health"] = [h["state"] for h in driver.stats()["health"]]
    return out


def _group_prefill_logits(torch, eng, prompts):
    from repro_torch.models import init_cache
    import numpy as np
    toks = np.stack(prompts)
    cache = init_cache(eng.cfg, toks.shape[0], eng.max_len,
                       device=eng.device)
    with torch.no_grad():
        lg, _ = eng._prefill(toks, cache, eng._calib_state)
    return lg.float().cpu()


def fleet_group(torch, params, served, layers: int):
    """Phase 13 (a) and (b): a fleet of 2 replicas over 4 slots of the card
    serves 16 of phase 4's requests (its 8 twice: 4 groups) with slot 0
    poisoned at decode step 2 of replica 0's second group, then its 8 again
    (a group each, the rebuilt replica's included); one engine serves the
    same requests on the same weights, timed in the same run; then a fleet
    over 2 slots serves the 8 with a transient fault on replica 1 retried
    in place. Every request's tokens are held to phase 4's single engine
    (``served``), which ran the same groups."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import BUILDS, LAUNCHES, reset_launch_counts
    from repro_torch.launch.mesh import virtual_devices
    from repro_torch.launch.replica import ReplicaServeDriver
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.quant import PREP_STATS
    from repro_torch.quant.config import FP8_MGS_SERVE_KV
    from repro_torch.runtime.fault_tolerance import FaultInjector, FaultSpec
    cfg = dataclasses.replace(get_config("deepseek-7b"), n_layers=layers,
                              quant=FP8_MGS_SERVE_KV)
    n, new = len(served), served[0].max_new_tokens
    max_len = 32 + new + 1          # phase 4's engine: the same shapes

    def reqs(k):
        return [Request(rid=i, prompt=served[i % n].prompt.copy(),
                        max_new_tokens=new) for i in range(k)]

    def same(got, what):
        bad = [r.rid for r in got
               if r.out_tokens != served[r.rid % n].out_tokens]
        if bad:
            raise AssertionError(f"fleet {what}: requests {bad} differ from "
                                 "one engine's tokens")
        log(f"fleet {what}: tokens bitwise phase 4's one engine for all "
            f"{len(got)} requests")

    def check(what, run, want):
        got = {k: run[k] for k in want}
        if got != want:
            raise AssertionError(f"fleet {what}: {got} != {want}")

    prep0, builds0 = dict(PREP_STATS), dict(BUILDS)
    inj = FaultInjector([FaultSpec(kind="poison", replica=0, group=1,
                                   after_decode_steps=2, device_ids=(0,))])
    driver = ReplicaServeDriver(
        cfg, 2, batch=4, max_len=max_len, params=params, model_parallel=1,
        devices=virtual_devices("cuda:0", FLEET_SLOTS), injector=inj,
        backoff_base_s=0.001)
    try:
        driver.warmup(prompt_len=32, max_new=1)
        reset_launch_counts()
        got = reqs(2 * n)
        poisoned = _fleet_run(driver, got)
        launches = dict(LAUNCHES)
        events = driver.events()
        same(got, "poisoned slot")
        ids = driver.meshes[0].ids
        reset_launch_counts()
        got = reqs(n)
        rebuilt = _fleet_run(driver, got)
        launches_rebuilt = dict(LAUNCHES)
        same(got, "after the rebuild")
        prompts = [r.prompt for r in served[:4]]
        lg_rebuilt = _group_prefill_logits(torch, driver.engines[0], prompts)
    finally:
        driver.close(600)
    recovery = [e["recovery_s"] for e in events if e["event"] == "rebuilt"]
    log(f"fleet poisoned slot: {inj.fired()[0]}, stats {poisoned}, rebuilt "
        f"replica 0 on slots {ids}, recovery_s {recovery}; after the "
        f"rebuild: stats {rebuilt}")
    # replica 0's second group is requeued onto replica 1; then a group each
    check("poisoned slot", poisoned, dict(
        failovers=1, rebuilds=1, retries=0, requeued_requests=4,
        groups_per_replica=[1, 3], health=["healthy", "healthy"],
        decode_steps=4 * (new - 1)))
    check("after the rebuild", rebuilt, dict(
        failovers=0, rebuilds=0, retries=0, groups_per_replica=[1, 1],
        health=["healthy", "healthy"], decode_steps=2 * (new - 1)))
    if 0 in ids or len(ids) != 1:
        raise AssertionError(f"rebuilt replica on slots {ids}")

    # one engine on the same weights and requests, no fault: the walls the
    # fleet's are set against
    single = ServeEngine(cfg, batch=4, max_len=max_len, params=params)
    single.warmup([32], max_new=1)
    ref = reqs(2 * n)
    t0 = time.perf_counter()
    single.run(ref[:n])
    torch.cuda.synchronize()
    single_first = time.perf_counter() - t0
    single.run(ref[n:])
    torch.cuda.synchronize()
    single_all = time.perf_counter() - t0
    same(ref, "one engine (timed)")
    if not torch.equal(lg_rebuilt,
                       _group_prefill_logits(torch, single, prompts)):
        raise AssertionError("the rebuilt replica's prefill logits differ "
                             "from one engine's")
    log("fleet poisoned slot: the rebuilt replica's prefill logits bitwise "
        "one engine's")
    # 4 whole groups, the poisoned attempt (prefill + 1 decode step) and
    # the rebuild's warmup replay (prefill + 1 decode step); then 2 groups
    _launches_or_raise("poisoned slot", launches,
                       fleet_group_launches(cfg, new, 4, 2))
    _launches_or_raise("after the rebuild", launches_rebuilt,
                       fleet_group_launches(cfg, new, 2, 0))

    inj = FaultInjector([FaultSpec(kind="raise", replica=1, group=0,
                                   after_decode_steps=2)])
    driver = ReplicaServeDriver(
        cfg, 2, batch=4, max_len=max_len, params=params,
        devices=virtual_devices("cuda:0", 2), injector=inj,
        backoff_base_s=0.001)
    try:
        reset_launch_counts()
        got = reqs(n)
        retry = _fleet_run(driver, got)
        launches_retry = dict(LAUNCHES)
    finally:
        driver.close(600)
    same(got, "transient fault")
    log(f"fleet transient fault: {inj.fired()[0]}, stats {retry}")
    check("transient fault", retry, dict(
        retries=1, failovers=0, rebuilds=0, groups_per_replica=[1, 1],
        health=["healthy", "healthy"], decode_steps=2 * (new - 1)))
    # two whole groups and replica 1's attempt cut at decode step 2
    _launches_or_raise("transient fault", launches_retry,
                       fleet_group_launches(cfg, new, 2, 1))
    _flat_or_raise("fleet", prep0, builds0)
    return {"poisoned": poisoned, "recovery_s": recovery,
            "rebuilt_slots": ids, "rebuilt": rebuilt, "retry": retry,
            "single_wall_s": {"requests_16": single_all,
                              "requests_8": single_first},
            "launches": {"fleet_poisoned": launches,
                         "fleet_rebuilt": launches_rebuilt,
                         "fleet_retry": launches_retry}}


def fleet_calibration(torch, params, layers: int):
    """Phase 13 (c): ``calibrate()`` once, a no-drain push of a second table
    while traffic flows, slot 0 poisoned at replica 0's second group; the
    rebuilt replica holds the donor's versions, and a v1 request replays
    on it with the donor's bits."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import BUILDS, LAUNCHES, reset_launch_counts
    from repro_torch.launch.mesh import virtual_devices
    from repro_torch.launch.replica import ReplicaServeDriver
    from repro_torch.launch.serve import Request
    from repro_torch.quant import PREP_STATS
    from repro_torch.quant.config import FP8_MGS_SERVE_KV
    from repro_torch.runtime.fault_tolerance import FaultInjector, FaultSpec
    import numpy as np
    cfg = dataclasses.replace(
        get_config("deepseek-7b"), n_layers=layers,
        quant=FP8_MGS_SERVE_KV.replace(flush_target=1e-6))
    new = 4
    rng = np.random.default_rng(SEED + 8)

    def reqs(rid0, n):
        return [Request(rid=rid0 + i, prompt=rng.integers(
            1, cfg.vocab, 32).astype(np.int32), max_new_tokens=new)
            for i in range(n)]

    prep0, builds0 = dict(PREP_STATS), dict(BUILDS)
    inj = FaultInjector([FaultSpec(kind="poison", replica=0, group=1,
                                   device_ids=(0,))])
    driver = ReplicaServeDriver(
        cfg, 2, batch=4, max_len=32 + new + 1, params=params,
        model_parallel=1, devices=virtual_devices("cuda:0", FLEET_SLOTS),
        injector=inj, backoff_base_s=0.001)
    try:
        t0 = time.perf_counter()
        t1 = driver.calibrate()
        calib_s = time.perf_counter() - t0
        reset_launch_counts()
        first = reqs(0, 4)          # replica 0's first group, on v1
        run1 = _fleet_run(driver, first)
        second = reqs(10, 8)        # replica 1's first, replica 0's second
        base = driver.stats()
        futs = driver.submit_many(second[:4])
        v2 = driver.apply_calibration(
            t1.refreshed([(s, v * 1.5) for s, v in t1.to_pairs()]))
        futs += driver.submit_many(second[4:])
        driver.drain(600)
        for f in futs:
            f.result(600)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        st = driver.stats()
        engines = list(driver.engines)
        tables = [{v: t.to_pairs() for v, t in e._tables.items()}
                  for e in engines]
        versions = [e.table_version for e in engines]
        rep0, st0 = engines[0].replay(first[0], group=first[:4])
        rep1, st1 = engines[1].replay(first[0], group=first[:4])
    finally:
        driver.close(600)
    stamps = [r.table_version for r in first + second]
    log(f"fleet calibration: calibrate() {calib_s:.3f} s -> v1 on both "
        f"replicas, push of v{v2} under traffic, stamps {stamps}; "
        f"failovers {st['failovers'] - base['failovers']}, rebuilds "
        f"{st['rebuilds'] - base['rebuilds']}; versions {versions}, tables "
        f"{[sorted(t) for t in tables]}")
    if (st["failovers"], st["rebuilds"]) != (1, 1) or versions != [2, 2] \
            or sorted(tables[0]) != [1, 2] or tables[0] != tables[1] \
            or set(stamps[:4]) != {1} or not set(stamps[4:]) <= {1, 2}:
        raise AssertionError("fleet calibration: the rebuilt replica does "
                             "not hold its donor's tables")
    same_logits = all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
                      for a, b in zip(st0["logits"][first[0].rid],
                                      st1["logits"][first[0].rid]))
    if rep0.out_tokens != first[0].out_tokens or \
            rep1.out_tokens != first[0].out_tokens or not same_logits:
        raise AssertionError("fleet calibration: replay of a v1 request on "
                             "the rebuilt replica is not the donor's bits")
    log(f"fleet calibration: request {first[0].rid} (v1) replayed on the "
        "rebuilt replica: tokens as served, logits bitwise the donor's")
    # 3 whole groups of 4 tokens; the poison fires at group start
    _launches_or_raise("calibration", launches,
                       fleet_group_launches(cfg, new, 3, 0))
    _flat_or_raise("fleet calibration", prep0, builds0)
    return {"calibrate_s": calib_s, "first_run": run1, "stamps": stamps,
            "versions": versions, "launches": launches}


def fleet_continuous(torch, params, run_a, layers: int):
    """Phase 13 (d): 2 continuous replicas over 2 slots serve phase 6's
    ragged traffic (its prompts, arrival times and 16 new tokens); tokens
    bitwise phase 6's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import BUILDS, LAUNCHES, reset_launch_counts
    from repro_torch.launch.mesh import virtual_devices
    from repro_torch.launch.replica import ReplicaServeDriver
    from repro_torch.launch.serve import Request
    from repro_torch.quant import PREP_STATS
    from repro_torch.quant.config import FP8_MGS_SERVE_PAGED
    cfg = dataclasses.replace(
        get_config("deepseek-7b"), n_layers=layers,
        quant=FP8_MGS_SERVE_PAGED.replace(schedule="activation"))
    ref, arrivals = run_a["requests"], run_a["arrivals"]
    prep0, builds0 = dict(PREP_STATS), dict(BUILDS)
    got = [Request(rid=r.rid, prompt=r.prompt.copy(),
                   max_new_tokens=r.max_new_tokens) for r in ref]
    slots = 4
    driver = ReplicaServeDriver(cfg, 2, batch=slots, max_len=256,
                                params=params, continuous=True,
                                devices=virtual_devices("cuda:0", 2))
    try:
        driver.warmup(plen_buckets=[64, 128, 192])
        reset_launch_counts()
        t0 = time.perf_counter()
        futs = []
        for r, at in zip(got, arrivals):
            time.sleep(max(0.0, at - (time.perf_counter() - t0)))
            futs.append(driver.submit(r))
        driver.drain(600)
        for f in futs:
            f.result(600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        st = driver.stats()         # this run's: the warmup is not counted
    finally:
        driver.close(600)
    bad = [r.rid for r, w in zip(got, ref) if r.out_tokens != w.out_tokens]
    if bad:
        raise AssertionError(f"continuous fleet: requests {bad} differ from "
                             "phase 6's")
    log(f"fleet continuous: {len(got)} ragged requests over 2 replicas in "
        f"{wall:.2f} s (busy {st['busy_s']:.2f} s, groups per replica "
        f"{st['groups_per_replica']}, {st['decode_steps']} decode steps); "
        f"tokens bitwise phase 6's for all {len(got)}")
    # the step count depends on scheduling (which replica takes a request,
    # who shares its steps), so it is the engines' own count, held inside
    # what the traffic allows: each request takes max_new - 1 steps on its
    # replica, at most `slots` of them a step
    steps = st["decode_steps"]
    need = [r.max_new_tokens - 1 for r in got]
    lo, hi = max(max(need), -(-sum(need) // slots)), sum(need)
    if not lo <= steps <= hi:
        raise AssertionError(f"continuous fleet: {steps} decode steps, "
                             f"outside [{lo}, {hi}]")
    # a request's prefill launches depend on its bucket only, so they are
    # phase 6's (all its B1, its B3 less 7L + 1 a decode step); every decode
    # step launches 7L + 1 B3 and L B2
    L, ref_l = layers, run_a["launches"]
    b3 = "mgs_matmul_exact_fused_stationary"
    want = {"mgs_matmul_exact_fused": ref_l["mgs_matmul_exact_fused"],
            b3: ref_l[b3] + (steps - run_a["steps"]) * (7 * L + 1),
            "mgs_flash_attention": steps * L}
    _launches_or_raise(f"continuous ({steps} decode steps, traffic bounds "
                       f"[{lo}, {hi}])", launches, want)
    _flat_or_raise("continuous fleet", prep0, builds0)
    return {"wall_s": wall, "busy_s": st["busy_s"], "steps": steps,
            "step_bounds": [lo, hi],
            "groups_per_replica": st["groups_per_replica"],
            "launches": launches}


def fleet_phase(torch, group_params, group_reqs, cont_params, run_a,
                layers: int):
    """Phase 13: the replica fleet on the card, on phase 4's and phase 6's
    prepared weights (nothing prepared again) and their traffic."""
    t = {}
    t0 = time.time()
    group = fleet_group(torch, group_params, group_reqs, layers)
    t["group"] = time.time() - t0
    t0 = time.time()
    calib = fleet_calibration(torch, group_params, layers)
    t["calibration"] = time.time() - t0
    t0 = time.time()
    cont = fleet_continuous(torch, cont_params, run_a, layers)
    t["continuous"] = time.time() - t0
    # each fleet wall beside one engine's on the same requests and weights,
    # timed in this run (phase 6's (a) run is the continuous one's)
    one = group["single_wall_s"]
    for what, run, single in (
            ("poisoned slot (16 requests, a failover and a rebuild)",
             group["poisoned"], one["requests_16"]),
            ("after the rebuild (8 requests)", group["rebuilt"],
             one["requests_8"]),
            ("transient fault (8 requests, a retry)", group["retry"],
             one["requests_8"]),
            ("continuous (phase 6's traffic)", cont, run_a["wall_s"])):
        log(f"fleet {what}: wall {run['wall_s']:.2f} s against one "
            f"engine's {single:.2f} s (ratio {run['wall_s'] / single:.2f}); "
            f"busy_s {run['busy_s']:.2f} s (busy_s / wall "
            f"{run['busy_s'] / run['wall_s']:.2f}), groups per replica "
            f"{run['groups_per_replica']}")
    log(f"fleet: card {card_name(torch)}; phase 13 seconds "
        + ", ".join(f"{k} {v:.1f}" for k, v in t.items()))
    launches = {**group.pop("launches"),
                "fleet_calibration": calib.pop("launches"),
                "fleet_continuous": cont.pop("launches")}
    return {"group": group, "calibration": calib, "continuous": cont,
            "seconds": t, "launches": launches}


# ---------------------------------------------------------------------------
# phase 14: sharded serving on a (data, model) mesh of ranks
# ---------------------------------------------------------------------------

# (name, Bt, M, K, N, the cuts of K into 2 and 3 pieces; offsets not
# multiples of block_k)
SHARD_CUTS = [
    ("decode wd", 1, 4, 11008, 4096, ((0, 5000), (0, 3001, 7777))),
    ("prefill wg/wu", 1, 128, 4096, 11008, ((0, 2000), (0, 1111, 2900))),
]
# the flush periods the partials are checked at: 1, 4, the Markov plan at
# phase 8's 1e-6 target, and the engine's (no target: the worst case)
SHARD_MESH = (1, 2)


def shard_periods():
    from repro_torch.core.markov import plan_flush_period
    return (1, 4, plan_flush_period(128, target_overflow=1e-6), None)


def check_partials(torch, dev, gen):
    """B1's partials entry over each cut of K, the pieces' partials summed
    as int32 and the flush entry == one B1 call == the twin (on the card's
    tensors), with a per-column scale and the silu epilogue, at every
    period of ``shard_periods``. Returns the largest error (0.0)."""
    from repro_torch.core.formats import E4M3
    from repro_torch.kernels.mgs_matmul import (
        mgs_matmul_exact_flush, mgs_matmul_exact_fused,
        mgs_matmul_exact_partials)
    worst = 0.0
    for name, Bt, M, K, N, cuts in SHARD_CUTS:
        x = fp8_codes(torch, (Bt, M, K), dev, gen)
        w = fp8_codes(torch, (Bt, K, N), dev, gen)
        sc = torch.rand((Bt, 1, N), generator=gen, device=dev) * 1e-3
        for fp in shard_periods():
            kw = dict(block_k=128, flush_period=fp)
            one = mgs_matmul_exact_fused(x, w, E4M3, scale=sc,
                                         activation="silu", **kw)
            twin = b1_twin(torch, x, w, E4M3, scale=sc, activation="silu",
                           **kw)
            for cut in cuts:
                edges = list(cut) + [K]
                part = sum(mgs_matmul_exact_partials(
                    x[..., a:b].contiguous(), w[:, a:b].contiguous(), E4M3,
                    k_offset=a, k_total=K, **kw)
                    for a, b in zip(edges[:-1], edges[1:]))
                got = mgs_matmul_exact_flush(part, E4M3, scale=sc,
                                             activation="silu")
                torch.cuda.synchronize()
                err = (got - one).abs().max().item()
                worst = max(worst, err)
                ok = torch.equal(got, one) and torch.equal(one, twin)
                log(f"B1 partials {name} {Bt}x({M}x{K} @ {K}x{N}) cut at "
                    f"{edges[1:-1]}, flush_period={fp}: {part.shape[0]} "
                    f"segments, == B1 == twin {ok}")
                if not ok:
                    raise AssertionError(f"B1 partials + flush at {name}, "
                                         f"cut {edges}, fp {fp} != B1")
        del x, w
    return worst


# B3's partials: (name, Bt, M, K, N, cuts of K into 2 and 3 pieces); 16 rows
# are the spec_k=4 verify's 4 slots x 4 tokens; the short K's pieces admit
# the weight-stationary stripe (3 x Kp x 64 bytes), the long ones do not
STAT_CUTS = [
    ("decode wd", 1, 4, 11008, 4096, ((0, 5000), (0, 3001, 7777))),
    ("verify wd", 1, 16, 11008, 4096, ((0, 5000), (0, 3001, 7777))),
    ("short K", 1, 16, 1000, 4096, ((0, 450), (0, 333, 777))),
]


def check_stationary_partials(torch, dev, gen):
    """B3's partials entry over each cut of ``STAT_CUTS``, in both
    stationary schedules: each piece runs B3's partials where the stripe
    of its cut is admitted (``kernels.ops._fused_schedule``), else B1's;
    the pieces' int32 partials summed and flushed == one call under the
    same schedule (B3, or B1 where the whole K's stripe is refused) == the
    twin, with a per-column scale and the silu epilogue, at every period
    of ``shard_periods``. Returns the largest error (0.0) and the pieces
    B3's partials ran, by schedule (each must be > 0)."""
    from repro_torch.core.formats import E4M3
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.mgs_matmul import (
        mgs_matmul_exact_flush, mgs_matmul_exact_fused,
        mgs_matmul_exact_partials)
    from repro_torch.kernels.ops import _fused_schedule
    worst, ran = 0.0, {"activation": 0, "weight": 0}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the fallbacks' notices
        for name, Bt, M, K, N, cuts in STAT_CUTS:
            x = fp8_codes(torch, (Bt, M, K), dev, gen)
            w = fp8_codes(torch, (Bt, K, N), dev, gen)
            sc = torch.rand((Bt, 1, N), generator=gen, device=dev) * 1e-3
            for fp in shard_periods():
                kw = dict(block_k=128, flush_period=fp)
                twin = b1_twin(torch, x, w, E4M3, scale=sc,
                               activation="silu", **kw)
                for sched in ran:
                    whole = _fused_schedule(sched, M, K, 128)
                    one = mgs_matmul_exact_fused(
                        x, w, E4M3, scale=sc, activation="silu",
                        schedule=whole, **kw)
                    for cut in cuts:
                        edges = list(cut) + [K]
                        n0 = LAUNCHES["mgs_matmul_stationary_partials"]
                        part = sum(mgs_matmul_exact_partials(
                            x[..., a:b].contiguous(),
                            w[:, a:b].contiguous(), E4M3, k_offset=a,
                            k_total=K,
                            schedule=_fused_schedule(sched, M, b - a, 128),
                            **kw) for a, b in zip(edges[:-1], edges[1:]))
                        n = LAUNCHES["mgs_matmul_stationary_partials"] - n0
                        ran[sched] += n
                        got = mgs_matmul_exact_flush(part, E4M3, scale=sc,
                                                     activation="silu")
                        torch.cuda.synchronize()
                        worst = max(worst, (got - one).abs().max().item())
                        ok = torch.equal(got, one) and torch.equal(one,
                                                                   twin)
                        log(f"B3 partials {sched} {name} {Bt}x({M}x{K} @ "
                            f"{K}x{N}) cut at {edges[1:-1]}, flush_period="
                            f"{fp}: {n} of {len(edges) - 1} pieces on B3's "
                            f"partials, == one call ({whole}) == twin {ok}")
                        if not ok:
                            raise AssertionError(
                                f"B3 partials {sched} at {name}, cut "
                                f"{edges}, fp {fp} != one call")
            del x, w
    if not all(ran.values()):
        raise AssertionError(f"B3's partials did not run in every schedule: "
                             f"{ran}")
    return worst, ran


def time_partials(torch, dev, gen):
    """B1's two entries and B3's partials (activation-stationary) at decode
    wd, rank 0's cut of a 1x2 mesh (the first half of K), beside B1's one
    call over the whole K, the twins, the bound and a PyTorch yardstick
    (the f32 product of the cut)."""
    from repro_torch.core.formats import E4M3, decode_bits
    from repro_torch.kernels.mgs_matmul import (
        mgs_matmul_exact_flush, mgs_matmul_exact_flush_plain,
        mgs_matmul_exact_fused, mgs_matmul_exact_partials,
        mgs_matmul_exact_partials_plain)
    Bt, M, K, N = 1, 4, 11008, 4096
    Kl = K // 2
    copies = 8
    xs = fp8_codes(torch, (Bt, M, K), dev, gen)
    ws = [fp8_codes(torch, (Bt, K, N), dev, gen) for _ in range(copies)]
    wl = [w[:, :Kl].contiguous() for w in ws]
    xl = xs[..., :Kl].contiguous()
    sc = torch.full((Bt, 1, 1), 1e-4, device=dev)
    it = iter(range(10**9))
    part = mgs_matmul_exact_partials(xl, wl[0], E4M3, k_total=K)
    nseg = part.shape[0]

    def partials():
        mgs_matmul_exact_partials(xl, wl[next(it) % copies], E4M3,
                                  k_total=K)

    def stationary():
        mgs_matmul_exact_partials(xl, wl[next(it) % copies], E4M3,
                                  k_total=K, schedule="activation")

    def flush():
        mgs_matmul_exact_flush(part, E4M3, scale=sc)

    def one():
        mgs_matmul_exact_fused(xs, ws[next(it) % copies], E4M3, scale=sc)
    xv = decode_bits(xl, E4M3)
    wv = [decode_bits(w, E4M3) for w in wl]

    def lib():
        torch.matmul(xv, wv[next(it) % copies])
    row = dict(shape="decode wd, half K", Bt=Bt, M=M, K=K, K_cut=Kl, N=N,
               segments=nseg)
    row["partials_ms"] = time_ms(torch, partials, 20)
    row["stationary_ms"] = time_ms(torch, stationary, 20)
    row["stationary_plain_ms"] = time_ms(
        torch, lambda: mgs_matmul_exact_partials_plain(
            xl, wl[0], E4M3, k_total=K, schedule="activation"), 3, warmup=1)
    row["flush_ms"] = time_ms(torch, flush, 20)
    row["b1_ms"] = time_ms(torch, one, 20)
    row["partials_plain_ms"] = time_ms(
        torch, lambda: mgs_matmul_exact_partials_plain(
            xl, wl[0], E4M3, k_total=K), 3, warmup=1)
    row["flush_plain_ms"] = time_ms(
        torch, lambda: mgs_matmul_exact_flush_plain(part, E4M3, scale=sc), 5,
        warmup=1)
    row["library_ms"] = time_ms(torch, lib, 20)
    row["partials_bound_ms"], row["partials_bound_by"] = b1_partials_bound(
        Bt, M, Kl, N, nseg)
    row["flush_bound_ms"], row["flush_bound_by"] = b1_flush_bound(
        Bt, M, N, nseg, sc.numel())
    log(f"time B1 partials decode wd {M}x({Kl} of {K}) @ {Kl}x{N}: "
        f"{row['partials_ms']:.4f} ms (twin {row['partials_plain_ms']:.3f}, "
        f"torch.matmul f32 {row['library_ms']:.4f}, bound "
        f"{row['partials_bound_ms']:.4f} {row['partials_bound_by']}); flush "
        f"{nseg} segment(s) -> {M}x{N}: {row['flush_ms']:.4f} ms (twin "
        f"{row['flush_plain_ms']:.3f}, bound {row['flush_bound_ms']:.5f} "
        f"{row['flush_bound_by']}); B1's one call over all K "
        f"{row['b1_ms']:.4f} ms")
    log(f"time B3 partials (activation-stationary), the same cut: "
        f"{row['stationary_ms']:.4f} ms (B1's partials "
        f"{row['partials_ms']:.4f}, twin {row['stationary_plain_ms']:.3f}, "
        f"torch.matmul f32 {row['library_ms']:.4f}, bound "
        f"{row['partials_bound_ms']:.4f} {row['partials_bound_by']})")
    return row


def check_b2_heads(torch, dev, gen):
    """B2 over 128 slices in one launch == the same slices in two launches
    of 64 (tensor parallelism launches each rank's heads alone): its key
    split does not follow the slice count."""
    from repro_torch.core.formats import E4M3
    from repro_torch.kernels import mgs_attention as ma
    a = b2_inputs(torch, dev, gen)
    args = [a[k] for k in ("q_codes", "k_pool", "v_pool", "bt", "live",
                           "qk_scale", "v_scale", "bias")]
    whole = ma.mgs_flash_blocks(*args, E4M3)
    half = a["q_codes"].shape[0] // 2
    per = [ma.mgs_flash_blocks(*[t if i in (1, 2) else t[s]
                                 for i, t in enumerate(args)], E4M3)
           for s in (slice(0, half), slice(half, None))]
    if not torch.equal(whole, torch.cat(per)):
        raise AssertionError("B2 over half the slices != B2 over all")
    log(f"B2: {2 * half} slices in one launch == two launches of {half}")


def _continuous_rank(mesh, layers: int, traffic, record: bool):
    """Phase 14's continuous half on one rank: phase 6's engine, weights
    and traffic (prompts, arrival offsets, 16 new tokens) on this rank's
    slice, sequential, then ``spec_k=4`` with 8 draft layers (on the first
    engine's prepared weights) over the requests ``SPEC_RIDS``, their
    arrivals moved up by the first one's; each run counted; then a decode
    step and a speculative round alone over four admitted slots,
    counted."""
    import numpy as np
    import torch
    from repro_torch.kernels import BUILDS, LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import (ContinuousBatchingEngine, Request,
                                          bucket_for)
    from repro_torch.parallel.comm import (COMM_STATS, rank_device,
                                           reset_comm_stats)
    from repro_torch.quant import PREP_STATS
    cfg = continuous_cfg(layers)
    dev = rank_device()
    params, eng, out = continuous_params(cfg, dev), None, {}
    for key, spec_k in (("seq", None), ("spec", 4)):
        q = cfg.quant.replace(draft_layers=8) if spec_k else cfg.quant
        t0 = time.time()
        eng = ContinuousBatchingEngine(
            dataclasses.replace(cfg, quant=q), slots=CONT_SLOTS,
            max_len=CONT_MAX_LEN, params=params if eng is None
            else eng.params, device=dev, mesh=mesh, spec_k=spec_k)
        params = None
        eng.warmup(CONT_BUCKETS)
        torch.cuda.synchronize()
        ready_s = time.time() - t0
        rids = SPEC_RIDS if spec_k else range(len(traffic["prompts"]))
        reqs = [Request(rid=i, prompt=np.asarray(traffic["prompts"][i],
                                                 np.int32).copy(),
                        max_new_tokens=16) for i in rids]
        arrivals = [traffic["arrivals"][i] - traffic["arrivals"][rids[0]]
                    for i in rids]
        prep0, builds0 = dict(PREP_STATS), dict(BUILDS)
        reset_launch_counts()
        reset_comm_stats()
        st = eng.serve(reqs, arrivals=arrivals, record_logits=record)
        torch.cuda.synchronize()
        run_l, run_c = dict(LAUNCHES), dict(COMM_STATS)
        flat = dict(PREP_STATS) == prep0 and dict(BUILDS) == builds0
        cur = four_slots(eng)
        torch.cuda.synchronize()
        reset_launch_counts()
        reset_comm_stats()
        if spec_k:
            eng._spec_round(cur)
        else:
            eng._decode_paged(cur)
        torch.cuda.synchronize()
        logits = st.pop("logits", None)
        st.pop("step_s")
        res = dict(stats=st, run_launches=run_l, run_comm=run_c,
                   step_launches=dict(LAUNCHES), step_comm=dict(COMM_STATS),
                   tokens=[r.out_tokens for r in reqs], flat=flat,
                   ready_s=ready_s, buckets=[
                       bucket_for(len(r.prompt), eng._buckets,
                                  block=eng.block_size) for r in reqs])
        if record and mesh.rank == 0:
            res["logits"] = {k: np.stack(v) for k, v in logits.items()}
        out[key] = res
    return out


def _sharded_rank(rank: int, arch: str, layers: int, prompts, record: bool,
                  traffic=None):
    """One rank of phase 14: ``arch`` at full width (``layers`` deep) on
    the world's ``1 x world`` serve mesh, phase 4's traffic, counted."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import BUILDS, LAUNCHES, reset_launch_counts
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.parallel.comm import (COMM_STATS, rank_device,
                                           reset_comm_stats)
    from repro_torch.quant import PREP_STATS
    from repro_torch.quant.config import FP8_MGS_SERVE_KV
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers, quant=FP8_MGS_SERVE_KV)
    mesh = make_serve_mesh()
    t0 = time.time()
    eng = ServeEngine(cfg, batch=4, max_len=cfg.vision_prefix + 32 + 16 + 1,
                      seed=SEED, device=rank_device(), mesh=mesh)
    torch.cuda.synchronize()
    prep_s, prep_comm = time.time() - t0, dict(COMM_STATS)
    eng.warmup([32], max_new=1)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(prompts)]
    prep0, builds0 = dict(PREP_STATS), dict(BUILDS)
    reset_launch_counts()
    reset_comm_stats()
    stats = eng.run(reqs, record_logits=record)
    run_launches, run_comm = dict(LAUNCHES), dict(COMM_STATS)
    logits = stats.pop("logits", None)
    flat = dict(PREP_STATS) == prep0 and dict(BUILDS) == builds0
    # one decode step alone, counted
    toks = np.stack([np.asarray(p, np.int64) for p in prompts[:4]])
    cache = eng._init_cache(4)
    lg, cache = eng._prefill(toks, cache, eng._calib_state)
    torch.cuda.synchronize()
    reset_launch_counts()
    reset_comm_stats()
    eng._decode(lg.argmax(dim=-1)[:, None], cache, eng._calib_state)
    torch.cuda.synchronize()
    out = dict(stats=stats, run_launches=run_launches, run_comm=run_comm,
               step_launches=dict(LAUNCHES), step_comm=dict(COMM_STATS),
               tokens=[r.out_tokens for r in reqs], flat=flat,
               prep_s=prep_s, prep_comm=prep_comm, coord=mesh.coord,
               backend=mesh.backend, staged=mesh.staged,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if record and rank == 0:
        out["logits"] = {k: np.stack(v) for k, v in logits.items()}
    if traffic is not None:
        del eng, cache, lg
        torch.cuda.empty_cache()
        out["continuous"] = _continuous_rank(mesh, layers, traffic, record)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def _nonzero(d: dict) -> dict:
    return {k: v for k, v in d.items() if v}


def serve_sharded(torch, arch: str, layers: int, prompts, want_tokens,
                  want_logits=None, cont=None) -> dict:
    """``arch`` served on a ``SHARD_MESH`` of ranks sharing the card over
    gloo: tokens (and, given, every logits row) bitwise the one-card
    engine's, launches and collectives == ``sharded_prediction``, every
    entry of the path launched, ``PREP_STATS`` and the builds flat. With
    ``cont`` (phase 6's run (a): requests, arrivals, logits, launches,
    steps) the same ranks then serve phase 6's traffic on the continuous
    engine (``check_continuous_sharded``)."""
    from repro_torch.configs import get_config
    from repro_torch.parallel.comm import launch
    import numpy as np
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    world = SHARD_MESH[0] * SHARD_MESH[1]
    want = sharded_prediction(cfg, model=SHARD_MESH[1])
    traffic = None if cont is None else {
        "prompts": [r.prompt for r in cont["requests"]],
        "arrivals": list(cont["arrivals"])}
    t0 = time.time()
    res = launch(_sharded_rank, world,
                 args=(arch, layers, list(prompts), want_logits is not None,
                       traffic),
                 device="cuda", share_device=True, timeout=900.0)
    wall = time.time() - t0
    r0 = res[0]
    for r, out in enumerate(res):
        if out["tokens"] != want_tokens:
            raise AssertionError(f"{arch} on {SHARD_MESH}: rank {r} tokens "
                                 "differ from the one-card engine's")
        if not out["flat"]:
            raise AssertionError(f"{arch}: rank {r} prepared or built "
                                 "while serving")
        for key in ("run", "step"):
            got_k = _nonzero(out[f"{key}_launches"])
            got_c = {k: out[f"{key}_comm"][k] for k in want[f"{key}_comm"]}
            if got_k != _nonzero(want[f"{key}_launches"]) or \
                    got_c != want[f"{key}_comm"]:
                raise AssertionError(
                    f"{arch} rank {r} {key}: launches {got_k} collectives "
                    f"{got_c} != predicted {want[f'{key}_launches']} "
                    f"{want[f'{key}_comm']}")
    if want_logits is not None:
        same = all(np.array_equal(r0["logits"][i], want_logits[i])
                   for i in range(len(prompts)))
        if not same:
            raise AssertionError(f"{arch} on {SHARD_MESH}: logits differ "
                                 "from the one-card engine's")
    used = [k for k, v in want["run_launches"].items() if v]
    if any(r0["run_launches"].get(k, 0) == 0 for k in used):
        raise AssertionError(f"{arch}: a kernel of the path never launched")
    log(f"sharded {arch} ({layers} layers) on a {SHARD_MESH[0]}x"
        f"{SHARD_MESH[1]} mesh, {world} ranks on one card over "
        f"{r0['backend']} (staged through the host: {r0['staged']}): tokens "
        "bitwise the one-card engine's"
        + (", every logits row bitwise" if want_logits is not None else ""))
    log(f"sharded {arch}: per rank, run launches "
        f"{_nonzero(r0['run_launches'])}, decode step "
        f"{_nonzero(r0['step_launches'])}, == prediction")
    log(f"sharded {arch}: per rank, run collectives {r0['run_comm']}, decode "
        f"step {r0['step_comm']}, == prediction")
    log(f"sharded {arch}: serve wall {r0['stats']['wall_s']:.2f} s, "
        f"preparation {r0['prep_s']:.1f} s ({r0['prep_comm']['calls']} "
        f"collectives), launch + join {wall:.1f} s, peak device memory "
        f"{max(o['peak_gib'] for o in res):.1f} GiB a rank")
    out = dict(arch=arch, layers=layers, mesh=list(SHARD_MESH),
               stats=r0["stats"], run_launches=_nonzero(r0["run_launches"]),
               step_launches=_nonzero(r0["step_launches"]),
               run_comm=r0["run_comm"], step_comm=r0["step_comm"],
               prediction=want, prep_s=r0["prep_s"], wall_s=wall,
               peak_gib=max(o["peak_gib"] for o in res))
    if cont is not None:
        out["continuous"] = check_continuous_sharded(
            [o["continuous"] for o in res], cont, layers)
    return out


def check_continuous_sharded(ranks, cont, layers: int) -> dict:
    """Phase 14's continuous runs against phase 6's run (a): every rank's
    tokens, sequential (every request) and ``spec_k=4`` (``SPEC_RIDS``),
    == (a)'s; rank 0's every logits row bitwise (a)'s; the ranks'
    scheduling rounds and admissions alike; launches and collectives of a
    decode step, a speculative round and each run ==
    ``continuous_sharded_prediction`` (the sequential run's prefills from
    (a), the speculative run's from phase 6's requests served alone, the
    one of each request's bucket); every kernel of the path launched;
    ``PREP_STATS`` and the builds flat."""
    import numpy as np
    cfg = continuous_cfg(layers)
    alone = cont["alone"]
    summary = {}
    for key, spec_k in (("seq", 0), ("spec", 4)):
        r0 = ranks[0][key]
        what = f"sharded continuous ({key})"
        reqs = [cont["requests"][i] for i in SPEC_RIDS] if spec_k \
            else cont["requests"]
        want_tokens = [r.out_tokens for r in reqs]
        if spec_k:
            # each request's prefill: that of the run alone in its bucket
            if not set(r0["buckets"]) <= set(alone):
                raise AssertionError(f"{what}: buckets {r0['buckets']}, "
                                     f"runs alone in {sorted(alone)}")
            runs = [alone[b] for b in r0["buckets"]]
            ref_l = {k: sum(x["launches"][k] for x in runs)
                     for k in runs[0]["launches"]}
            ref_steps = sum(x["steps"] for x in runs)
        else:
            ref_l, ref_steps = cont["launches"], cont["steps"]
        for r, out in enumerate(ranks):
            o = out[key]
            if o["tokens"] != want_tokens:
                raise AssertionError(f"{what}: rank {r} tokens differ from "
                                     "phase 6's")
            if not o["flat"]:
                raise AssertionError(f"{what}: rank {r} prepared or built "
                                     "while serving")
            if (o["stats"]["rounds"], o["stats"]["admit_rounds"]) != (
                    r0["stats"]["rounds"], r0["stats"]["admit_rounds"]):
                raise AssertionError(f"{what}: the ranks scheduled apart")
        same = set(r0["logits"]) == {r.rid for r in reqs} and all(
            np.array_equal(r0["logits"][r.rid],
                           np.stack(cont["logits"][r.rid])) for r in reqs)
        if not same:
            raise AssertionError(f"{what}: logits differ from phase 6's")
        q = cfg.quant.replace(draft_layers=8) if spec_k else cfg.quant
        want = continuous_sharded_prediction(
            dataclasses.replace(cfg, quant=q), ref_l, ref_steps,
            r0["buckets"], r0["stats"]["steps"],
            r0["stats"]["rounds"], model=SHARD_MESH[1], spec_k=spec_k)
        for r, out in enumerate(ranks):
            o = out[key]
            for part in ("run", "step"):
                got_k = _nonzero(o[f"{part}_launches"])
                got_c = {k: o[f"{part}_comm"][k]
                         for k in want[f"{part}_comm"]}
                if got_k != _nonzero(want[f"{part}_launches"]) or \
                        got_c != want[f"{part}_comm"]:
                    raise AssertionError(
                        f"{what} rank {r} {part}: launches {got_k} "
                        f"collectives {got_c} != predicted "
                        f"{_nonzero(want[f'{part}_launches'])} "
                        f"{want[f'{part}_comm']}")
        missing = [k for k in ("mgs_matmul_exact_fused",
                               "mgs_matmul_exact_fused_stationary",
                               "mgs_matmul_exact_partials",
                               "mgs_matmul_stationary_partials",
                               "mgs_matmul_exact_flush", "mgs_flash_attention")
                   if r0["run_launches"][k] == 0]
        if missing:
            raise AssertionError(f"{what}: {missing} never launched")
        st = r0["stats"]
        step = "round" if spec_k else "decode step"
        log(f"{what}: tokens of {len(want_tokens)} requests on every rank "
            f"and rank 0's {sum(len(t) for t in want_tokens)} logits rows "
            f"bitwise phase 6's (a); {st['steps']} {step}s, {st['rounds']} "
            "scheduling rounds (one agreement each), mid-flight admissions "
            f"{st['mid_flight_admissions']}"
            + (f", acceptance {st['spec']['acceptance_rate']:.3f}"
               if spec_k else ""))
        log(f"{what}: per rank, run launches {_nonzero(r0['run_launches'])}, "
            f"a {step} {_nonzero(r0['step_launches'])}, == prediction")
        log(f"{what}: per rank, run collectives {r0['run_comm']}, a {step} "
            f"{r0['step_comm']}, == prediction")
        log(f"{what}: serve wall {st['wall_s']:.2f} s, decode tokens/s "
            f"{st['decode_tok_per_s']:.2f}, engine + warmup "
            f"{r0['ready_s']:.1f} s")
        summary[key] = dict(stats=st, prediction=want,
                            run_launches=_nonzero(r0["run_launches"]),
                            step_launches=_nonzero(r0["step_launches"]),
                            run_comm=r0["run_comm"],
                            step_comm=r0["step_comm"],
                            ready_s=r0["ready_s"])
    return summary


def sharded_phase(torch, dev, gen, layers: int, group_reqs, group_logits,
                  moe_tokens, run_a):
    """Phase 14: B1's partials / flush entries and B3's partials, then
    deepseek-7b (phase 4's traffic, tokens and logits; then phase 6's on
    the continuous engine, sequential and speculative, against run (a))
    and granite-moe-1b-a400m (phase 9's tokens) on a 1x2 mesh of ranks
    sharing the card."""
    t0 = time.time()
    err = check_partials(torch, dev, gen)
    stat_err, stat_ran = check_stationary_partials(torch, dev, gen)
    check_b2_heads(torch, dev, gen)
    row = time_partials(torch, dev, gen)
    secs = {"kernels": time.time() - t0}
    import numpy as np
    from repro_torch.configs import get_config
    t0 = time.time()
    dense = serve_sharded(torch, "deepseek-7b", layers,
                          [r.prompt for r in group_reqs],
                          [r.out_tokens for r in group_reqs],
                          [np.stack(group_logits[r.rid])
                           for r in group_reqs], cont=run_a)
    secs["dense"] = time.time() - t0
    t0 = time.time()
    arch = FAMILY_ARCHS[0]
    moe = serve_sharded(torch, arch, get_config(arch).n_layers,
                        moe_tokens["prompts"], moe_tokens["tokens"])
    secs["moe"] = time.time() - t0
    log("sharded: not shown here: NCCL (two ranks on one card run gloo, "
        "every collective staged through the host), inter-GPU bandwidth, "
        "and any speed of tensor parallelism (the ranks share one card's "
        "SMs)")
    log(f"sharded: card {card_name(torch)}; phase 14 seconds "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    return dict(b1_partials_err=err, b3_partials_err=stat_err,
                b3_partials_pieces=stat_ran, timing=row, dense=dense,
                moe=moe, seconds=secs)


# ---------------------------------------------------------------------------
# phase 17: the paper's numerics on a mesh of ranks (B4's and B5's partials)
# ---------------------------------------------------------------------------

# (name, Bt, M, K, N, the cuts of K into 2 and 3 pieces; offsets not
# multiples of B5's 128-code K tile)
PAPER_CUTS = [
    ("decode wd", 1, 4, 11008, 4096, ((0, 5001), (0, 3001, 7777))),
    ("prefill wg/wu", 1, 128, 4096, 11008, ((0, 2049), (0, 1111, 2900))),
]
# the keys of phase 7's configurations phase 17 serves on the mesh, and the
# exact ones (the rest held to the whole-model bar)
PAPER_MESH_KEYS = ("none", "a", "b", "c", "d", "e")
PAPER_EXACT = ("a", "b", "d", "e")
# the cached keys a slot at which phase 17 times a rank's padded float
# decode attention: phase 7's (32 + 16 + 1) and a long context
PAD_KEYS = (49, 4096)


def _pieces(fn, x, w, cut, K, **kw):
    """The int32 sum of ``fn``'s partials over the pieces of ``cut``
    (``x``'s and ``w``'s K axes: -1 and -2)."""
    edges = list(cut) + [K]
    return sum(fn(x[..., a:b].contiguous(), w[..., a:b, :].contiguous(),
                  k_offset=a, k_total=K, **kw)
               for a, b in zip(edges[:-1], edges[1:]))


def check_paper_partials(torch, dev, gen):
    """B5's partials entry over each cut of ``PAPER_CUTS``, the pieces'
    bins summed as int32 and its combine entry (with a per-column scale)
    == one B5 call times the scale == the twin, in E4M3 and E5M2 with the
    gate on and off (the combine == its twin on the same bins; at decode
    each piece's bins == the twin's); B4's partials entry the same way,
    flushed by B1's flush entry == one B4 call == B1 == the twin at flush
    periods 1, 4 and none. Returns the largest errors (0.0, 0.0)."""
    from repro_torch.core.formats import E4M3, E5M2, decode_bits, \
        encode_bits
    from repro_torch.kernels.mgs_matmul import (
        limb_decompose, mgs_matmul_dmac_codes, mgs_matmul_dmac_codes_plain,
        mgs_matmul_dmac_combine, mgs_matmul_dmac_combine_plain,
        mgs_matmul_dmac_partials, mgs_matmul_dmac_partials_plain,
        mgs_matmul_exact, mgs_matmul_exact_flush, mgs_matmul_exact_fused,
        mgs_matmul_exact_limb_partials, mgs_matmul_exact_plain)
    worst5 = worst4 = 0.0
    for name, Bt, M, K, N, cuts in PAPER_CUTS:
        sc = torch.rand((Bt, 1, N), generator=gen, device=dev) * 1e-3
        for fmt in (E4M3, E5M2):
            xc = encode_bits(_margin_values(torch, (Bt, M, K), dev, gen,
                                            fmt), fmt)
            wc = encode_bits(_margin_values(torch, (Bt, K, N), dev, gen,
                                            fmt), fmt)
            for gate in (True, False):
                one = mgs_matmul_dmac_codes(xc, wc, fmt, gate)
                twin = mgs_matmul_dmac_codes_plain(xc, wc, fmt, gate)
                for cut in cuts:
                    kw = dict(fmt=fmt, gate_subnormal=gate)
                    part = _pieces(mgs_matmul_dmac_partials, xc, wc, cut, K,
                                   **kw)
                    same = True
                    if M <= 16:     # the pieces' twins at decode
                        same = torch.equal(part, _pieces(
                            mgs_matmul_dmac_partials_plain, xc, wc, cut, K,
                            **kw))
                    got = mgs_matmul_dmac_combine(part, fmt, scale=sc)
                    plain = mgs_matmul_dmac_combine_plain(part, fmt,
                                                          scale=sc)
                    torch.cuda.synchronize()
                    want = one * sc
                    worst5 = max(worst5, (got - want).abs().max().item())
                    ok = (same and torch.equal(got, want)
                          and torch.equal(got, plain)
                          and torch.equal(one, twin))
                    log(f"B5 partials {name} {Bt}x({M}x{K} @ {K}x{N}) "
                        f"{fmt.name} gate={gate} cut at {list(cut[1:])}: "
                        f"bins summed + combine == B5 == twin {ok}")
                    if not ok or not torch.isfinite(got).all():
                        raise AssertionError(
                            f"B5 partials + combine at {name} {fmt.name} "
                            f"gate {gate} cut {cut} != B5")
            del xc, wc
        xc = fp8_codes(torch, (Bt, M, K), dev, gen)
        wc = fp8_codes(torch, (Bt, K, N), dev, gen)
        xl = limb_decompose(decode_bits(xc, E4M3)).movedim(0, 1).contiguous()
        wl = limb_decompose(decode_bits(wc, E4M3)).movedim(0, -3).contiguous()
        for fp in (1, 4, None):
            kw = dict(block_k=128, flush_period=fp)
            one = mgs_matmul_exact(xl, wl, E4M3, **kw)
            b1 = mgs_matmul_exact_fused(xc, wc, E4M3, **kw)
            twin = mgs_matmul_exact_plain(xl, wl, E4M3, **kw)
            for cut in cuts:
                part = _pieces(mgs_matmul_exact_limb_partials, xl, wl, cut,
                               K, fmt=E4M3, **kw)
                got = mgs_matmul_exact_flush(part, E4M3)
                torch.cuda.synchronize()
                worst4 = max(worst4, (got - one).abs().max().item())
                ok = (torch.equal(got, one) and torch.equal(got, b1)
                      and torch.equal(one, twin))
                log(f"B4 partials {name} {Bt}x({M}x{K} @ {K}x{N}) cut at "
                    f"{list(cut[1:])}, flush_period={fp}: {part.shape[0]} "
                    f"segments, flushed == B4 == B1 == twin {ok}")
                if not ok or not torch.isfinite(got).all():
                    raise AssertionError(f"B4 partials + flush at {name}, "
                                         f"cut {cut}, fp {fp} != B4")
        del xc, wc, xl, wl
    return worst5, worst4


def time_paper_partials(torch, dev, gen):
    """B5's partials and combine entries and B4's partials entry at decode
    wd, rank 0's cut of a 1x2 mesh (the first half of K: 4 x 5504 @ 5504 x
    4096), weights cycled past L2, beside their twins, bounds, one B5 / B4
    call over the whole K and a PyTorch yardstick (the f32 product of the
    cut)."""
    from repro_torch.core.formats import E4M3, decode_bits, encode_bits
    from repro_torch.kernels.mgs_matmul import (
        limb_decompose, mgs_matmul_dmac_codes, mgs_matmul_dmac_combine,
        mgs_matmul_dmac_combine_plain, mgs_matmul_dmac_partials,
        mgs_matmul_dmac_partials_plain, mgs_matmul_exact,
        mgs_matmul_exact_limb_partials, mgs_matmul_exact_limb_partials_plain,
        partial_segments)
    Bt, M, K, N = 1, 4, 11008, 4096
    Kl = K // 2
    copies = 8
    x = _margin_values(torch, (Bt, M, K), dev, gen)
    ws = [_margin_values(torch, (Bt, K, N), dev, gen) for _ in range(copies)]
    xc = encode_bits(x, E4M3)
    wcs = [encode_bits(w, E4M3) for w in ws]
    xcl = xc[..., :Kl].contiguous()
    wcl = [w[:, :Kl].contiguous() for w in wcs]
    xll = limb_decompose(x[..., :Kl]).movedim(0, 1).contiguous()
    wll = [limb_decompose(w[:, :Kl]).movedim(0, 1).contiguous() for w in ws]
    wlf = [limb_decompose(w).movedim(0, 1).contiguous() for w in ws[:2]]
    xlf = limb_decompose(x).movedim(0, 1).contiguous()
    del ws
    sc = torch.full((Bt, 1, 1), 1e-4, device=dev)
    it = iter(range(10**9))

    def nxt():
        return next(it) % copies
    bins = mgs_matmul_dmac_partials(xcl, wcl[0], E4M3, k_total=K)
    _, nseg = partial_segments(K, 128, None)
    xv = decode_bits(xcl, E4M3)
    wv = [decode_bits(w, E4M3) for w in wcl]
    row = dict(shape="decode wd, half K", Bt=Bt, M=M, K=K, K_cut=Kl, N=N,
               n_bins=E4M3.n_bins, segments=nseg)
    row["b5_partials_ms"] = time_ms(torch, lambda: mgs_matmul_dmac_partials(
        xcl, wcl[nxt()], E4M3, k_total=K), 20)
    row["b5_partials_plain_ms"] = time_ms(
        torch, lambda: mgs_matmul_dmac_partials_plain(xcl, wcl[0], E4M3,
                                                      k_total=K), 3,
        warmup=1)
    row["b5_combine_ms"] = time_ms(
        torch, lambda: mgs_matmul_dmac_combine(bins, E4M3, scale=sc), 20)
    row["b5_combine_plain_ms"] = time_ms(
        torch, lambda: mgs_matmul_dmac_combine_plain(bins, E4M3, scale=sc),
        5, warmup=1)
    row["b5_ms"] = time_ms(torch, lambda: mgs_matmul_dmac_codes(
        xc, wcs[nxt()], E4M3), 20)
    row["b4_partials_ms"] = time_ms(
        torch, lambda: mgs_matmul_exact_limb_partials(
            xll, wll[nxt()], E4M3, k_total=K), 20)
    row["b4_partials_plain_ms"] = time_ms(
        torch, lambda: mgs_matmul_exact_limb_partials_plain(
            xll, wll[0], E4M3, k_total=K), 3, warmup=1)
    row["b4_ms"] = time_ms(torch, lambda: mgs_matmul_exact(
        xlf, wlf[next(it) % 2], E4M3), 20)
    row["library_ms"] = time_ms(torch, lambda: torch.matmul(xv, wv[nxt()]),
                                20)
    for key, (ms, by) in (
            ("b5_partials", dmac_partials_bound(Bt, M, Kl, N, E4M3.n_bins)),
            ("b5_combine", dmac_combine_bound(Bt, M, N, E4M3.n_bins,
                                              sc.numel())),
            ("b4_partials", b4_partials_bound(Bt, M, Kl, N, nseg))):
        row[f"{key}_bound_ms"], row[f"{key}_bound_by"] = ms, by
    log(f"time B5 partials decode wd {M}x({Kl} of {K}) @ {Kl}x{N}: "
        f"{row['b5_partials_ms']:.4f} ms (twin "
        f"{row['b5_partials_plain_ms']:.3f}, torch.matmul f32 "
        f"{row['library_ms']:.4f}, bound {row['b5_partials_bound_ms']:.4f} "
        f"{row['b5_partials_bound_by']}); combine {E4M3.n_bins} bins -> "
        f"{M}x{N}: {row['b5_combine_ms']:.4f} ms (twin "
        f"{row['b5_combine_plain_ms']:.3f}, bound "
        f"{row['b5_combine_bound_ms']:.5f} {row['b5_combine_bound_by']}); "
        f"B5's one call over all K {row['b5_ms']:.4f} ms")
    log(f"time B4 partials, the same cut: {row['b4_partials_ms']:.4f} ms "
        f"(twin {row['b4_partials_plain_ms']:.3f}, bound "
        f"{row['b4_partials_bound_ms']:.4f} {row['b4_partials_bound_by']}); "
        f"B4's one call over all K {row['b4_ms']:.4f} ms")
    return row


def time_head_padding(torch, dev, gen, layers: int) -> dict:
    """A rank's float decode attention (``models.attention._sdpa_dense``)
    on ``SHARD_MESH`` at deepseek-7b's widths, phase 7's batch of 4 and
    ``PAD_KEYS`` keys: at the model's kv heads, the rank's share and zeros
    (as a rank runs it) against its share alone and one card's whole
    count; per layer, and times ``layers`` for a decode step."""
    from repro_torch.configs import get_config
    from repro_torch.models.attention import _sdpa_dense
    cfg = get_config("deepseek-7b")
    KV, hd, B = cfg.n_kv_heads, cfg.head_dim, 4
    G, KVl = cfg.n_heads // KV, KV // SHARD_MESH[1]
    dt = getattr(torch, cfg.compute_dtype)
    out = {}
    for S in PAD_KEYS:
        q = torch.randn((B, 1, KV, G, hd), generator=gen, device=dev).to(dt)
        k, v = (torch.randn((B, S, KV, hd), generator=gen,
                            device=dev).to(dt) for _ in range(2))
        bias = torch.zeros((B, 1, 1, 1, S), device=dev)
        ql, kl, vl = (t[:, :, :KVl].contiguous() for t in (q, k, v))
        row = dict(
            padded_ms=time_ms(torch, lambda: _sdpa_dense(
                ql, kl, vl, bias, kv_heads=KV), 20),
            share_ms=time_ms(torch, lambda: _sdpa_dense(ql, kl, vl, bias),
                             20),
            one_card_ms=time_ms(torch, lambda: _sdpa_dense(q, k, v, bias),
                                20))
        row["step_extra_ms"] = (row["padded_ms"] - row["share_ms"]) * layers
        out[S] = row
        log(f"time a rank's float decode attention, deepseek-7b B={B} "
            f"{S} keys on {SHARD_MESH}: at the model's {KV} kv heads "
            f"(padded) {row['padded_ms']:.4f} ms, its {KVl} alone "
            f"{row['share_ms']:.4f} ms, one card's {KV} "
            f"{row['one_card_ms']:.4f} ms a layer; the padding adds "
            f"{row['step_extra_ms']:.3f} ms to a {layers}-layer decode step")
    return out


def probe_head_share_bits(torch, dev, gen) -> dict:
    """Whether the float attention contractions keep their bits when a
    rank takes a share of the kv heads: deepseek-7b's 32 kv heads against
    the first ``KV / SHARD_MESH[1]`` alone and that share padded back to
    32 by zeros (``_sdpa_dense(kv_heads=)``), at a decode step (phase 7's
    batch of 4, 49 keys) and a prefill chunk (32 queries, 1024 keys).
    cuBLAS may pick a batched product's algorithm by its batch count."""
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-7b")
    KV, hd, B = cfg.n_kv_heads, cfg.head_dim, 4
    G, KVl = cfg.n_heads // KV, KV // SHARD_MESH[1]
    dt = getattr(torch, cfg.compute_dtype)

    def pad(t, dim):
        shape = list(t.shape)
        shape[dim] = KV - t.shape[dim]
        return torch.cat([t, t.new_zeros(shape)], dim)
    out = {}
    for name, T, S in (("decode", 1, 49), ("prefill", 32, 1024)):
        q = torch.randn((B, T, KV, G, hd), generator=gen, device=dev).to(dt)
        k, v = (torch.randn((B, S, KV, hd), generator=gen,
                            device=dev).to(dt) for _ in range(2))
        ql, kl, vl = q[:, :, :KVl], k[:, :, :KVl], v[:, :, :KVl]
        sc = "btkgh,bskh->bkgts"
        s_all = torch.einsum(sc, q.float(), k.float())
        s_share = torch.einsum(sc, ql.float(), kl.float())
        s_pad = torch.einsum(sc, pad(ql.float(), 2), pad(kl.float(), 2))
        w = torch.softmax(s_all, -1).to(dt)
        wl = w[:, :KVl]
        vc = "bkgts,bskh->btkgh"
        o_all = torch.einsum(vc, w, v)[:, :, :KVl]
        o_share = torch.einsum(vc, wl, vl)
        o_pad = torch.einsum(vc, pad(wl, 1), pad(vl, 2))[:, :, :KVl]
        out[name] = dict(
            scores_share=torch.equal(s_all[:, :KVl], s_share),
            scores_padded=torch.equal(s_all[:, :KVl], s_pad[:, :KVl]),
            values_share=torch.equal(o_all, o_share),
            values_padded=torch.equal(o_all, o_pad))
    log(f"float attention bits of a {KVl}-head share against {KV} heads "
        f"(True: equal): {out}")
    return out


def paper_prompts(vocab: int):
    """Phase 7's eight 32-token prompts (seed ``SEED``)."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    return [rng.integers(1, vocab, 32).astype(np.int32) for _ in range(8)]


def _paper_mesh_rank(rank: int, layers: int, prompts, keys):
    """One rank of phase 17: deepseek-7b at full width (``layers`` deep) on
    the world's ``1 x world`` serve mesh, one bf16 parameter set (phase
    7's), serving ``prompts`` (one group) under each of ``keys``, counted:
    the run's launches and collectives, and its first decode step's."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import BUILDS, LAUNCHES, reset_launch_counts
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.models import cast_params, init_params
    from repro_torch.parallel.comm import (COMM_STATS, rank_device,
                                           reset_comm_stats)
    from repro_torch.quant import PREP_STATS, clear_prepared_cache
    dev = rank_device()
    base = dataclasses.replace(get_config("deepseek-7b"), n_layers=layers)
    params = cast_params(init_params(base, SEED, device=dev), base)
    mesh = make_serve_mesh()
    out = {}
    for key in keys:
        name, quant = paper_configs()[key]
        cfg = dataclasses.replace(base, quant=quant)
        t0 = time.time()
        eng = ServeEngine(cfg, batch=4, max_len=32 + 16 + 1, params=params,
                          device=dev, mesh=mesh)
        torch.cuda.synchronize()
        t_build = time.time() - t0
        reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=16)
                for i, p in enumerate(prompts)]
        prep0, builds0 = dict(PREP_STATS), dict(BUILDS)
        # the run's first decode step, counted inside the run
        step = {}
        decode = eng._decode

        def counted(*a, **kw):
            if step:
                return decode(*a, **kw)
            n0, c0 = dict(LAUNCHES), dict(COMM_STATS)
            res = decode(*a, **kw)
            step["launches"] = {k: LAUNCHES[k] - n0[k] for k in n0}
            step["comm"] = {k: COMM_STATS[k] - c0[k] for k in c0}
            return res
        eng._decode = counted
        reset_launch_counts()
        reset_comm_stats()
        stats = eng.run(reqs, record_logits=rank == 0)
        run_launches, run_comm = dict(LAUNCHES), dict(COMM_STATS)
        logits = stats.pop("logits", None)
        flat = dict(PREP_STATS) == prep0 and dict(BUILDS) == builds0
        out[key] = dict(stats=stats, run_launches=run_launches,
                        run_comm=run_comm, step_launches=step["launches"],
                        step_comm=step["comm"], flat=flat,
                        tokens=[r.out_tokens for r in reqs], build_s=t_build)
        if logits is not None:
            out[key]["logits"] = {k: np.stack(v) for k, v in logits.items()}
        del eng
        clear_prepared_cache()
        gc.collect()
        torch.cuda.empty_cache()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def serve_paper_sharded(torch, layers: int, runs) -> dict:
    """Phase 7's first group (4 requests, 32-token prompts, 16 new tokens)
    under the unquantized model and (a)-(e), float cache, on a
    ``SHARD_MESH`` of ranks sharing the card: (a), (b), (d), (e) give phase
    7's tokens and every logits row bitwise; the unquantized model and (c)
    its greedy tokens with logits within the whole-model bar (the largest
    error printed); launches by entry and collectives a decode step and a
    run == ``sharded_prediction(quant=...)``; every entry of the path
    launched; ``PREP_STATS`` and the builds flat."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.parallel.comm import launch
    base = dataclasses.replace(get_config("deepseek-7b"), n_layers=layers)
    prompts = paper_prompts(base.vocab)[:4]
    world = SHARD_MESH[0] * SHARD_MESH[1]
    t0 = time.time()
    res = launch(_paper_mesh_rank, world,
                 args=(layers, prompts, PAPER_MESH_KEYS), device="cuda",
                 share_device=True, timeout=600.0)
    wall = time.time() - t0
    names = {k: v[0] for k, v in paper_configs().items()}
    out = {"wall_s": wall, "peak_gib": max(o["peak_gib"] for o in res)}
    for key in PAPER_MESH_KEYS:
        quant = paper_configs()[key][1]
        want = sharded_prediction(base, model=SHARD_MESH[1], batch=4,
                                  prompt=32, new=16, requests=4, quant=quant)
        ref = runs[key]
        for r, o in enumerate(res):
            got = o[key]
            if got["tokens"] != [ref["tokens"][i] for i in range(4)]:
                raise AssertionError(f"paper ({key}) on {SHARD_MESH}: rank "
                                     f"{r} tokens differ from phase 7's")
            if not got["flat"]:
                raise AssertionError(f"paper ({key}): rank {r} prepared or "
                                     "built while serving")
            for part in ("run", "step"):
                got_k = _nonzero(got[f"{part}_launches"])
                got_c = {k: got[f"{part}_comm"][k]
                         for k in want[f"{part}_comm"]}
                if got_k != _nonzero(want[f"{part}_launches"]) or \
                        got_c != want[f"{part}_comm"]:
                    raise AssertionError(
                        f"paper ({key}) rank {r} {part}: launches {got_k} "
                        f"collectives {got_c} != predicted "
                        f"{_nonzero(want[f'{part}_launches'])} "
                        f"{want[f'{part}_comm']}")
        r0 = res[0][key]
        rows = r0["logits"]
        scale = max(np.abs(ref["logits"][i]).max() for i in range(4))
        err = [np.abs(rows[i].astype(np.float64) - ref["logits"][i]) for i in
               range(4)]
        worst = max(e.max() for e in err) / scale
        mean = float(np.mean([e.mean() for e in err])) / scale
        same = all(np.array_equal(rows[i], ref["logits"][i])
                   for i in range(4))
        if key in PAPER_EXACT and not same:
            raise AssertionError(f"paper ({key}) on {SHARD_MESH}: logits "
                                 f"differ from phase 7's (max {worst:.3g} "
                                 "of the scale)")
        if key not in PAPER_EXACT and (worst > 5e-2 or mean > 1e-2):
            raise AssertionError(f"paper ({key}) on {SHARD_MESH}: logits "
                                 f"beyond the whole-model bar ({worst:.3g}, "
                                 f"mean {mean:.3g} of the scale)")
        used = [k for k, v in want["run_launches"].items() if v]
        if any(r0["run_launches"].get(k, 0) == 0 for k in used):
            raise AssertionError(f"paper ({key}): a kernel of the path "
                                 "never launched")
        log(f"paper sharded ({key}) {names[key]} on {SHARD_MESH[0]}x"
            f"{SHARD_MESH[1]}: tokens == phase 7's on every rank; logits "
            + ("bitwise" if same else
               f"within the bar: largest error {worst:.4g}, mean {mean:.4g} "
               "of the logit scale")
            + f"; run launches {_nonzero(r0['run_launches'])}, collectives "
            f"{r0['run_comm']} == prediction; a decode step "
            f"{_nonzero(r0['step_launches'])}, {r0['step_comm']} == "
            f"prediction; engine {r0['build_s']:.1f} s, run "
            f"{r0['stats']['wall_s']:.2f} s")
        out[key] = dict(run_launches=_nonzero(r0["run_launches"]),
                        step_launches=_nonzero(r0["step_launches"]),
                        run_comm=r0["run_comm"], step_comm=r0["step_comm"],
                        max_logit_err=float(worst),
                        mean_logit_err=float(mean), bitwise=bool(same),
                        wall_s=r0["stats"]["wall_s"], build_s=r0["build_s"])
    log(f"paper sharded: launch + join {wall:.1f} s, peak device memory "
        f"{out['peak_gib']:.1f} GiB a rank")
    return out


def paper_sharded_phase(torch, dev, gen, layers: int, runs) -> dict:
    """Phase 17: B5's partials / combine and B4's partials entries checked
    and timed, then phase 7's first group under (a)-(e) and the
    unquantized model on a 1x2 mesh of ranks sharing the card."""
    t0 = time.time()
    b5_err, b4_err = check_paper_partials(torch, dev, gen)
    row = time_paper_partials(torch, dev, gen)
    pad = time_head_padding(torch, dev, gen, layers)
    pad["bits"] = probe_head_share_bits(torch, dev, gen)
    secs = {"kernels": time.time() - t0}
    t0 = time.time()
    served = serve_paper_sharded(torch, layers, runs)
    secs["serve"] = time.time() - t0
    log(f"paper sharded: card {card_name(torch)}; phase 17 seconds "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    return dict(b5_partials_err=b5_err, b4_partials_err=b4_err, timing=row,
                head_padding=pad, served=served, seconds=secs)


# ---------------------------------------------------------------------------
# phase 15: training on a mesh of ranks, elastic resharding
# ---------------------------------------------------------------------------

# (a) mgs-paper-eval: TRAIN_HALF steps on a 2x2 mesh (batch over (data,
# model): D = 4), a checkpoint, the elastic 1x2 mesh of 4 slots with 2
# excluded (D = 2), TRAIN_HALF more steps; (b) granite-moe-1b-a400m: one
# step on 1x2 (D = 2) at phase 12's MOE_BATCH x MOE_SEQ, on the same two
# ranks
TRAIN_MESH, ELASTIC_SLOTS, ELASTIC_EXCLUDE, TRAIN_HALF = (2, 2), 4, (2, 3), 4
MOE_MESH = (1, 2)
# granite-moe's depth in phase 15, of 24 (full width): at 24 layers its
# one-step part alone took 142.5 s of a 252.5 s phase on an H100
MOE_TRAIN_LAYERS = 6


class _CommRecorder:
    """A stop handler that never stops: it snapshots ``COMM_STATS`` at each
    poll (once a step, just before the loop's stop flag)."""

    def __init__(self, stats):
        self.stats, self.snaps = stats, [dict(stats)]

    @property
    def should_stop(self):
        self.snaps.append(dict(self.stats))
        return False

    def deltas(self):
        """Each step's collectives from the second step on (with the stop
        flag of the step before it, and the checkpoint's gathers when the
        step wrote one)."""
        return [{k: b[k] - a[k] for k in a}
                for a, b in zip(self.snaps[1:], self.snaps[2:])]


def _checksum(t) -> int:
    """A position-weighted 64-bit sum of a tensor's bits, taken on its
    device: element ``i``'s bits times ``2 i + 1``, summed modulo 2**64.
    Any one element that differs changes it (an odd weight times a
    nonzero difference below 2**64 is not 0 modulo 2**64)."""
    import torch
    flat = t.detach().contiguous().reshape(-1)
    bits = flat.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                      8: torch.int64}[flat.element_size()])
    total, chunk = 0, 1 << 24
    for i in range(0, bits.numel(), chunk):
        b = bits[i:i + chunk].to(torch.int64)
        w = torch.arange(2 * i + 1, 2 * (i + b.numel()), 2,
                         dtype=torch.int64, device=b.device)
        total = (total + int((b * w).sum())) % (1 << 64)
    return total


def _slice_checksums(cfg, state, shape, factored):
    """{coord: {leaf: checksum of that rank's slice}} of a whole state for
    every rank of a ``shape`` mesh."""
    import itertools
    from types import SimpleNamespace
    from repro_torch.parallel.sharding import (MeshShape, local_slices,
                                               train_rules)
    from repro_torch.train.train_step import train_state_specs
    from repro_torch.tree import flatten_with_paths
    specs = flatten_with_paths(train_state_specs(
        cfg, train_rules(MeshShape(("data", "model"), tuple(shape))),
        factored))
    flat = flatten_with_paths(state)
    out = {}
    for c in itertools.product(*(range(s) for s in shape)):
        m = SimpleNamespace(shape=dict(zip(("data", "model"), shape)),
                            coord=dict(zip(("data", "model"), c)))
        out[c] = {k: _checksum(v[local_slices(specs[k], tuple(v.shape), m)])
                  for k, v in flat.items()}
    return out


def _train_sharded_rank(rank: int, shape, parts):
    """One rank of phase 15 on the world's ``shape`` mesh, or (``shape``
    None) the one-card process. Each of ``parts`` (arch, layers, remat,
    runs of (loop, resume step, opt), the mesh shape whose slices to
    checksum or None) in turn, through ``train_loop`` under deterministic
    algorithms: each run's history, per-step and whole collectives and
    seconds; checksums of this rank's final state leaves (of every rank's
    slice of the whole state for the one-card process); peak device
    memory."""
    t_enter = time.time()
    import gc
    import torch
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.parallel import comm
    from repro_torch.tree import flatten_with_paths
    mesh = make_mesh(shape, ("data", "model")) if shape else None
    dev = comm.rank_device()
    out = {"coord": tuple(mesh.coord.values()) if mesh else None,
           "t_enter": t_enter, "t_ready": time.time(), "parts": []}
    for arch, layers, remat, runs, sum_shape in parts:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                  remat=remat)
        torch.cuda.reset_peak_memory_stats(dev)
        done = []
        for loop, resume, opt in runs:
            rec = _CommRecorder(comm.COMM_STATS)
            t0 = time.time()
            res = train_loop(cfg, loop, device=dev, mesh=mesh, opt_cfg=opt,
                             resume_step=resume, handler=rec)
            torch.cuda.synchronize(dev)
            done.append(dict(
                history=res["history"], deltas=rec.deltas(),
                total={k: comm.COMM_STATS[k] - rec.snaps[0][k]
                       for k in rec.snaps[0]},
                seconds=time.time() - t0))
        t0 = time.time()
        state = res.pop("state")
        part = dict(runs=done, peak_gib=torch.cuda.max_memory_allocated(
            dev) / 2**30, sums={k: _checksum(v) for k, v in
                                flatten_with_paths(state).items()})
        if sum_shape is not None:
            part["slice_sums"] = _slice_checksums(cfg, state, sum_shape,
                                                  runs[-1][2].factored)
        part["check_s"] = time.time() - t0
        out["parts"].append(part)
        del state, res
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _same_history(what, ranks, one_runs, part: int):
    """Every rank's every step's loss, aux loss, tokens and grad norm in
    ``part`` == the one-card run's, bitwise; returns those."""
    keys = ("loss", "aux_loss", "tokens", "grad_norm")
    want = [tuple(h[k] for k in keys) for r in one_runs for h in r["history"]]
    for rank in ranks:
        got = [tuple(h[k] for k in keys) for r in rank["parts"][part]["runs"]
               for h in r["history"]]
        if got != want:
            raise AssertionError(f"{what}: rank {rank['coord']}'s per-step "
                                 f"metrics {got} != the one card's {want}")
    return want


def _same_sums(what, ranks, part: int, one_part):
    for r in ranks:
        want = one_part["slice_sums"][r["coord"]]
        got = r["parts"][part]["sums"]
        if got != want:
            bad = sorted(k for k in want if got.get(k) != want[k])
            raise AssertionError(f"{what}: rank {r['coord']} state differs "
                                 f"from the one-card run's slice: {bad[:5]}")


def _check_comm(what, ranks, part: int, pred, saves_per_run):
    """Per rank: every step's collectives after the first == the
    prediction (the step that wrote a checkpoint: step + save), each run's
    whole == steps x step (+ save + the writer's barrier)."""
    barrier = dict.fromkeys(pred["step"], 0)
    barrier.update(calls=1, barrier=1)
    for r in ranks:
        for run, saves in zip(r["parts"][part]["runs"], saves_per_run):
            n = len(run["history"])
            want_steps = [pred["step"]] * (n - 1)
            if saves:
                want_steps[-1] = {k: pred["step"][k] + pred["save"][k]
                                  for k in pred["step"]}
            got_steps = [{k: d[k] for k in pred["step"]}
                         for d in run["deltas"]]
            want_total = {k: n * pred["step"][k]
                          + saves * (pred["save"][k] + barrier[k])
                          for k in pred["step"]}
            got_total = {k: run["total"][k] for k in pred["step"]}
            if got_steps != want_steps or got_total != want_total:
                raise AssertionError(
                    f"{what} rank {r['coord']}: collectives {got_steps} / "
                    f"{got_total} != predicted {want_steps} / {want_total}")


def _eval_logits(torch, cfg, directory, batch, dev):
    """Logits of the params of ``directory``'s newest checkpoint under
    ``mgs_exact`` (B1) on ``batch``, and the kernels' launches."""
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.models import forward
    from repro_torch.models.transformer import param_shapes
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.tree import unflatten
    _, flat, _ = ckpt.restore(directory)
    params = unflatten(param_shapes(cfg), {
        k[len("params/"):]: v.to(dev) for k, v in flat.items()
        if k.startswith("params/")})
    qcfg = dataclasses.replace(cfg, quant=table1_modes()["mgs_exact"])
    reset_launch_counts()
    with torch.no_grad():
        logits, _ = forward(params, qcfg, batch)
    torch.cuda.synchronize()
    return logits, dict(LAUNCHES)


def _launch_train(shape, parts):
    """(every rank's result, launch + join seconds, each rank's seconds
    from the launch to its rank function) of ``parts`` on a ``shape``
    mesh of ranks sharing the card (``None``: one process)."""
    from repro_torch.parallel.comm import launch
    t0 = time.time()
    res = launch(_train_sharded_rank, math.prod(shape) if shape else 1,
                 args=(shape, parts), device="cuda", share_device=True,
                 timeout=900.0)
    return res, time.time() - t0, [r["t_enter"] - t0 for r in res]


def train_sharded_phase(torch, dev, moe_layers: int = MOE_TRAIN_LAYERS):
    """Phase 15. (a) full-width mgs-paper-eval: TRAIN_HALF steps on
    TRAIN_MESH (D = 4) with a checkpoint, then TRAIN_HALF on the elastic
    1x2 mesh (D = 2) restored from it; (b) granite-moe-1b-a400m at full
    width (``moe_layers`` deep), remat per layer, one step of MOE_BATCH x
    MOE_SEQ on MOE_MESH (D = 2). Held against one card at grad_accum 4
    then 2 through its own checkpoint, and at grad_accum 2, in a process of
    its own run beside the meshes: every step's metrics and every rank's
    final slices bitwise, (a)'s final checkpoints and the ``mgs_exact``
    logits of its final params bitwise, collectives ==
    ``train_sharded_prediction``."""
    import gc
    import tempfile
    import threading
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import virtual_devices
    from repro_torch.launch.train import TrainLoopConfig
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.runtime.elastic import make_elastic_mesh
    from repro_torch.train import OptConfig
    gc.collect()
    torch.cuda.empty_cache()
    # cuBLAS reads it when a process creates its handle: every compared run
    # is spawned after this
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    t_phase = time.time()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), remat="none")
    moe_full = get_config(MOE_TRAIN_ARCH)
    moe_cfg = dataclasses.replace(moe_full, n_layers=moe_layers)
    if moe_layers != moe_full.n_layers:
        log(f"train sharded {MOE_TRAIN_ARCH}: cut to {moe_layers} of its "
            f"{moe_full.n_layers} layers (full width, {MOE_BATCH} x "
            f"{MOE_SEQ} tokens): at {moe_full.n_layers} layers this part "
            "alone took 142.5 s on an H100")
    sub = make_elastic_mesh(2, devices=virtual_devices(dev, ELASTIC_SLOTS),
                            exclude=ELASTIC_EXCLUDE)
    elastic = tuple(sub.shape.values())
    assert elastic == MOE_MESH, (elastic, MOE_MESH)
    opt = OptConfig(lr=3e-3, warmup_steps=2, total_steps=2 * TRAIN_HALF)
    moe_opt = OptConfig(lr=3e-4, warmup_steps=1, total_steps=1)
    pa = train_sharded_prediction(cfg, TRAIN_MESH, TRAIN_BATCH, TRAIN_SEQ)
    pb = train_sharded_prediction(cfg, elastic, TRAIN_BATCH, TRAIN_SEQ)
    pm = train_sharded_prediction(moe_cfg, MOE_MESH, MOE_BATCH, MOE_SEQ)
    moe_loop = TrainLoopConfig(steps=1, global_batch=MOE_BATCH,
                               seq_len=MOE_SEQ, log_every=1, seed=SEED)
    dense = (TRAIN_ARCH, cfg.n_layers, "none")
    moe = (MOE_TRAIN_ARCH, moe_layers, "layer")
    with tempfile.TemporaryDirectory() as d:
        mesh_dir, one_dir = os.path.join(d, "mesh"), os.path.join(d, "one")
        a = TrainLoopConfig(steps=TRAIN_HALF, global_batch=TRAIN_BATCH,
                            seq_len=TRAIN_SEQ, log_every=1,
                            ckpt_every=TRAIN_HALF, ckpt_dir=mesh_dir,
                            seed=SEED)
        b = dataclasses.replace(a, steps=2 * TRAIN_HALF)
        one_parts = [
            (*dense, [(dataclasses.replace(a, ckpt_dir=one_dir,
                                           grad_accum=pa["D"]), None, opt),
                      (dataclasses.replace(b, ckpt_dir=one_dir,
                                           grad_accum=pb["D"]), TRAIN_HALF,
                       opt)], elastic),
            (*moe, [(dataclasses.replace(moe_loop, grad_accum=pm["D"]),
                     None, moe_opt)], MOE_MESH)]
        box = {}

        def one_card():
            try:
                box["one"] = _launch_train(None, one_parts)
            except BaseException as e:      # re-raised below
                box["error"] = e
        beside = threading.Thread(target=one_card)
        beside.start()
        try:
            ra, wall_a, spawn_a = _launch_train(
                TRAIN_MESH, [(*dense, [(a, None, opt)], None)])
            rb, wall_b, spawn_b = _launch_train(
                elastic, [(*dense, [(b, TRAIN_HALF, opt)], None),
                          (*moe, [(moe_loop, None, moe_opt)], None)])
        finally:
            beside.join()
        if "error" in box:
            raise box["error"]
        (one,), wall_one, spawn_one = box["one"]
        one_a, one_m = one["parts"]
        metrics = _same_history(f"{TRAIN_ARCH} on {TRAIN_MESH}", ra,
                                one_a["runs"][:1], 0)
        metrics += _same_history(f"{TRAIN_ARCH} on {elastic}", rb,
                                 one_a["runs"][1:], 0)
        _same_sums(f"{TRAIN_ARCH} on {elastic}", rb, 0, one_a)
        _, fm, em = ckpt.restore(mesh_dir)
        _, fo, eo = ckpt.restore(one_dir)
        if sorted(fm) != sorted(fo) or em != eo or not all(
                torch.equal(fm[k], fo[k]) for k in fo):
            raise AssertionError(f"{TRAIN_ARCH}: the mesh's final checkpoint "
                                 "differs from the one card's")
        del fm, fo
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH, seed=SEED))
        batch = _to_dev(torch, data.make_batch(10_000), dev)
        lm, launches = _eval_logits(torch, cfg, mesh_dir, batch, dev)
        lo, _ = _eval_logits(torch, cfg, one_dir, batch, dev)
    want_l = {"mgs_matmul_exact_fused": eval_launches(cfg)}
    if not torch.equal(lm, lo) or _nonzero(launches) != want_l:
        raise AssertionError(f"{TRAIN_ARCH}: mgs_exact logits of the mesh-"
                             f"trained params differ, or B1 launched "
                             f"{launches} != {want_l}")
    _check_comm(f"{TRAIN_ARCH} {TRAIN_MESH}", ra, 0, pa, [1])
    _check_comm(f"{TRAIN_ARCH} {elastic}", rb, 0, pb, [1])
    moe_metrics = _same_history(MOE_TRAIN_ARCH, rb, one_m["runs"], 1)
    _same_sums(f"{MOE_TRAIN_ARCH} on {MOE_MESH}", rb, 1, one_m)
    _check_comm(f"{MOE_TRAIN_ARCH} {MOE_MESH}", rb, 1, pm, [0])

    def med(runs):
        return statistics.median(h["ms"] for r in runs
                                 for h in r["history"][1:])
    step_ms = {"2x2": med(ra[0]["parts"][0]["runs"]),
               "1x2": med(rb[0]["parts"][0]["runs"]),
               "one_card": med(one_a["runs"])}
    moe_ms = {"1x2": [r["parts"][1]["runs"][0]["history"][0]["ms"]
                      for r in rb],
              "one_card": one_m["runs"][0]["history"][0]["ms"]}
    peak = {"2x2": [r["parts"][0]["peak_gib"] for r in ra],
            "1x2_dense": [r["parts"][0]["peak_gib"] for r in rb],
            "1x2_moe": [r["parts"][1]["peak_gib"] for r in rb],
            "one_card_dense": one_a["peak_gib"],
            "one_card_moe": one_m["peak_gib"]}
    secs = {"phase": time.time() - t_phase, "wall_2x2": wall_a,
            "wall_1x2": wall_b, "wall_one_card": wall_one,
            "spawn_2x2": max(spawn_a), "spawn_1x2": max(spawn_b),
            "spawn_one_card": spawn_one[0],
            "ready_2x2": max(r["t_ready"] - r["t_enter"] for r in ra),
            "runs_2x2": ra[0]["parts"][0]["runs"][0]["seconds"],
            "runs_1x2": [p["runs"][0]["seconds"] for p in rb[0]["parts"]],
            "runs_one_card": [r["seconds"] for p in one["parts"]
                              for r in p["runs"]],
            "checksums": [p["check_s"] for p in one["parts"]]}
    log(f"train sharded {TRAIN_ARCH} ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {TRAIN_BATCH} x {TRAIN_SEQ}): {TRAIN_HALF} steps on "
        f"{TRAIN_MESH[0]}x{TRAIN_MESH[1]} (D = {pa['D']}), checkpoint, "
        f"make_elastic_mesh(2) over {ELASTIC_SLOTS} slots without "
        f"{list(ELASTIC_EXCLUDE)} -> {elastic[0]}x{elastic[1]} (D = "
        f"{pb['D']}), restore, {TRAIN_HALF} more: every step's loss / aux / "
        f"tokens / grad norm, every rank's final slices and the final "
        f"checkpoint bitwise one card at grad_accum {pa['D']} then "
        f"{pb['D']}; the final params' mgs_exact logits bitwise "
        f"({want_l['mgs_matmul_exact_fused']} B1 launches a forward)")
    log(f"train sharded {TRAIN_ARCH}: losses {[m[0] for m in metrics]}")
    log(f"train sharded {MOE_TRAIN_ARCH} ({moe_layers} layers, "
        f"{MOE_BATCH} x {MOE_SEQ}, remat per layer): one step on "
        f"{MOE_MESH[0]}x{MOE_MESH[1]} (D = {pm['D']}) bitwise one card at "
        f"grad_accum {pm['D']} (loss {moe_metrics[0][0]}, aux "
        f"{moe_metrics[0][1]}, grad norm {moe_metrics[0][3]}), every "
        "rank's slices bitwise")
    log(f"train sharded: collectives a step per rank == prediction: "
        f"{TRAIN_ARCH} {TRAIN_MESH} {pa['step']}, {elastic} {pb['step']} "
        f"(a checkpoint {pa['save']} / {pb['save']}); {MOE_TRAIN_ARCH} "
        f"{MOE_MESH} {pm['step']}")
    log(f"train sharded: median step ms {TRAIN_ARCH} {step_ms}; "
        f"{MOE_TRAIN_ARCH} {moe_ms}; peak device memory GiB {peak} (the "
        f"one-card process ran beside the meshes)")
    log("train sharded: not shown here: NCCL (the ranks share one card over "
        "gloo, every collective staged through the host), 2+ cards, and any "
        "speed of data parallelism (the ranks share one card's SMs)")
    log(f"train sharded: card {card_name(torch)}; phase 15 seconds {secs}")
    return dict(dense=dict(arch=TRAIN_ARCH, mesh=list(TRAIN_MESH),
                           elastic=list(elastic), metrics=metrics,
                           prediction={"2x2": pa, "1x2": pb},
                           step_ms=step_ms, launches_per_forward=want_l),
                moe=dict(arch=MOE_TRAIN_ARCH, layers=moe_layers,
                         seq=MOE_SEQ, mesh=list(MOE_MESH),
                         metrics=moe_metrics, prediction=pm, step_ms=moe_ms),
                peak_gib=peak, seconds=secs)


# ---------------------------------------------------------------------------
# phase 16: the dry run against the card
# ---------------------------------------------------------------------------

# resident bytes are held to the dry run within the larger of 2 MiB and
# 0.1% of the prediction: the caching allocator rounds each block up to a
# multiple of 512 bytes, and an engine keeps a few small tensors of its own
# that the dry run does not count
RESIDENT_TOL_BYTES, RESIDENT_TOL_SHARE = 2 << 20, 1e-3
# the dry run's full-depth records: deepseek-7b's 30 layers, every shape,
# these meshes and configurations
DRYRUN_MESHES = ("1x1", "1x8", "16x16")
DRYRUN_QUANTS = ("fp8_mgs_serve_kv", "none")
DRYRUN_SECONDS = 30.0


def dryrun_phase(torch, mem, group_step, paged_step):
    """Phase 16: ``launch.dryrun`` against what the card holds and does.
    The resident bytes of phase 4's group engine (its weights; one cache)
    and of phase 6's continuous engine (weights and pool) == the dry run's
    within ``RESIDENT_TOL_*``; the group run's peak over the resident
    beside the dry run's cache and transient estimate; the kernels' step
    bound of a group and a paged decode step beside the profiled device
    busy time of phases 5 and 6; the records of deepseek-7b at full depth
    (``DRYRUN_MESHES`` x every shape x ``DRYRUN_QUANTS``), one line each,
    the whole records under ``build/dryrun/``. Takes at most
    ``DRYRUN_SECONDS``."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import H100_SXM
    t0 = time.time()
    props = torch.cuda.get_device_properties(0)
    log(f"dry run: card total_memory {props.total_memory} B "
        f"(H100_SXM.hbm_bytes {H100_SXM.hbm_bytes:.0f})")
    g, c = mem["group_cfg"], mem["cont_cfg"]
    gp, cp = dryrun.param_bytes(g), dryrun.param_bytes(c)
    gcache = dryrun.cache_bytes(g, 4, mem["group_max_len"])
    pool = dryrun.pool_bytes(c, CONT_SLOTS, CONT_MAX_LEN, mem["cont_blocks"])
    out = {"resident": {}}
    for name, got, want in (
            ("group weights", mem["group_weights"], sum(gp.values())),
            ("group cache", mem["group_cache"], gcache),
            ("continuous weights + pool", mem["continuous"],
             sum(cp.values()) + pool)):
        tol = max(RESIDENT_TOL_BYTES, RESIDENT_TOL_SHARE * want)
        log(f"dry run: {name}: memory_allocated grew {got} B, predicted "
            f"{want} B (diff {got - want:+d} B, tolerance {tol:.0f} B)")
        out["resident"][name] = dict(measured=got, predicted=want, tol=tol)
        if abs(got - want) > tol:
            raise AssertionError(f"dry run: {name} {got} B != predicted "
                                 f"{want} B within {tol:.0f} B")
    # the group run's peak over what was resident: its caches and one
    # step's transients (the prefill of 4 x 32 tokens is the largest)
    want = gcache + dryrun._transient_bytes(g, "prefill", 4, 32, 32)
    out["group_run_peak"] = dict(measured=mem["group_run_peak"],
                                 predicted=want)
    log(f"dry run: group run peak over the resident "
        f"{mem['group_run_peak']} B (max_memory_allocated), predicted "
        f"cache + transient {want} B")
    # the kernels' step bound beside the profiled device time
    for name, cfg, rows, S, live, row in (
            ("group decode step", g, 4, mem["group_max_len"], 39,
             group_step),
            ("paged decode step", c, CONT_SLOTS, CONT_MAX_LEN,
             paged_step["live"], paged_step)):
        dots = dryrun.step_dots(cfg, "decode", rows, 1, cache_len=S,
                                live=live)
        bound_ms = dryrun.kernel_bound_ms(dots)
        kern = row["B1_ms"] + row["B3_ms"] + row["B2_ms"]
        out[name] = dict(bound_ms=bound_ms, kernel_ms=kern,
                         device_ms=row["device_ms"],
                         launches=dryrun.launches(dots))
        log(f"dry run: {name}: kernels' bound {bound_ms:.4f} ms "
            f"({sum(dryrun.launches(dots).values())} launches) beside "
            f"B1 / B3 / B2 busy {kern:.3f} ms ({bound_ms / kern:.1%}) and "
            f"device busy {row['device_ms']:.3f} ms "
            f"({bound_ms / row['device_ms']:.1%})")
    recs = []
    for quant in DRYRUN_QUANTS:
        for shape in SHAPES:
            for m in DRYRUN_MESHES:
                rec = dryrun.run_cell("deepseek-7b", shape, m, quant)
                recs.append(rec)
                if rec.get("skipped"):
                    log(f"dry run: deepseek-7b {shape} {m} {quant}: "
                        f"skipped ({rec['reason']})")
                    continue
                mm = rec["memory_per_device"]
                log(f"dry run: deepseek-7b {shape} {m} {quant}: compute "
                    f"{rec['t_compute'] * 1e3:.3f} ms, memory "
                    f"{rec['t_memory'] * 1e3:.3f} ms, collective "
                    f"{rec['t_collective'] * 1e3:.3f} ms -> "
                    f"{rec['bottleneck']}; live "
                    f"{mm['live_bytes'] / 1e9:.2f} GB, fits "
                    f"{rec['fits_hbm']}; launches "
                    f"{sum(rec['launches'].values())}"
                    + (f"; the port's engine refuses it today"
                       if rec["port_refuses"] else ""))
    path = HERE / "build" / "dryrun" / "deepseek-7b.json"
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(recs, indent=1))
    except OSError as e:
        log(f"dry run: records not written ({e})")
    secs = time.time() - t0
    out["seconds"] = secs
    if secs > DRYRUN_SECONDS:
        raise AssertionError(f"phase 16 took {secs:.1f} s > "
                             f"{DRYRUN_SECONDS} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=DEPTH,
                    help=f"deepseek-7b layers to serve (of 30; {DEPTH} by "
                    "default)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found (run from a "
              "checkout of the repository)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_all = time.time()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import build_all
    t0 = time.time()
    logs = build_all(verbose=True)
    log(f"phase 1: built {sorted(logs)} in {time.time() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill", "error")):
                log(f"  {name}: {line.strip()}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.time()
    b1_err = check_b1(torch, dev, gen)
    b3_err = check_b3(torch, dev, gen)
    log(f"phase 2: B1 == twin, B3 == B1 == twin at every shape "
        f"({time.time() - t0:.1f} s)")
    t0 = time.time()
    b2_err, b2_args = check_b2(torch, dev, gen)
    b2p_err, b2p_args = check_b2_paged(torch, dev, gen)
    b2_err = max(b2_err, b2p_err)
    log(f"phase 3: B2 dense, paged and verify entries == twin "
        f"({time.time() - t0:.1f} s)")

    t0 = time.time()
    mem = {}
    group_run, stats, eng, group_reqs, group_logits = serve_full(
        torch, "deepseek-7b", args.layers, mem)
    serve_reduced_gpu_vs_cpu(torch)
    log(f"phase 4: served ({time.time() - t0:.1f} s)")

    t0 = time.time()
    b1_rows = time_b1(torch, dev, gen)
    b2_row = time_b2(torch, b2_args)
    b2p_rows = time_b2_paged(torch, b2p_args)
    b2_ctx = time_b2_contexts(torch, dev, gen)
    step = profile_decode_step(torch, eng)
    group_params = eng.params       # phase 8 serves these weights again
    del eng
    log(f"phase 5: timed ({time.time() - t0:.1f} s)")

    t0 = time.time()
    ceng, launches, run_a, run_c = serve_continuous(torch, args.layers, mem)
    cont = dict(
        decode_step_ms_median=statistics.median(run_a["step_s"]) * 1e3,
        spec_round_ms_median=statistics.median(run_c["step_s"]) * 1e3,
        decode_tok_per_s=run_a["decode_tok_per_s"],
        spec_decode_tok_per_s=run_c["decode_tok_per_s"],
        wall_s=run_a["wall_s"], spec_wall_s=run_c["wall_s"],
        steps=run_a["steps"], spec_rounds=run_c["steps"],
        acceptance_rate=run_c["spec"]["acceptance_rate"],
        tokens_per_round=run_c["spec"]["tokens_per_round"])
    log(f"continuous timing: decode step {cont['decode_step_ms_median']:.1f}"
        f" ms (median of {cont['steps']}), spec round "
        f"{cont['spec_round_ms_median']:.1f} ms (median of "
        f"{cont['spec_rounds']}), decode tokens/s {cont['decode_tok_per_s']:.2f}"
        f" sequential, {cont['spec_decode_tok_per_s']:.2f} speculative")
    paged_step = profile_paged_step(torch, ceng)
    cont_params = ceng.params       # and these
    del ceng
    b3_rows = time_b3(torch, dev, gen)
    log(f"phase 6: continuous path served and timed "
        f"({time.time() - t0:.1f} s)")

    t0 = time.time()
    b4_err, b5_err = check_b4_b5(torch, dev, gen)
    for key in ("a", "b"):
        name, quant = paper_configs()[key]
        serve_reduced_gpu_vs_cpu(torch, quant, name)
    runs, paper_steps = serve_paper(torch, args.layers)
    accuracy = paper_accuracy(runs)
    b45_rows = time_b45(torch, dev, gen)
    log(f"phase 7: paper numerics checked, served and timed "
        f"({time.time() - t0:.1f} s)")

    t0 = time.time()
    calibration = {
        "group": calibrate_group(torch, group_params, args.layers),
        "continuous": calibrate_continuous(torch, cont_params, args.layers,
                                           paged_step)}
    log(f"phase 8: calibration served, swapped, fenced and replayed on "
        f"both engines ({time.time() - t0:.1f} s)")

    # phase 13 runs here, while phases 4 and 6's prepared weights are alive
    t0 = time.time()
    fleet = fleet_phase(torch, group_params, group_reqs, cont_params, run_a,
                        args.layers)
    del group_params, cont_params
    log(f"phase 13: the replica fleet served through a poisoned slot, a "
        f"retry, a calibration push and continuous traffic "
        f"({time.time() - t0:.1f} s)")

    t0 = time.time()
    fam = family_phase(torch, dev, gen)
    fam_launches = {k: fam["runs"][a]["launches"]
                    for k, a in zip(("group_moe", "group_ssm"), FAMILY_ARCHS)}
    b1_err = max(b1_err, fam["b1_err"])
    b2_err = max(b2_err, fam["b2_err"])
    log(f"phase 9: MoE and SSM families checked, served and timed "
        f"({time.time() - t0:.1f} s)")

    t0 = time.time()
    late = late_phase(torch, dev, gen)
    fam_launches.update({k: late["runs"][a]["launches"] for k, a in zip(
        ("group_encdec", "group_vlm"), LATE_ARCHS)})
    b1_err = max(b1_err, late["b1_err"])
    b2_err = max(b2_err, late["b2_err"])
    log(f"phase 10: hybrid, encoder-decoder and VLM families checked and "
        f"served ({time.time() - t0:.1f} s)")

    t0 = time.time()
    analysis = analysis_phase(torch)
    log(f"phase 11: the paper's accumulation analysis checked on the card "
        f"({time.time() - t0:.1f} s)")

    t0 = time.time()
    training = train_phase(torch, dev, gen)
    b1_err = max(b1_err, training["b1_err"])
    b5_err = max(b5_err, training["b5_err"])
    log(f"phase 12: trained, scored Table 1 / Fig. 9 and trained "
        f"{MOE_TRAIN_ARCH} ({time.time() - t0:.1f} s)")

    t0 = time.time()
    sharded = sharded_phase(torch, dev, gen, args.layers, group_reqs,
                            group_logits, fam["runs"][FAMILY_ARCHS[0]],
                            run_a)
    del group_logits
    log(f"phase 14: B1's partials and flush entries and B3's partials "
        f"checked and timed; deepseek-7b (group and continuous, sequential "
        f"and speculative) and {FAMILY_ARCHS[0]} served on a 1x2 mesh of "
        f"ranks bitwise their one-card runs ({time.time() - t0:.1f} s)")

    t0 = time.time()
    paper_sharded = paper_sharded_phase(torch, dev, gen, args.layers, runs)
    log(f"phase 17: B5's partials and combine entries and B4's partials "
        f"checked and timed; phase 7's first group under the unquantized "
        f"model and (a)-(e) served on a 1x2 mesh of ranks, its one-card "
        f"bits where the sums are exact ({time.time() - t0:.1f} s)")

    t0 = time.time()
    train_sharded = train_sharded_phase(torch, dev)
    log(f"phase 15: {TRAIN_ARCH} trained on a 2x2 mesh, resharded onto an "
        f"elastic 1x2 and trained on, and {MOE_TRAIN_ARCH} trained on 1x2, "
        f"bitwise their one-card grad_accum runs ({time.time() - t0:.1f} s)")

    t0 = time.time()
    dry = dryrun_phase(torch, mem, step, paged_step)
    log(f"phase 16: the dry run held to the card's resident bytes, beside "
        f"its peak and busy time ({time.time() - t0:.1f} s)")

    log(f"card: {card_name(torch)}")
    main_b1 = next(r for r in b1_rows if r["shape"] == "decode wg/wu")
    main_b3 = next(r for r in b3_rows if r["shape"] == "decode wg/wu")
    main_b45 = next(r for r in b45_rows if r["shape"] == "decode wg/wu")
    eval_fwd = {"mgs_matmul_exact_fused": "mgs_exact",
                "mgs_matmul_dmac": "dmac_mgs"}
    by_path = {k: {"group": group_run.get(k, 0),
                   "continuous": launches[k],
                   **{f"group_{c}": runs[c]["launches"][k]
                      for c in ("a", "b", "d")},
                   **{p: fam_launches[p][k] for p in fam_launches},
                   **{p: fleet["launches"][p].get(k, 0)
                      for p in fleet["launches"]},
                   "eval_forward": training["table1"].get(
                       eval_fwd.get(k), {}).get(
                           "launches_per_forward", {}).get(k, 0)}
               for k in launches}
    kernels = [
        dict(name="mgs_matmul_exact_fused", route="cuda",
             source="src/repro_torch/csrc/mgs_matmul.cu",
             replaces="src/repro/kernels/mgs_matmul.py:295",
             launches=launches["mgs_matmul_exact_fused"],
             max_abs_err=b1_err, ms=main_b1["ms"],
             plain_ms=main_b1["plain_ms"], bound_ms=main_b1["bound_ms"],
             bound_by=main_b1["bound_by"],
             library_ms=main_b1["library_ms"],
             launches_by_path=by_path["mgs_matmul_exact_fused"]),
        dict(name="mgs_matmul_exact_fused_stationary", route="cuda",
             source="src/repro_torch/csrc/mgs_matmul.cu",
             replaces="src/repro/kernels/mgs_matmul.py:321",
             launches=launches["mgs_matmul_exact_fused_stationary"],
             max_abs_err=b3_err, ms=main_b3["ms"],
             plain_ms=main_b3["plain_ms"], bound_ms=main_b3["bound_ms"],
             bound_by=main_b3["bound_by"],
             library_ms=main_b3["library_ms"],
             launches_by_path=by_path["mgs_matmul_exact_fused_stationary"]),
        dict(name="mgs_flash_attention", route="cuda",
             source="src/repro_torch/csrc/mgs_attention.cu",
             replaces="src/repro/kernels/mgs_attention.py:246",
             launches=launches["mgs_flash_attention"], max_abs_err=b2_err,
             **b2_row, **b2p_rows, contexts=b2_ctx,
             launches_by_path=by_path["mgs_flash_attention"]),
        dict(name="mgs_matmul_exact", route="cuda",
             source="src/repro_torch/csrc/mgs_matmul.cu",
             replaces="src/repro/kernels/mgs_matmul.py:162",
             launches=runs["b"]["launches"]["mgs_matmul_exact"],
             max_abs_err=b4_err, ms=main_b45["b4_ms"],
             plain_ms=main_b45["b4_plain_ms"],
             bound_ms=main_b45["b4_bound_ms"],
             bound_by=main_b45["b4_bound_by"],
             library_ms=main_b45["library_ms"],
             launches_by_path=by_path["mgs_matmul_exact"]),
        dict(name="mgs_matmul_dmac", route="cuda",
             source="src/repro_torch/csrc/mgs_dmac.cu",
             replaces="src/repro/kernels/mgs_matmul.py:595",
             launches=runs["a"]["launches"]["mgs_matmul_dmac"],
             max_abs_err=b5_err, ms=main_b45["b5_ms"],
             float_entry_ms=main_b45["b5_float_ms"],
             plain_ms=main_b45["b5_plain_ms"],
             bound_ms=main_b45["b5_bound_ms"],
             bound_by=main_b45["b5_bound_by"],
             library_ms=main_b45["library_ms"],
             launches_by_path=by_path["mgs_matmul_dmac"]),
    ]
    part = sharded["timing"]
    shard_cont = sharded["dense"]["continuous"]
    for name, key, replaces, err in (
            ("mgs_matmul_exact_partials", "partials", 295,
             sharded["b1_partials_err"]),
            ("mgs_matmul_stationary_partials", "stationary", 321,
             sharded["b3_partials_err"]),
            ("mgs_matmul_exact_flush", "flush", 295,
             sharded["b1_partials_err"])):
        # the main path of this slice: the continuous engine on the mesh
        kernels.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/mgs_matmul.cu",
            replaces=f"src/repro/kernels/mgs_matmul.py:{replaces}",
            launches=shard_cont["seq"]["run_launches"].get(name, 0),
            max_abs_err=err, ms=part[f"{key}_ms"],
            plain_ms=part[f"{key}_plain_ms"],
            bound_ms=part[f"{'flush' if key == 'flush' else 'partials'}"
                          "_bound_ms"],
            bound_by=part[f"{'flush' if key == 'flush' else 'partials'}"
                          "_bound_by"],
            library_ms=None if key == "flush" else part["library_ms"],
            launches_by_path={
                "sharded_dense": sharded["dense"]["run_launches"].get(name, 0),
                "sharded_moe": sharded["moe"]["run_launches"].get(name, 0),
                "sharded_continuous": shard_cont["seq"]["run_launches"].get(
                    name, 0),
                "sharded_spec": shard_cont["spec"]["run_launches"].get(
                    name, 0)}))
    # phase 17's entries: the main path of this slice, phase 7's group on
    # the mesh; launches of its run under (a) (B5) and (b) (B4)
    pt, served = paper_sharded["timing"], paper_sharded["served"]
    for name, key, source, replaces, err, cfg_key, lib in (
            ("mgs_matmul_dmac_partials", "b5_partials", "mgs_dmac.cu", 595,
             paper_sharded["b5_partials_err"], "a", pt["library_ms"]),
            ("mgs_matmul_dmac_combine", "b5_combine", "mgs_dmac.cu", 595,
             paper_sharded["b5_partials_err"], "a", None),
            ("mgs_matmul_exact_limb_partials", "b4_partials",
             "mgs_matmul.cu", 162, paper_sharded["b4_partials_err"], "b",
             pt["library_ms"])):
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/csrc/{source}",
            replaces=f"src/repro/kernels/mgs_matmul.py:{replaces}",
            launches=served[cfg_key]["run_launches"].get(name, 0),
            max_abs_err=err, ms=pt[f"{key}_ms"],
            plain_ms=pt[f"{key}_plain_ms"], bound_ms=pt[f"{key}_bound_ms"],
            bound_by=pt[f"{key}_bound_by"], library_ms=lib,
            launches_by_path={f"paper_sharded_{k}": served[k][
                "run_launches"].get(name, 0) for k in PAPER_MESH_KEYS}))
    for k in kernels:               # B1's flush closes B4's partials too
        if k["name"] == "mgs_matmul_exact_flush":
            k["launches_by_path"].update(
                {f"paper_sharded_{c}": served[c]["run_launches"].get(
                    k["name"], 0) for c in PAPER_MESH_KEYS})
    for k in kernels[:3]:           # B1, B3, B2 on this slice's main path
        k["launches_by_path"].update(
            sharded_continuous=shard_cont["seq"]["run_launches"].get(
                k["name"], 0),
            sharded_spec=shard_cont["spec"]["run_launches"].get(k["name"], 0))
    log(json.dumps({"b1_shapes": b1_rows, "b3_shapes": b3_rows,
                    "b45_shapes": b45_rows, "serve": stats,
                    "decode_step": step, "continuous": cont,
                    "paged_decode_step": paged_step,
                    "paper_decode_steps": paper_steps,
                    "paper_serve": {k: runs[k]["stats"] for k in runs},
                    "paper_accuracy": accuracy, "calibration": calibration,
                    "families": {k: v for k, v in fam.items()
                                 if not k.endswith("_err")},
                    "late_families": {k: v for k, v in late.items()
                                      if not k.endswith("_err")},
                    "analysis": analysis,
                    "training": {k: v for k, v in training.items()
                                 if not k.endswith("_err")},
                    "fleet": fleet,
                    "sharded": {k: v for k, v in sharded.items()
                                if not k.endswith("_err")},
                    "paper_sharded": {k: v for k, v in paper_sharded.items()
                                      if not k.endswith("_err")},
                    "train_sharded": train_sharded,
                    "dryrun": dry,
                    "layers": args.layers}))
    log(f"total {time.time() - t_all:.1f} s")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
