#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--layers N]

Phases, in order; any failure raises and the script exits non-zero:

1. build both hand-written kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, started together);
2. B1 (exact limb-fused matmul) against its plain twin with
   ``torch.equal`` at the main path's shapes, each with no epilogue, with
   scale + bias and at ``flush_period=1``;
3. B2 (flash-decode attention) against its twin at 128 slices, head dim
   128, chunk 128, ragged lengths up to 1024;
4. serve 8 requests (batch 4, prompt 32, 16 new tokens) through
   ``repro_torch.launch.serve.ServeEngine`` with deepseek-7b at full width
   under ``FP8_MGS_SERVE_KV`` in bf16 (``--layers`` of its 30 layers, all
   by default), counting each kernel's launches; then a reduced model
   served on the GPU and on the CPU (twins) must give the same tokens;
5. time each kernel (median of per-call CUDA-event times) beside its
   twin, a PyTorch yardstick call and its bound; print the card's name
   and power limit, a JSON line of kernel results, and last
   ``{"ok": true, "device": {...}}``.

Needs a CUDA device and the repository's ``src/`` beside this file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core peak
SEED = 0


def log(*a):
    print(*a, flush=True)


def bound(nbytes: float, ops: float):
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Median device time of one call (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    ts = sorted(a.elapsed_time(b) for a, b in ev)
    return ts[len(ts) // 2]


def fp8_codes(torch, shape, dev, gen, scale=1.0):
    """Codes of per-tensor-quantized Gaussian values (weights/activations)."""
    from repro_torch.core.formats import E4M3, encode_bits
    from repro_torch.quant.quantize import quantize_fp8
    x = torch.randn(shape, generator=gen, device=dev) * scale
    return encode_bits(quantize_fp8(x, E4M3).q, E4M3)


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


def check_b1(torch, dev, gen):
    from repro_torch.core.formats import E4M3
    from repro_torch.kernels.mgs_matmul import (
        mgs_matmul_exact_fused, mgs_matmul_exact_fused_plain)
    worst = 0.0
    for name, Bt, M, K, N in B1_SHAPES:
        x = fp8_codes(torch, (Bt, M, K), dev, gen)
        w = fp8_codes(torch, (Bt, K, N), dev, gen)
        scale = torch.rand((Bt, 1, 1), generator=gen, device=dev) * 1e-4
        bias = torch.randn((N,), generator=gen, device=dev)
        for tag, kw in (("none", {}),
                        ("scale+bias", {"scale": scale, "bias": bias}),
                        ("flush_period=1", {"flush_period": 1}),
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


# ---------------------------------------------------------------------------
# phase 3: B2
# ---------------------------------------------------------------------------


def b2_inputs(torch, dev, gen, N=128, T=1, D=128, chunk=128, S=1024):
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
    lengths = torch.randint(0, S + 1, (N,), generator=gen, device=dev)
    lengths[0], lengths[1], lengths[2] = S, 0, 1
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


def check_b2(torch, dev, gen):
    from repro_torch.core.formats import E4M3
    from repro_torch.kernels import mgs_attention as ma
    a = b2_inputs(torch, dev, gen)
    args = [a[k] for k in ("q_codes", "k_pool", "v_pool", "bt", "live",
                           "qk_scale", "v_scale", "bias")]
    out = ma.mgs_flash_blocks(*args, E4M3)
    twin = ma._flash_plain(*args, E4M3)
    torch.cuda.synchronize()
    err = (out - twin).abs().max().item()
    eq = torch.equal(out, twin)
    log(f"B2 128 slices x (1 x 128) over ragged <= 1024 keys, chunk 128: "
        f"equal={eq} max_abs_err={err:.3g}")
    if not eq:
        raise AssertionError("B2 kernel != twin")
    if not torch.isfinite(out).all() or out[1].abs().max().item() != 0.0:
        raise AssertionError("B2 output not finite, or a dead slice is "
                             "not exactly zero")
    return err, a


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------


def serve_full(torch, layers: int):
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.quant import PREP_STATS
    from repro_torch.quant.config import FP8_MGS_SERVE_KV
    import numpy as np
    cfg = dataclasses.replace(get_config("deepseek-7b"), n_layers=layers,
                              quant=FP8_MGS_SERVE_KV)
    log(f"serve: deepseek-7b full width (d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), depth "
        f"{cfg.n_layers} of 30 layers, {cfg.compute_dtype}, "
        f"FP8_MGS_SERVE_KV")
    t0 = time.time()
    eng = ServeEngine(cfg, batch=4, max_len=32 + 16 + 1, seed=SEED)
    torch.cuda.synchronize()
    log(f"serve: random weights + preparation {time.time() - t0:.1f} s, "
        f"PREP_STATS {PREP_STATS}")
    eng.warmup([32], max_new=1)
    rng = np.random.default_rng(SEED)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, 32).astype(
        np.int32), max_new_tokens=16) for i in range(8)]
    prep0 = dict(PREP_STATS)
    reset_launch_counts()
    stats = eng.run(reqs, record_logits=True)
    launches = dict(LAUNCHES)
    logits = stats.pop("logits")
    log(f"serve: stats {stats}")
    log(f"serve: launches during the run {launches}")
    for r in reqs[:2]:
        log(f"serve: req {r.rid} first tokens {r.out_tokens[:10]}")
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {k} was not launched by serving")
    if PREP_STATS != prep0:
        raise AssertionError("serving re-prepared weights")
    if stats["decode_tokens"] != 8 * 16:
        raise AssertionError(f"decode tokens {stats['decode_tokens']}")
    for r in reqs:
        rows = np.stack(logits[r.rid])
        if rows.shape != (16, cfg.vocab) or not np.isfinite(rows).all():
            raise AssertionError(f"request {r.rid} logits {rows.shape} "
                                 "not finite")
        if not all(0 <= t < cfg.vocab for t in r.out_tokens):
            raise AssertionError("token out of range")
    # 2 groups x (prefill: 9 per layer + 1 logits head; 15 decode steps:
    # 7 per layer + 1 logits head for B1, 1 per layer for B2)
    want_b1 = 2 * ((9 * layers + 1) + 15 * (7 * layers + 1))
    want_b2 = 2 * 15 * layers
    if (launches["mgs_matmul_exact_fused"], launches["mgs_flash_attention"]
            ) != (want_b1, want_b2):
        raise AssertionError(f"launch counts {launches} != expected "
                             f"({want_b1}, {want_b2})")
    return launches, stats, eng


def serve_reduced_gpu_vs_cpu(torch):
    """The same reduced model on the card (kernels) and the CPU (twins)."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.models import init_params
    from repro_torch.quant.config import FP8_MGS_SERVE_KV
    import numpy as np
    cfg = dataclasses.replace(reduced_config("deepseek-7b"),
                              compute_dtype="float32",
                              quant=FP8_MGS_SERVE_KV)
    params = init_params(cfg, SEED)
    out = {}
    for dev in ("cuda", "cpu"):
        eng = ServeEngine(cfg, batch=2, max_len=24,
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
    log(f"reduced deepseek-7b (4 layers, f32): GPU kernels and CPU twins "
        f"give equal tokens; max logit diff {worst:.3g}")


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev).clone()


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------


def time_b1(torch, dev, gen):
    """Per-shape times; weights cycle through enough copies to leave L2."""
    from repro_torch.core.formats import E4M3, decode_bits
    from repro_torch.kernels.mgs_matmul import (
        mgs_matmul_exact_fused, mgs_matmul_exact_fused_plain)
    rows = []
    for name, Bt, M, K, N in B1_SHAPES:
        copies = max(1, min(8, -(-200_000_000 // (Bt * K * N))))
        xs = fp8_codes(torch, (Bt, M, K), dev, gen)
        ws = [fp8_codes(torch, (Bt, K, N), dev, gen) for _ in range(copies)]
        scale = torch.full((Bt, 1, 1), 1e-4, device=dev)
        it = iter(range(10**9))

        def kern():
            mgs_matmul_exact_fused(xs, ws[next(it) % copies], E4M3,
                                   scale=scale)

        def plain():
            mgs_matmul_exact_fused_plain(xs, ws[next(it) % copies], E4M3,
                                         scale=scale)
        xv = decode_bits(xs, E4M3)
        wv = [decode_bits(w, E4M3) for w in ws]

        def lib():
            torch.matmul(xv, wv[next(it) % copies])
        ms = time_ms(torch, kern, 20)
        plain_ms = time_ms(torch, plain, 3, warmup=1)
        lib_ms = time_ms(torch, lib, 20)
        nbytes = Bt * M * K + Bt * K * N + Bt * M * N * 4 + Bt * 4
        ops = 9 * 2 * Bt * M * N * K
        b_ms, b_by = bound(nbytes, ops)
        rows.append(dict(shape=name, Bt=Bt, M=M, K=K, N=N, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                         bound_by=b_by))
        log(f"time B1 {name:22s} {Bt}x({M}x{K} @ {K}x{N}): kernel {ms:.4f} "
            f"ms, twin {plain_ms:.4f} ms, torch.matmul f32 {lib_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        del ws, wv
    return rows


def profile_decode_step(torch, eng):
    """Where one decode step's time goes: host-clock step time (median of
    5 unprofiled steps), then one step under ``torch.profiler`` with the
    device time of its GPU events summed by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step, init_cache, prefill
    import numpy as np
    rng = np.random.default_rng(SEED)
    toks = torch.as_tensor(rng.integers(1, eng.cfg.vocab, (eng.batch, 32)),
                           device=eng.device)
    cache = init_cache(eng.cfg, eng.batch, eng.max_len, device=eng.device)
    logits, cache = prefill(eng.params, eng.cfg, {"tokens": toks}, cache)
    walls = []
    for _ in range(6):
        cur = logits.argmax(dim=-1)[:, None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = decode_step(eng.params, eng.cfg, cur, cache)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    step_ms = sorted(walls[1:])[2]
    cur = logits.argmax(dim=-1)[:, None]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode_step(eng.params, eng.cfg, cur, cache)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    by = {"B1": [0.0, 0], "B2": [0.0, 0], "other": [0.0, 0]}
    for e in prof.key_averages():
        us = e.self_device_time_total
        if e.device_type != DeviceType.CUDA or us <= 0:
            continue
        key = ("B1" if "exact_fused_kernel" in e.key else
               "B2" if "flash_kernel" in e.key else "other")
        by[key][0] += us / 1e3
        by[key][1] += e.count
    busy = sum(v[0] for v in by.values())
    row = dict(step_ms=step_ms, profiled_step_ms=prof_wall, device_ms=busy,
               idle_share=(1 - busy / prof_wall) if busy else None,
               **{f"{k}_ms": v[0] for k, v in by.items()},
               **{f"{k}_kernels": v[1] for k, v in by.items()})
    log(f"profile decode step ({eng.cfg.n_layers} layers, batch "
        f"{eng.batch}): {step_ms:.2f} ms unprofiled; profiled "
        f"{prof_wall:.2f} ms with device busy {busy:.2f} ms "
        f"(B1 {by['B1'][0]:.2f} ms in {by['B1'][1]} launches, B2 "
        f"{by['B2'][0]:.2f} ms in {by['B2'][1]}, other {by['other'][0]:.2f}"
        f" ms in {by['other'][1]} kernels)")
    return row


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
    nbytes = (N * T * D + 2 * keys * D + 3 * keys * 4 + N * T * D * 4
              + a["bt"].numel() * 4 + N * 4)
    ops = 2 * 9 * 2 * T * D * keys
    b_ms, b_by = bound(nbytes, ops)
    log(f"time B2 {N} slices x ({T} x {D}), {keys} live keys (chunk "
        f"{chunk}): kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, SDPA f32 "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=30,
                    help="deepseek-7b layers to serve (of 30)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found (run from a "
              "checkout of the repository)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
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
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.time()
    b1_err = check_b1(torch, dev, gen)
    log(f"phase 2: B1 == twin at every shape ({time.time() - t0:.1f} s)")
    t0 = time.time()
    b2_err, b2_args = check_b2(torch, dev, gen)
    log(f"phase 3: B2 == twin ({time.time() - t0:.1f} s)")

    t0 = time.time()
    launches, stats, eng = serve_full(torch, args.layers)
    serve_reduced_gpu_vs_cpu(torch)
    log(f"phase 4: served ({time.time() - t0:.1f} s)")

    t0 = time.time()
    b1_rows = time_b1(torch, dev, gen)
    b2_row = time_b2(torch, b2_args)
    step = profile_decode_step(torch, eng)
    del eng
    log(f"phase 5: timed ({time.time() - t0:.1f} s)")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and \
        smi.stdout.strip() else f"{torch.cuda.get_device_name(0)}, n/a"
    log(f"card: {card}")
    main_b1 = next(r for r in b1_rows if r["shape"] == "decode wg/wu")
    kernels = [
        dict(name="mgs_matmul_exact_fused", route="cuda",
             source="src/repro_torch/csrc/mgs_matmul.cu",
             replaces="src/repro/kernels/mgs_matmul.py:295",
             launches=launches["mgs_matmul_exact_fused"],
             max_abs_err=b1_err, ms=main_b1["ms"],
             plain_ms=main_b1["plain_ms"], bound_ms=main_b1["bound_ms"],
             bound_by=main_b1["bound_by"],
             library_ms=main_b1["library_ms"]),
        dict(name="mgs_flash_attention", route="cuda",
             source="src/repro_torch/csrc/mgs_attention.cu",
             replaces="src/repro/kernels/mgs_attention.py:246",
             launches=launches["mgs_flash_attention"], max_abs_err=b2_err,
             **b2_row),
    ]
    log(json.dumps({"b1_shapes": b1_rows, "serve": stats,
                    "decode_step": step, "layers": args.layers}))
    log(f"total {time.time() - t_all:.1f} s")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
