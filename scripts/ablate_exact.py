#!/usr/bin/env python3
"""Where B1's, B3's and B4's time goes on one GPU: a phase ablation.

    python3 scripts/ablate_exact.py

Builds variants of ``src/repro_torch/csrc/mgs_matmul.cu`` in a temporary
directory, each with one phase of ``exact_body`` taken out, and times B1
(codes), B3 (activation-stationary, at the decode shapes) and B4 (limb
planes) through the C interface at decode and prefill shapes (``chip_smoke.time_ms``: median per-call device time, queue kept
full; two weight copies). The variants compute wrong values: only their
times are read. Prints one JSON line ``{"card", "rows"}``.

Variants: ``full``; ``no_convert`` (stages land, no limb fragments are
built); ``no_mma``; ``loads_only`` (neither); ``no_loads`` (convert and mma
over whatever the ring holds); ``no_lut`` (B1's table lookups replaced by
arithmetic of the same shape); ``tail_only`` (no K loop: launch, split-K
arrival and the last split's flush); ``empty`` (the launch alone).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CU = ROOT / "src" / "repro_torch" / "csrc" / "mgs_matmul.cu"

CONVERT = ("      convert<LIMBS, T, CACHE>(smem + (u % L::STAGES) * L::STAGE, "
           "fa, fb,\n                               rep, tid);\n")
MMA = ("        mma_step<T, L::RES_B>(acc, src_a, pa, L::RES_A ? kr : ks, "
       "src_b, pb,\n                              L::RES_B ? kr : ks, live, "
       "ya, yb, lane);\n")
LOAD = "load_stage<LIMBS, T, CACHE>("
LUT = ("  for (int j = 0; j < 4; ++j) l[j] = rep[(code[j] << 5) | "
       "uint32_t(lane)];\n")
NST = "  const int nst = k1 > k0 ? (k1 - k0 + kRK - 1) / kRK : 0;\n"
START = "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
VARIANTS = {
    "full": [],
    "no_convert": [(CONVERT, "")],
    "no_mma": [(MMA, "")],
    "loads_only": [(CONVERT, ""), (MMA, "")],
    "no_loads": [(LOAD, "if (false) " + LOAD)],
    "no_lut": [(LUT, "  for (int j = 0; j < 4; ++j) "
                     "l[j] = code[j] * 0x010101u;\n")],
    "tail_only": [(NST, "  const int nst = 0;\n")],
    "empty": [(START, "  if (g.M > 0) return;\n" + START)],
}
SHAPES = [("decode wq/wk/wv/wo", 4, 4096, 4096),
          ("decode wg/wu", 4, 4096, 11008),
          ("decode logits", 4, 4096, 102400),
          ("prefill wg/wu", 128, 4096, 11008)]


def build(tmp: Path) -> dict:
    from repro_torch.kernels import _cuda
    src = CU.read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: the kernel no longer has {old!r}")
            text = text.replace(old, new)
        cu, so = tmp / f"{name}.cu", tmp / f"{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL), so)
    libs = {}
    for name, (proc, so) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"{name}: nvcc failed")
        lib = ctypes.CDLL(str(so))
        lib.mgs_matmul_exact_fused.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 8
            + [ctypes.c_void_p, ctypes.c_longlong] * 2 + [ctypes.c_void_p])
        lib.mgs_matmul_exact_fused_stationary.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 9
            + [ctypes.c_void_p, ctypes.c_longlong] * 2 + [ctypes.c_void_p])
        lib.mgs_matmul_exact.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
            + [ctypes.c_void_p, ctypes.c_longlong] * 2 + [ctypes.c_void_p])
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ablate_exact: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev)
        gen.manual_seed(cs.SEED)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rows = []
        for shape, M, K, N in SHAPES:
            x = cs.fp8_codes(torch, (M, K), dev, gen)
            ws = [cs.fp8_codes(torch, (K, N), dev, gen) for _ in range(2)]
            xl = torch.randint(-64, 64, (3, M, K), dtype=torch.int8,
                               device=dev, generator=gen)
            wl = [torch.randint(-64, 64, (3, K, N), dtype=torch.int8,
                                device=dev, generator=gen) for _ in range(2)]
            out = torch.empty(M, N, device=dev)
            # room for any split of these shapes; the kernels zero it again
            wsp = torch.zeros(5 * M * N * (K // 32), dtype=torch.int32,
                              device=dev)
            cnt = torch.zeros(-(-N // 128), dtype=torch.int32, device=dev)
            tail = [wsp.data_ptr(), wsp.numel(), cnt.data_ptr(), cnt.numel(),
                    stream]
            for name, lib in libs.items():
                it = iter(range(10**9))

                def b1():
                    err = lib.mgs_matmul_exact_fused(
                        x.data_ptr(), ws[next(it) % 2].data_ptr(), None,
                        None, out.data_ptr(), 1, M, K, N, M * K, 0, 0, 0, 0,
                        0, 0, 0, 128, 32, *tail)
                    assert err == 0, err

                def b3():
                    err = lib.mgs_matmul_exact_fused_stationary(
                        x.data_ptr(), ws[next(it) % 2].data_ptr(), None,
                        None, out.data_ptr(), 1, M, K, N, M * K, 0, 0, 0, 0,
                        0, 0, 0, 128, 32, 0, *tail)
                    assert err == 0, err

                def b4():
                    err = lib.mgs_matmul_exact(
                        xl.data_ptr(), wl[next(it) % 2].data_ptr(),
                        out.data_ptr(), 1, M, K, N, 3 * M * K, 0, 0, 128, 32,
                        *tail)
                    assert err == 0, err
                row = dict(shape=shape, M=M, K=K, N=N, variant=name,
                           b1_ms=cs.time_ms(torch, b1, 20),
                           b3_ms=(cs.time_ms(torch, b3, 20) if M <= 16
                                  else None),
                           b4_ms=cs.time_ms(torch, b4, 20))
                rows.append(row)
                b3_txt = "-" if row["b3_ms"] is None else \
                    f"{row['b3_ms']:.4f}"
                print(f"{shape:20s} {name:11s} B1 {row['b1_ms']:.4f} ms  "
                      f"B3 {b3_txt} ms  B4 {row['b4_ms']:.4f} ms",
                      flush=True)
                wsp.zero_()    # a variant may leave partials behind
                cnt.zero_()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps({"card": smi.stdout.strip(), "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
