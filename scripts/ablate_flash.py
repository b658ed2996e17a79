#!/usr/bin/env python3
"""Where B2's time goes on one GPU: a design and phase ablation.

    python3 scripts/ablate_flash.py

Builds variants of ``src/repro_torch/csrc/mgs_attention.cu`` in a temporary
directory, each with one part of the design taken out, and times them
through the C interface on the arguments B2's paged and verify entries pass
(``chip_smoke.b2_paged_case`` / ``b2_kernel_args``: 4 slots x 32 heads,
block 128, every slot at 256 and at 4096 live keys, T = 1 and T = 4 query
rows; and granite-20b's 192 verify rows of one kv head at 4096 keys). Times
are ``chip_smoke.time_ms`` medians (device queue kept full). Variants that
drop work compute wrong values: only their times are read; the others
(``KEEPS_BITS``) are checked against ``full``'s output. Prints one JSON
line ``{"card", "rows"}``.

Variants: ``full``; ``no_split`` (cluster size 1: one block walks all of a
slice's chunks); ``dp4a`` (both contractions on ``__dp4a`` over limb words
instead of ``mma.sync``: a lane pair takes one score or output, each lane
half of its words, summed by a shuffle); ``no_lut`` (the code table lookups
replaced by arithmetic of the same shape); ``no_contractions`` (no mma: the
limb decode feeding it goes too); ``no_scores`` / ``no_softmax`` /
``no_values`` (one phase of a chunk skipped); ``no_fold`` (no in-order fold
of the cluster's partials); ``cluster_4`` (clusters of at most 4);
``one_block_an_sm`` (registers uncapped: launch bounds for one block an
SM); ``empty`` (the launch and the zero rows of a dead slice alone);
``probe`` (``full`` with ``clock64`` reads between its phases: thread 0 of
the first 64 blocks of row tile 0 sums each phase's cycles over its passes;
the script prints the median over those blocks, per pass, beside the
variant's time).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CU = ROOT / "src" / "repro_torch" / "csrc" / "mgs_attention.cu"

LUT = "rep[(((w >> (8 * j)) & 255u) << 5) | uint32_t(lane)]"
VLUT0 = "rep[((w & 255u) << 5) | uint32_t(lane)]"
VLUT1 = "rep[(((w >> 8) & 255u) << 5) | uint32_t(lane)]"
DP4A = r"""
// __dp4a forms of chunk_scores / chunk_values: a lane pair takes one score
// (or output), each lane half of its limb words, summed by a shuffle; the 5
// class sums wrap like mma's.
template <int EB, int MB>
__device__ __forceinline__ void chunk_scores_dp4a(
    const Lay& y, const uint8_t* kt, const uint32_t* rep, const uint32_t* qa,
    float* sc, int D, int chunk, int lr, int lane, int warp) {
  const float osc = out_scale<EB, MB>();
  const int nw = D / 4, h = lane & 1;
  for (int base = warp * 32; base < 2 * lr * chunk; base += kThreads) {
    const int i = (base + lane) >> 1;
    const bool ok = i < lr * chunk;
    const int t = ok ? i / chunk : 0, key = ok ? i % chunk : 0;
    const uint32_t* krow =
        reinterpret_cast<const uint32_t*>(kt + (long long)key * D);
    int cls[kClasses] = {0, 0, 0, 0, 0};
    int dw = (h + key) % nw;  // rotated: a warp's keys meet many banks
    for (int u = h; ok && u < nw; u += 2) {
      uint32_t kl[4];
      decode4(rep, lane, krow[dw], kl);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int qw = int(qa[frag_a(t, dw, a)]);
#pragma unroll
        for (int b = 0; b < 3; ++b)
          cls[a + b] = __dp4a(qw, int(kl[b]), cls[a + b]);
      }
      dw += 2;
      if (dw >= nw) dw -= nw;
    }
#pragma unroll
    for (int cc = 0; cc < kClasses; ++cc)
      cls[cc] = wrap_add(cls[cc], __shfl_xor_sync(0xffffffffu, cls[cc], 1));
    if (ok && h == 0)
      sc[t * y.SCS + key] = __fmul_rn(combine_classes(cls), osc);
  }
}

template <int EB, int MB>
__device__ __forceinline__ void chunk_values_dp4a(
    const Lay& y, const uint8_t* vt, const uint32_t* rep, const uint32_t* pa,
    const float* sp, float* och, int D, int chunk, int lr, int lane,
    int warp) {
  const float osc = out_scale<EB, MB>();
  const int h = lane & 1;
  for (int base = warp * 32; base < 2 * lr * D; base += kThreads) {
    const int i = (base + lane) >> 1;
    const bool ok = i < lr * D;
    const int t = ok ? i / D : 0, d = ok ? i % D : 0;
    int cls[kClasses] = {0, 0, 0, 0, 0};
    for (int kw = h; ok && kw < chunk / 4; kw += 2) {
      const uint8_t* v = vt + (long long)(4 * kw) * D + d;
      uint32_t L[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        L[r] = rep[(uint32_t(v[r * D]) << 5) | uint32_t(lane)];
      int vw[3];
#pragma unroll
      for (int b = 0; b < 3; ++b) vw[b] = limb_word(L[0], L[1], L[2], L[3], b);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int pw = int(pa[frag_a(t, kw, a)]);
#pragma unroll
        for (int b = 0; b < 3; ++b) cls[a + b] = __dp4a(pw, vw[b], cls[a + b]);
      }
    }
#pragma unroll
    for (int cc = 0; cc < kClasses; ++cc)
      cls[cc] = wrap_add(cls[cc], __shfl_xor_sync(0xffffffffu, cls[cc], 1));
    if (ok && h == 0)
      och[t * y.OS + d] =
          __fmul_rn(__fmul_rn(combine_classes(cls), osc), sp[t]);
  }
}

"""
KERNEL = "template <int EB, int MB>\n__global__ void __launch_bounds__"

# clock64 probes: thread 0 adds each phase's cycles into pacc_[k]
PROBE_HEAD = r"""
constexpr int kProbeBlocks = 64;
__device__ long long g_probe[kProbeBlocks * 16];
#define PROBE(k)                                  \
  do {                                            \
    if (threadIdx.x == 0) {                       \
      const long long now_ = clock64();           \
      pacc_[k] += now_ - pt_;                     \
      pt_ = now_;                                 \
    }                                             \
  } while (0)
"""
PROBE_TAIL = r"""
extern "C" int probe_read(long long* h) {
  return int(cudaMemcpyFromSymbol(h, g_probe, sizeof(g_probe)));
}
extern "C" int probe_zero() {
  static long long z[kProbeBlocks * 16] = {};
  return int(cudaMemcpyToSymbol(g_probe, z, sizeof(z)));
}
"""
PHASES = ("setup", "copy wait", "scores", "max", "cluster barrier 1",
          "softmax", "values", "barrier 2", "fold", "output")
END = ("    on[t * D + d] = __fdiv_rn(o_c[t * y.OS + d], fmaxf(l_c[t], "
       "kTiny));\n  }\n}")
PROBES = [
    ("using namespace mgs;\n", "using namespace mgs;\n" + PROBE_HEAD),
    ("  extern __shared__ __align__(128) uint8_t smem[];\n",
     "  extern __shared__ __align__(128) uint8_t smem[];\n"
     "  long long pacc_[10] = {};\n  long long pt_ = clock64();\n"),
    ("  __syncthreads();\n\n  // The softmax takes wpr warps",
     "  __syncthreads();\n  PROBE(0);\n\n  // The softmax takes wpr warps"),
    ("      while (!mbar_try_wait(bar0, uint32_t(p) & 1u)) {\n      }\n",
     "      while (!mbar_try_wait(bar0, uint32_t(p) & 1u)) {\n      }\n"
     "      PROBE(1);\n"),
    ("lr, lane, warp);\n    }\n    __syncthreads();\n",
     "lr, lane, warp);\n    }\n    __syncthreads();\n    PROBE(2);\n"),
    ("    cluster.sync();\n\n    // the prefix maxima",
     "    PROBE(3);\n    cluster.sync();\n    PROBE(4);\n\n"
     "    // the prefix maxima"),
    ("    __syncthreads();\n\n    if (live_j)\n      chunk_values",
     "    __syncthreads();\n    PROBE(5);\n\n    if (live_j)\n"
     "      chunk_values"),
    ("                           warp);\n    __syncthreads();\n",
     "                           warp);\n    __syncthreads();\n"
     "    PROBE(6);\n"),
    ("      issue(j + CL);\n    }\n    cluster.sync();\n",
     "      issue(j + CL);\n    }\n    cluster.sync();\n    PROBE(7);\n"),
    ("      l_c[t] = l;\n    }\n  }\n",
     "      l_c[t] = l;\n    }\n    PROBE(8);\n  }\n"),
    (END, END[:-1] + "  PROBE(9);\n"
     "  if (tid == 0 && rt == 0 && blockIdx.x < kProbeBlocks) {\n"
     "#pragma unroll\n"
     "    for (int k = 0; k < 10; ++k) g_probe[blockIdx.x * 16 + k] = "
     "pacc_[k];\n"
     "    g_probe[blockIdx.x * 16 + 10] = np;\n  }\n}"),
]

VARIANTS = {
    "full": [],
    "no_split": [("constexpr int kMaxCluster = 8;",
                  "constexpr int kMaxCluster = 1;")],
    "dp4a": [(KERNEL, DP4A + KERNEL),
             ("chunk_scores<EB, MB>(y, kt,", "chunk_scores_dp4a<EB, MB>(y, kt,"),
             ("chunk_values<EB, MB>(y, vt,",
              "chunk_values_dp4a<EB, MB>(y, vt,")],
    "no_lut": [(LUT, "(((w >> (8 * j)) & 255u) * 0x010101u)"),
               (VLUT0, "((w & 255u) * 0x010101u)"),
               (VLUT1, "(((w >> 8) & 255u) * 0x010101u)")],
    "no_contractions": [('  asm("mma.sync', '  if (false) asm("mma.sync')],
    "no_scores": [("      chunk_scores<EB, MB>(",
                   "      if (false) chunk_scores<EB, MB>(")],
    "no_softmax": [("        warp_probs(", "        if (false) warp_probs("),
                   ("        requantize<EB, MB>(",
                    "        if (false) requantize<EB, MB>("),
                   ("        p_fragments(", "        if (false) p_fragments(")],
    "no_values": [("      chunk_values<EB, MB>(",
                   "      if (false) chunk_values<EB, MB>(")],
    "no_fold": [("const int nlp = min(CL, nlive - p * CL);",
                 "const int nlp = 0;")],
    "cluster_4": [("constexpr int kMaxCluster = 8;",
                   "constexpr int kMaxCluster = 4;")],
    "one_block_an_sm": [("__launch_bounds__(kThreads, 2)",
                         "__launch_bounds__(kThreads, 1)")],
    "empty": [("  if (np == 0) {  // a dead slice",
               "  if (true) {  // a dead slice")],
    "probe": PROBES,
}
# (label, decode lengths of the 4 slots, kv heads, query rows a kv head)
KEEPS_BITS = ("full", "no_split", "dp4a", "cluster_4", "one_block_an_sm",
              "probe")
CASES = [("256 keys", [256] * 4, 32, 1),
         ("4096 keys", [4096] * 4, 32, 1),
         ("granite-20b, 4096 keys", [4096] * 4, 1, 48)]


def variant_source(name: str) -> str:
    text = CU.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the kernel has {old!r} "
                               f"{text.count(old)} times, not once")
        text = text.replace(old, new)
    return text + (PROBE_TAIL if name == "probe" else "")


def build(tmp: Path) -> dict:
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.mgs_attention import _ARGTYPES
    procs = {}
    for name in VARIANTS:
        cu, so = tmp / f"{name}.cu", tmp / f"{name}.so"
        cu.write_text(variant_source(name))
        procs[name] = (subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL), so)
    libs = {}
    for name, (proc, so) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"{name}: nvcc failed")
        lib = ctypes.CDLL(str(so))
        lib.mgs_flash_attention.argtypes = _ARGTYPES
        libs[name] = lib
    return libs


def probe_cycles(torch, lib, call) -> dict:
    """One launch of the probe variant: per phase, the median over the
    probed blocks of its cycles a pass (setup and output: a block), and
    the median pass count."""
    import numpy as np
    lib.probe_read.argtypes = [ctypes.c_void_p]
    assert lib.probe_zero() == 0
    call()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (64 * 16))()
    assert lib.probe_read(ctypes.addressof(buf)) == 0
    acc = np.frombuffer(buf, dtype=np.int64).reshape(64, 16)
    acc = acc[acc[:, 10] > 0]           # blocks of live slices
    once = (PHASES[0], PHASES[-1])      # once a block, not a pass
    out = {ph: float(np.median(acc[:, k] / (1 if ph in once else
                                             acc[:, 10])))
           for k, ph in enumerate(PHASES)}
    out["passes"] = float(np.median(acc[:, 10]))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ablate_flash: no CUDA device", file=sys.stderr)
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
        for label, lens, kv, r in CASES:
            p = cs.b2_paged_case(torch, dev, gen, lens, KV=kv, R=r)
            T = p["q"].shape[1]
            for entry, t in (("paged", 1), ("verify", T)):
                q, kp, vp, bt, live, qk, vs, bias = cs.b2_kernel_args(
                    torch, p, t)
                N, rows_, D = q.shape
                out = torch.empty(N, rows_, D, device=dev)
                ptrs = [x.data_ptr() for x in (q, kp, vp, bt, live, qk, vs,
                                               bias, out)]
                for name, lib in libs.items():
                    def call():
                        err = lib.mgs_flash_attention(
                            *ptrs, N, rows_, D, kp.shape[1], bt.shape[1],
                            qk.shape[1], 0, stream)
                        assert err == 0, err
                    ms = cs.time_ms(torch, call, 30)
                    same = None
                    if name in KEEPS_BITS:
                        torch.cuda.synchronize()
                        if name == "full":
                            want = out.clone()
                        same = torch.equal(out, want)
                    row = dict(case=label, entry=entry, rows=rows_,
                               variant=name, ms=ms, same_bits=same)
                    if name == "probe":
                        row["cycles_a_pass"] = probe_cycles(torch, lib, call)
                    rows.append(row)
                    print(f"{label:22s} {entry:6s} {rows_:3d} rows "
                          f"{name:15s} {ms:.4f} ms same bits {same}"
                          + (f" {row['cycles_a_pass']}" if name == "probe"
                             else ""), flush=True)
            del p
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps({"card": smi.stdout.strip(), "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
