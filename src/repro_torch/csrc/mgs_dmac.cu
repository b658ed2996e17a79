// B5: the paper's dMAC numerics (Fig. 8) as a batched matmul.
//
// Replaces the TPU kernel src/repro/kernels/mgs_matmul.py::_dmac_kernel
// (launched by mgs_matmul_dmac_pallas). For every output
//
//   out[b, m, n] = sum over bins e, ascending, of
//                  float(bin_e) * 2^(max(e, 1) - (bias + mbits))
//
// where each exact float32 product x[b, m, k] * w[b, k, n] of two
// format-exact values is RNE-rounded back into the format (saturating; with
// gate_subnormal, products below the smallest subnormal are skipped, §5.3),
// decomposed into a signed mantissa sm and an exponent bin e, and sm is added
// to the int32 sum of bin e. Bin sums are integers, so they do not depend on
// the order of the K-sum; the one float32 combine per output starts from 0.0f
// and adds the bins in ascending order with exact power-of-two scales, each
// step one rounding (-fmad=false, _rn intrinsics). That is the arithmetic of
// the twin kernels/mgs_matmul.py::mgs_matmul_dmac_plain, bit for bit.
//
// What bounds it on an H100: rounding every product has no tensor-core form,
// so the work runs on the CUDA cores. Per product this kernel spends ~35
// operations to round and decompose it and 2 per bin on the compare-and-
// select that keeps the bins in registers (16 bins for E4M3); at every shape
// of the serving path that, not the bytes, is what takes the time. PERF.md
// states the bound used beside its time.
//
// Design (simple first): a block owns 4 * RG rows x 32 columns of one slice
// and runs 256 threads. A warp is one row group (4 rows x 32 columns: one
// column per lane, 4 outputs per thread); the 8 / RG warps of a row group
// split each staged K-tile between them, so decode (RG = 1) keeps 8 warps
// busy on a 4-row tile. x and w are staged 32 deep in shared memory. Each
// thread keeps n_bins int32 sums per output in registers through an unrolled
// compare-and-select (a dynamically indexed array would live in local
// memory). At the end the K-split warps add their bins through shared memory
// (integer adds, exact in any order) and the first warp of each row group
// combines. Loads are not overlapped with compute, and fewer operations per
// product (an integer rounding table, bins in shared memory) are later work.
#include "mgs_common.cuh"

using namespace mgs;

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;     // K elements staged per step
constexpr int kCols = 32;   // output columns per block, one per lane
constexpr int kTM = 4;      // output rows per thread

template <class F, int RG>
__global__ void __launch_bounds__(kThreads)
dmac_kernel(const float* __restrict__ x, const float* __restrict__ w,
            float* __restrict__ out, int M, int K, int N, long long x_bs,
            long long w_bs, int gate) {
  constexpr int NB = F::n_bins;
  constexpr int BM = kTM * RG;
  constexpr int KS = kThreads / (32 * RG);   // warps sharing a row group
  constexpr int KPER = kBK / KS;             // K elements per warp and step
  __shared__ float sx[kBK][BM + 1];          // x tile, K-major
  __shared__ float sw[kBK][kCols];
  __shared__ int red[(KS > 1 ? (KS - 1) * RG : 1) * NB * 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp % RG, ks = warp / RG;
  const int bz = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kCols;
  const float* xb = x + bz * x_bs;
  const float* wb = w + bz * w_bs;

  int acc[kTM][NB];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[i][b] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < BM * kBK; i += kThreads) {   // zero past M and K
      const int m = i / kBK, k = i % kBK;
      sx[k][m] = (m0 + m < M && k0 + k < K)
                     ? xb[(long long)(m0 + m) * K + k0 + k] : 0.f;
    }
    for (int i = tid; i < kBK * kCols; i += kThreads) {  // zero past K and N
      const int k = i / kCols, n = i % kCols;
      sw[k][n] = (k0 + k < K && n0 + n < N)
                     ? wb[(long long)(k0 + k) * N + n0 + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = ks * KPER; kk < (ks + 1) * KPER; ++kk) {
      const float wv = sw[kk][lane];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        int e;
        const int sm = round_decompose<F>(
            __fmul_rn(sx[kk][rg * kTM + i], wv), gate != 0, e);
#pragma unroll
        for (int b = 0; b < NB; ++b) acc[i][b] += e == b ? sm : 0;
      }
    }
    __syncthreads();
  }

  // add the K-split warps' bins into the first warp of each row group, one
  // output row at a time, then combine once per output
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    if (KS > 1) {
      if (ks > 0) {
#pragma unroll
        for (int b = 0; b < NB; ++b)
          red[(((ks - 1) * RG + rg) * NB + b) * 32 + lane] = acc[i][b];
      }
      __syncthreads();
      if (ks == 0) {
        for (int s = 0; s < KS - 1; ++s)
#pragma unroll
          for (int b = 0; b < NB; ++b)
            acc[i][b] += red[((s * RG + rg) * NB + b) * 32 + lane];
      }
      __syncthreads();
    }
    const int m = m0 + rg * kTM + i, n = n0 + lane;
    if (ks == 0 && m < M && n < N) {
      float tot = 0.f;
#pragma unroll
      for (int b = 0; b < NB; ++b)
        tot = __fadd_rn(tot, __fmul_rn(__int2float_rn(acc[i][b]),
                                       pow2f((b > 1 ? b : 1)
                                             - (F::bias + F::MB))));
      out[(long long)bz * M * N + (long long)m * N + n] = tot;
    }
  }
}

template <class F>
int launch(const float* x, const float* w, float* out, int Bt, int M, int K,
           int N, long long x_bs, long long w_bs, int gate,
           cudaStream_t stream) {
  // rows per block: 4 at decode, up to 32 when M allows
  const int rg = M <= 4 ? 1 : M <= 8 ? 2 : M <= 16 ? 4 : 8;
  const long long gy = (M + 4 * rg - 1) / (4 * rg);
  if (gy > 65535 || Bt > 65535) return int(cudaErrorInvalidConfiguration);
  const dim3 grid((N + kCols - 1) / kCols, unsigned(gy), unsigned(Bt));
  switch (rg) {
    case 1: dmac_kernel<F, 1><<<grid, kThreads, 0, stream>>>(
        x, w, out, M, K, N, x_bs, w_bs, gate); break;
    case 2: dmac_kernel<F, 2><<<grid, kThreads, 0, stream>>>(
        x, w, out, M, K, N, x_bs, w_bs, gate); break;
    case 4: dmac_kernel<F, 4><<<grid, kThreads, 0, stream>>>(
        x, w, out, M, K, N, x_bs, w_bs, gate); break;
    default: dmac_kernel<F, 8><<<grid, kThreads, 0, stream>>>(
        x, w, out, M, K, N, x_bs, w_bs, gate); break;
  }
  return int(cudaGetLastError());
}

}  // namespace

// C interface (ctypes). x: (Bt, M, K) f32 format-exact values (x_bs = M * K,
// or 0 to share one (M, K)), w: (Bt, K, N) (w_bs = K * N, or 0), out:
// (Bt, M, N) f32. fmt: 0 = E4M3 (16 bins), 1 = E5M2 (32), 2 = E3M4 (8).
// gate: nonzero skips products below the smallest subnormal. Returns
// cudaGetLastError() after the launch.
extern "C" int mgs_matmul_dmac(const void* x, const void* w, void* out,
                               int Bt, int M, int K, int N, long long x_bs,
                               long long w_bs, int fmt, int gate,
                               void* stream) {
  const auto* xp = static_cast<const float*>(x);
  const auto* wp = static_cast<const float*>(w);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 0: return launch<Fmt<4, 3>>(xp, wp, op, Bt, M, K, N, x_bs, w_bs,
                                     gate, st);
    case 1: return launch<Fmt<5, 2, true>>(xp, wp, op, Bt, M, K, N, x_bs,
                                           w_bs, gate, st);
    case 2: return launch<Fmt<3, 4>>(xp, wp, op, Bt, M, K, N, x_bs, w_bs,
                                     gate, st);
    default: return int(cudaErrorInvalidValue);
  }
}
