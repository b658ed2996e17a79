// B5: the paper's dMAC numerics (Fig. 8) as a batched matmul over packed
// FP8 codes.
//
// Replaces the TPU kernel src/repro/kernels/mgs_matmul.py::_dmac_kernel
// (launched by mgs_matmul_dmac_pallas). For every output
//
//   out[b, m, n] = sum over bins e, ascending, of
//                  float(bin_e) * 2^(max(e, 1) - (bias + mbits))
//
// where each exact product x[b, m, k] * w[b, k, n] of two format values is
// RNE-rounded back into the format (saturating; with gate_subnormal,
// products below the smallest subnormal are skipped, §5.3), decomposed into
// a signed mantissa sm and an exponent bin e, and sm is added to the 32-bit
// sum of bin e (wrapping, as the twin's int32 cast does). Bin sums are
// integers, so they do not depend on the order of the K-sum; the one
// float32 combine per output starts from 0.0f and adds the bins in
// ascending order with exact power-of-two scales, each step one rounding
// (-fmad=false, _rn intrinsics). That is the arithmetic of the twin
// kernels/mgs_matmul.py::mgs_matmul_dmac_codes_plain, bit for bit.
//
// What bounds it on an H100: rounding every product has no tensor-core
// form, so the work runs on the CUDA cores, and at every shape of the
// serving path the operations per product, not the bytes, take the time.
// The design spends as few of them as it can:
//
// * Operands are packed uint8 codes (one byte per element, B1's layout).
// * One lookup per product. The rounded product of two format values
//   depends only on the two codes; its sign is the XOR of theirs and a zero
//   operand gives (0, 0), so (|sm|, e) depends only on the two 7-bit
//   magnitude codes. A 128 x 128 table holds it in one byte per pair,
//   (e << (mbits + 1)) | |sm| (|sm| < 2^(mbits+1), e < 2^ebits: 8 bits in
//   every format). dmac_table_kernel builds it once per (device, format, gate)
//   with round_decompose (mgs_common.cuh), so the rounding stays
//   independent of the CPU twin; each block copies it into shared memory.
//   Staged keys put a magnitude code at bits [7, 14) (x) or [0, 7) (w) and
//   the sign at bit 31, so xk ^ wk holds the table index in its low 14
//   bits and the product's sign in its top bit. The lanes of a warp are
//   output columns and the x key is uniform across the warp, so the 32
//   lookups of a step fall in one 128-byte table row: no bank conflicts.
// * Bins without compare-and-select. Each thread's bins live in shared
//   memory, laid out [row][bin][thread] so that the 32 lanes of a warp hit
//   32 banks; a product costs one shared atomic add (the thread owns its
//   slots, so it never contends) instead of 2 x n_bins selects in
//   registers.
// * Staging: K tiles of 128 codes are loaded into registers one tile ahead
//   of the compute and turned into keys as they are stored.
//
// A block owns TM * RG rows x 32 columns of one slice and runs 256 threads.
// A warp is one row group (TM rows x 32 columns: one column per lane); the
// 8 / RG warps of a row group split each K tile between them, so decode
// (RG = 1) keeps 8 warps busy on a 4-row tile. At the end the block adds
// the K-split warps' bins (unsigned, exact mod 2^32 in any order) and
// combines each output once.
#include "mgs_common.cuh"

using namespace mgs;

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 32;          // output columns per block, one per lane
constexpr int kBK = 128;           // K elements staged per step
constexpr int kTable = 128 * 128;  // (x magnitude code, w magnitude code)

// rows per thread: 4, or 2 where 32 bins would take 128 KB
template <class F>
__host__ __device__ constexpr int tile_rows() {
  return F::n_bins > 16 ? 2 : 4;
}

template <class F, int RG>
constexpr int smem_bytes() {
  return 4 * (tile_rows<F>() * F::n_bins * kThreads      // bins
              + kBK * tile_rows<F>() * RG + kBK * kCols)  // staged keys
         + kTable;
}

// value of a magnitude code (formats.decode_bits of a code < 128)
template <class F>
__device__ __forceinline__ float mag_value(int code) {
  const int frac = code & ((1 << F::MB) - 1);
  const int e = code >> F::MB;
  const int mag = e > 0 ? frac + (1 << F::MB) : frac;
  return __fmul_rn(float(mag), pow2f((e > 1 ? e : 1) - (F::bias + F::MB)));
}

template <class F>
__global__ void dmac_table_kernel(uint8_t* __restrict__ tbl, int gate) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kTable) return;
  int e;
  const int sm = round_decompose<F>(
      __fmul_rn(mag_value<F>(i >> 7), mag_value<F>(i & 127)), gate != 0, e);
  tbl[i] = uint8_t((e << (F::MB + 1)) | sm);
}

__device__ __forceinline__ uint32_t x_key(uint32_t c) {
  return ((c & 0x7fu) << 7) | ((c & 0x80u) << 24);
}

__device__ __forceinline__ uint32_t w_key(uint32_t c) {
  return (c & 0x7fu) | ((c & 0x80u) << 24);
}

template <class F, int RG>
__global__ void __launch_bounds__(kThreads, 2)
dmac_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
            const uint8_t* __restrict__ table, float* __restrict__ out, int M,
            int K, int N, long long x_bs, long long w_bs) {
  constexpr int NB = F::n_bins;
  constexpr int TM = tile_rows<F>();
  constexpr int BM = TM * RG;
  constexpr int KS = kThreads / (32 * RG);   // warps sharing a row group
  constexpr int KPER = kBK / KS;             // K elements per warp and step
  constexpr int XL = (BM * kBK + kThreads - 1) / kThreads;
  constexpr int WL = kBK * kCols / kThreads;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* bins = smem;                     // [TM][NB][kThreads]
  uint32_t* sx = bins + TM * NB * kThreads;  // [kBK][BM] x keys
  uint32_t* sw = sx + kBK * BM;              // [kBK][kCols] w keys
  uint8_t* tbl = reinterpret_cast<uint8_t*>(sw + kBK * kCols);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp % RG, ks = warp / RG;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kCols;
  const uint8_t* xb = x + blockIdx.z * x_bs;
  const uint8_t* wb = w + blockIdx.z * w_bs;

  for (int i = tid; i < kTable / 16; i += kThreads)
    reinterpret_cast<uint4*>(tbl)[i] = reinterpret_cast<const uint4*>(table)[i];
  for (int i = tid; i < TM * NB * kThreads; i += kThreads) bins[i] = 0u;
  static_assert(kThreads * 4 == 1024, "a bin's slots span 1024 bytes");
  const uint32_t tid4 = tid * 4;
  char* bin_row[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
    bin_row[i] = reinterpret_cast<char*>(bins + i * NB * kThreads);

  // one K tile of codes into registers (code 0 past M, N and K: its
  // products are (0, 0), an add of 0 to bin 0); element i of a tile is
  // sx[i] = (k, row) with row fastest, and sw[i] = (k, column)
  uint32_t xr[XL], wr[WL];
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < XL; ++j) {
      const int i = tid + j * kThreads, r = i % BM, k = k0 + i / BM;
      xr[j] = (i < BM * kBK && m0 + r < M && k < K)
                  ? xb[(long long)(m0 + r) * K + k] : 0u;
    }
#pragma unroll
    for (int j = 0; j < WL; ++j) {
      const int i = tid + j * kThreads, c = i % kCols, k = k0 + i / kCols;
      wr[j] = (k < K && n0 + c < N) ? wb[(long long)k * N + n0 + c] : 0u;
    }
  };

  load(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < XL; ++j) {
      const int i = tid + j * kThreads;
      if (i < BM * kBK) sx[i] = x_key(xr[j]);
    }
#pragma unroll
    for (int j = 0; j < WL; ++j) sw[tid + j * kThreads] = w_key(wr[j]);
    __syncthreads();
    if (k0 + kBK < K) load(k0 + kBK);
#pragma unroll 4
    for (int kk = ks * KPER; kk < (ks + 1) * KPER; ++kk) {
      const uint32_t wk = sw[kk * kCols + lane];
      uint32_t xk[TM];
      if constexpr (TM == 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(sx + kk * BM + rg * 4);
        xk[0] = v.x; xk[1] = v.y; xk[2] = v.z; xk[3] = v.w;
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(sx + kk * BM + rg * 2);
        xk[0] = v.x; xk[1] = v.y;
      }
      uint32_t t[TM], sm[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const uint32_t c = xk[i] ^ wk;
        t[i] = tbl[c & 0x3fffu];
        const uint32_t s = uint32_t(int(c) >> 31);   // 0 or all ones
        sm[i] = ((t[i] & ((1u << (F::MB + 1)) - 1)) ^ s) - s;
      }
      // slot (i, e) of this thread at byte offset (i * NB + e) * 1024 +
      // tid * 4: e's bits and tid's do not overlap, so an OR places them.
      uint32_t* slot[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        slot[i] = reinterpret_cast<uint32_t*>(
            bin_row[i] + (((t[i] << (9 - F::MB)) & ((NB - 1) << 10)) | tid4));
#pragma unroll
      for (int i = 0; i < TM; ++i) atomicAdd(slot[i], sm[i]);
    }
    __syncthreads();
  }
  __syncthreads();   // K == 0 runs no tile

  // add the K-split warps' bins, then combine once per output
  for (int o = tid; o < BM * kCols; o += kThreads) {
    const int r = o / kCols, c = o % kCols;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const int g = r / TM, i = r % TM;
    float tot = 0.f;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      uint32_t sum = 0u;
#pragma unroll
      for (int s = 0; s < KS; ++s)
        sum += bins[(i * NB + b) * kThreads + (s * RG + g) * 32 + c];
      tot = __fadd_rn(tot, __fmul_rn(__int2float_rn(int(sum)),
                                     pow2f((b > 1 ? b : 1)
                                           - (F::bias + F::MB))));
    }
    out[(long long)blockIdx.z * M * N + (long long)m * N + n] = tot;
  }
}

template <class F, int RG>
int run(const uint8_t* x, const uint8_t* w, const uint8_t* tbl, float* out,
        int Bt, int M, int K, int N, long long x_bs, long long w_bs,
        cudaStream_t stream) {
  auto kern = dmac_kernel<F, RG>;
  constexpr int smem = smem_bytes<F, RG>();
  // beyond the 48 KB default: set once per instantiation and device
  static std::atomic<bool> attr_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = current_device(dev);
  if (err == cudaSuccess) err = smem_opt_in_once(kern, smem, attr_set, dev);
  if (err != cudaSuccess) return int(err);
  const long long gy = (M + tile_rows<F>() * RG - 1) / (tile_rows<F>() * RG);
  if (gy > 65535 || Bt > 65535) return int(cudaErrorInvalidConfiguration);
  const dim3 grid((N + kCols - 1) / kCols, unsigned(gy), unsigned(Bt));
  kern<<<grid, kThreads, smem, stream>>>(x, w, tbl, out, M, K, N, x_bs, w_bs);
  return int(cudaGetLastError());
}

template <class F>
int launch(const uint8_t* x, const uint8_t* w, const uint8_t* tbl, float* out,
           int Bt, int M, int K, int N, long long x_bs, long long w_bs,
           cudaStream_t stream) {
  // row groups per block: the fewest that cover M, at most 8
  constexpr int TM = tile_rows<F>();
  const int rg = M <= TM ? 1 : M <= 2 * TM ? 2 : M <= 4 * TM ? 4 : 8;
  switch (rg) {
    case 1: return run<F, 1>(x, w, tbl, out, Bt, M, K, N, x_bs, w_bs, stream);
    case 2: return run<F, 2>(x, w, tbl, out, Bt, M, K, N, x_bs, w_bs, stream);
    case 4: return run<F, 4>(x, w, tbl, out, Bt, M, K, N, x_bs, w_bs, stream);
    default: return run<F, 8>(x, w, tbl, out, Bt, M, K, N, x_bs, w_bs, stream);
  }
}

}  // namespace

// C interface (ctypes). fmt: 0 = E4M3 (16 bins), 1 = E5M2 (32), 2 = E3M4
// (8). Each returns cudaGetLastError() after its launch.

// The rounding table of (fmt, gate) into tbl (128 x 128 bytes): entry
// (a, b) = (e << (mbits + 1)) | |sm| of the product of magnitude codes a
// and b.
// gate: nonzero skips products below the smallest subnormal.
extern "C" int mgs_dmac_table(void* tbl, int fmt, int gate, void* stream) {
  auto* t = static_cast<uint8_t*>(tbl);
  auto st = static_cast<cudaStream_t>(stream);
  const int blocks = kTable / kThreads;
  switch (fmt) {
    case 0: dmac_table_kernel<Fmt<4, 3>><<<blocks, kThreads, 0, st>>>(t, gate);
      break;
    case 1: dmac_table_kernel<Fmt<5, 2, true> ><<<blocks, kThreads, 0, st>>>(
        t, gate); break;
    case 2: dmac_table_kernel<Fmt<3, 4>><<<blocks, kThreads, 0, st>>>(t, gate);
      break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// x: (Bt, M, K) uint8 codes (x_bs = M * K, or 0 to share one (M, K)), w:
// (Bt, K, N) (w_bs = K * N, or 0), tbl: the (fmt, gate) table of
// mgs_dmac_table, out: (Bt, M, N) f32.
extern "C" int mgs_matmul_dmac_codes(const void* x, const void* w,
                                     const void* tbl, void* out, int Bt,
                                     int M, int K, int N, long long x_bs,
                                     long long w_bs, int fmt, void* stream) {
  const auto* xp = static_cast<const uint8_t*>(x);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* tp = static_cast<const uint8_t*>(tbl);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 0: return launch<Fmt<4, 3>>(xp, wp, tp, op, Bt, M, K, N, x_bs, w_bs,
                                     st);
    case 1: return launch<Fmt<5, 2, true>>(xp, wp, tp, op, Bt, M, K, N, x_bs,
                                           w_bs, st);
    case 2: return launch<Fmt<3, 4>>(xp, wp, tp, op, Bt, M, K, N, x_bs, w_bs,
                                     st);
    default: return int(cudaErrorInvalidValue);
  }
}
