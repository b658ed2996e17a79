// B1 and B3: the limb-fused exact FP8 matmul over packed codes, in its
// output-stationary (B1) and operand-stationary (B3) loop orders; B4: the
// same exact sum from pre-decomposed int8 limb planes.
//
// B1 replaces the TPU kernel
// src/repro/kernels/mgs_matmul.py::_exact_fused_kernel (schedule="output");
// B3 replaces ::_exact_fused_stationary_kernel (schedule="weight" /
// "activation"); B4 replaces ::_exact_kernel (mgs_matmul_exact_pallas). All
// compute
//
//   out[b] = act(((sum_k x[b] w[b]) * 2^-2(bias+mbits)) * scale + bias_row)
//
// with the K-sum exact: each packed code decodes to a 20-bit fixed-point
// integer split into 3 balanced base-128 limbs; the 9 limb-pair dot products
// accumulate into 5 int32 class sums (a+b) with __dp4a, and every
// flush_period K-steps of block_k the classes are added to a float32 wide
// accumulator in ascending class order (the only rounding of the sum).
// Integer sums do not depend on their order, so B1 and B3 agree bit for bit
// whatever tiles they walk.
//
// What bounds them on an H100: at decode (M = slots, a handful of rows) the
// weight codes are read once and dominate the bytes, so the bound is memory
// (K*N bytes at 3.35 TB/s); at prefill (M >= 64) the 9 limb dots make it
// integer-throughput bound.
//
// B1 is simple: each block owns an output tile of one slice, stages a
// 32-deep K sub-tile of both operands in shared memory, decodes each code
// once per block through a 256-entry code->limbs table into K-packed int8x4
// words (w transposed to K-contiguous), and runs __dp4a from shared memory.
// Three tile shapes keep decode (M <= 4) from wasting rows on padding.
//
// B3 keeps one operand's whole padded-K limb stripe resident in dynamic
// shared memory: a block decodes the stripe of its cached tile once
// (activation-stationary: the tile's rows of x; weight-stationary: the
// tile's columns of w), then sweeps a range of the other operand's tiles,
// streaming them in the same 32-deep sub-tiles as B1 and running __dp4a
// against the resident stripe. The grid is sized from the occupancy the
// stripe allows, so the sweep fills the SMs; at decode under
// activation-stationary each block decodes its 4-row x stripe once instead
// of once per output tile. A stripe larger than the shared-memory budget is
// refused (the wrapper falls back to B1 with a warning, or raises).
// B4 is B1's kernel instantiated with LIMBS = true: the staging step copies
// the limb bytes of 3 planes (x: (3, M, K), w: (3, K, N), K-contiguous words
// for x, 4x4 byte transposes for w) instead of decoding codes through the
// table, and the caller passes no epilogue. Same tiles, same __dp4a class
// sums, same flush cadence: at equal block_k and flush_period B4 gives B1's
// bits. It reads 3 bytes per operand element where B1 reads 1, so at decode
// its bytes bound is 3x B1's (the reference's A/B point).
// None of them overlaps loads with compute or splits K across blocks;
// wgmma s8, TMA pipelining and split-K are later work (see PERF.md).
#include "mgs_common.cuh"

using namespace mgs;

namespace {

constexpr int kBKS = 32;          // K elements staged per sub-step
constexpr int kKW = kBKS / 4;     // packed int8x4 words per sub-step
constexpr int kMaxEdge = 64;      // widest tile edge of any configuration
// Dynamic shared memory left for a B3 stripe: the card's opt-in limit per
// block less the code->limbs table and the streamed operand's staged
// sub-tile. Equals WS_STRIPE_BUDGET_BYTES in kernels/mgs_matmul.py.
constexpr long long kSmemLimit = 232448;
constexpr long long kStripeBudget =
    kSmemLimit - 256 * 4 - 3 * kKW * kMaxEdge * 4;

// 4 consecutive codes of row `row` from column `col` (zero past the edges:
// code 0 is +0.0, exactly the reference's padding).
__device__ __forceinline__ uint32_t load4(const uint8_t* base, int row,
                                          int col, int rows, int cols,
                                          bool vec) {
  if (row >= rows) return 0u;
  const uint8_t* p = base + (long long)row * cols + col;
  if (vec && col + 3 < cols)
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  uint32_t v = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (col + j < cols) v |= uint32_t(__ldg(p + j)) << (8 * j);
  return v;
}

// Rows r0 .. r0+nrows of a row-major (rows, cols) operand, columns
// k0 .. k0+4*nkw, as K-packed limb words: dst[(a * nkw + kw) * nrows + r]
// holds limb a of elements [r0 + r][k0 + 4kw .. k0 + 4kw + 3]. The operand
// is a code matrix decoded through `lut`, or (LIMBS) 3 int8 limb planes
// `plane` bytes apart whose 4-byte runs are the words already.
template <bool LIMBS>
__device__ __forceinline__ void stage_rows(int* dst, int nkw, int nrows,
                                           const uint8_t* base,
                                           long long plane, int r0, int k0,
                                           int rows, int cols, bool vec,
                                           const uint32_t* lut, int tid,
                                           int nt) {
  for (int i = tid; i < nrows * nkw; i += nt) {
    const int m = i / nkw, kw = i % nkw;
    if constexpr (LIMBS) {
#pragma unroll
      for (int a = 0; a < 3; ++a)
        dst[(a * nkw + kw) * nrows + m] = int(
            load4(base + a * plane, r0 + m, k0 + 4 * kw, rows, cols, vec));
    } else {
      const uint32_t c = load4(base, r0 + m, k0 + 4 * kw, rows, cols, vec);
      const uint32_t l0 = lut[c & 255u], l1 = lut[(c >> 8) & 255u];
      const uint32_t l2 = lut[(c >> 16) & 255u], l3 = lut[c >> 24];
#pragma unroll
      for (int a = 0; a < 3; ++a)
        dst[(a * nkw + kw) * nrows + m] = limb_word(l0, l1, l2, l3, a);
    }
  }
}

// Columns c0 .. c0+ncols of a row-major (rows, cols) operand, rows
// k0 .. k0+4*nkw, transposed so each stored word runs along K:
// dst[(a * nkw + kw) * ncols + n] holds limb a of elements
// [k0 + 4kw .. k0 + 4kw + 3][c0 + n]. Read as 4x4 blocks of codes, or
// (LIMBS) of each limb plane's bytes.
template <bool LIMBS>
__device__ __forceinline__ void stage_cols(int* dst, int nkw, int ncols,
                                           const uint8_t* base,
                                           long long plane, int k0, int c0,
                                           int rows, int cols, bool vec,
                                           const uint32_t* lut, int tid,
                                           int nt) {
  const int ng4 = ncols / 4;
  for (int i = tid; i < nkw * ng4; i += nt) {
    const int kw = i / ng4, ng = i % ng4;
    uint32_t r[4];
    if constexpr (LIMBS) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          r[j] = load4(base + a * plane, k0 + 4 * kw + j, c0 + 4 * ng, rows,
                       cols, vec);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          dst[(a * nkw + kw) * ncols + 4 * ng + cc] =
              limb_word(r[0], r[1], r[2], r[3], cc);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r[j] = load4(base, k0 + 4 * kw + j, c0 + 4 * ng, rows, cols, vec);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int sh = 8 * cc;
        const uint32_t l0 = lut[(r[0] >> sh) & 255u];
        const uint32_t l1 = lut[(r[1] >> sh) & 255u];
        const uint32_t l2 = lut[(r[2] >> sh) & 255u];
        const uint32_t l3 = lut[(r[3] >> sh) & 255u];
#pragma unroll
        for (int a = 0; a < 3; ++a)
          dst[(a * nkw + kw) * ncols + 4 * ng + cc] =
              limb_word(l0, l1, l2, l3, a);
      }
    }
  }
}

// One 32-deep sub-step of limb dots. xs / ws point at the sub-step's first
// word; limb plane a of x starts x_plane words later (w_plane for w).
template <int TM, int TN, int THM, int THN>
__device__ __forceinline__ void dot_sub(int (&acc)[kClasses][TM][TN],
                                        const int* xs, int x_plane,
                                        const int* ws, int w_plane, int ty,
                                        int tx) {
  constexpr int BM = TM * THM, BN = TN * THN;
#pragma unroll
  for (int kw = 0; kw < kKW; ++kw) {
    int xa[3][TM], wv[3][TN];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
        xa[a][i] = xs[a * x_plane + kw * BM + ty + i * THM];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        wv[a][j] = ws[a * w_plane + kw * BN + tx + j * THN];
    }
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[a + b][i][j] = __dp4a(xa[a][i], wv[b][j], acc[a + b][i][j]);
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero_tile(int (&acc)[kClasses][TM][TN],
                                          float (&accf)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      accf[i][j] = 0.f;
#pragma unroll
      for (int c = 0; c < kClasses; ++c) acc[c][i][j] = 0;
    }
}

template <int TM, int TN>
__device__ __forceinline__ void flush_tile(int (&acc)[kClasses][TM][TN],
                                           float (&accf)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int cl[kClasses];
#pragma unroll
      for (int c = 0; c < kClasses; ++c) {
        cl[c] = acc[c][i][j];
        acc[c][i][j] = 0;
      }
      accf[i][j] = flush_classes(accf[i][j], cl);
    }
}

// ACTIVATIONS of the twin (kernels/mgs_matmul.py), op for op.
__device__ __forceinline__ float activate(float r, int act) {
  if (act == 1) return r > 0.f ? r : 0.f;  // relu
  if (act == 2) {                           // tanh-approximate gelu
    const float c = 0.7978845834732056f;    // float32(sqrt(2 / pi))
    const float r3 = __fmul_rn(__fmul_rn(r, r), r);
    const float inner = __fmul_rn(c, __fadd_rn(r, __fmul_rn(0.044715f, r3)));
    return __fmul_rn(r, __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(inner))));
  }
  if (act == 3)                             // silu: r * (1 / (1 + exp(-r)))
    return __fmul_rn(r, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-r))));
  return r;
}

// Kernel arguments shared by B1 and B3. scale / bias element [b, n] sits at
// b * *_bs + n * *_ns (a stride of 0 broadcasts).
struct Args {
  const uint8_t* x;
  const uint8_t* w;
  const float* scale;
  const float* bias;
  float* out;
  int M, K, N;
  long long x_bs, w_bs;
  int s_bs, s_ns, b_bs, b_ns;
  int act, block_k, flush_period;
  long long x_plane, w_plane;   // bytes between limb planes (B4 only)
};

// The epilogue of one output tile: act(acc * out_scale * scale + bias).
template <int EB, int MB, int TM, int TN, int THM, int THN>
__device__ __forceinline__ void store_tile(const Args& g,
                                           const float (&accf)[TM][TN],
                                           int bz, int m0, int n0, int ty,
                                           int tx) {
  const float osc = out_scale<EB, MB>();
  float* ob = g.out + (long long)bz * g.M * g.N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * THM;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * THN;
      if (n >= g.N) continue;
      float r = __fmul_rn(accf[i][j], osc);
      if (g.scale)
        r = __fmul_rn(r, g.scale[(long long)bz * g.s_bs +
                                 (long long)n * g.s_ns]);
      if (g.bias)
        r = __fadd_rn(r, g.bias[(long long)bz * g.b_bs +
                                (long long)n * g.b_ns]);
      ob[(long long)m * g.N + n] = activate(r, g.act);
    }
  }
}

// B1 (codes) and B4 (LIMBS: limb planes): grid (N tiles, M tiles,
// slices); both operands staged per sub-step.
template <bool LIMBS, int EB, int MB, int TM, int TN, int THM, int THN>
__global__ void __launch_bounds__(THM * THN)
exact_fused_kernel(Args g) {
  constexpr int BM = TM * THM, BN = TN * THN, NT = THM * THN;
  __shared__ uint32_t lut[256];
  __shared__ int sx[3 * kKW * BM];
  __shared__ int sw[3 * kKW * BN];

  const int tid = threadIdx.x;
  const int tx = tid % THN, ty = tid / THN;
  const int bz = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const uint8_t* xb = g.x + bz * g.x_bs;
  const uint8_t* wb = g.w + bz * g.w_bs;
  const bool xvec =
      ((reinterpret_cast<uintptr_t>(xb) | uintptr_t(g.K)) & 3) == 0;
  const bool wvec =
      ((reinterpret_cast<uintptr_t>(wb) | uintptr_t(g.N)) & 3) == 0;
  if (!LIMBS) fill_lut<EB, MB>(lut, tid, NT);

  int acc[kClasses][TM][TN];
  float accf[TM][TN];
  zero_tile(acc, accf);

  const int nsteps = (g.K + g.block_k - 1) / g.block_k;
  const int subs = g.block_k / kBKS;
  __syncthreads();
  for (int s = 0; s < nsteps; ++s) {
    for (int u = 0; u < subs; ++u) {
      const int k0 = s * g.block_k + u * kBKS;
      stage_rows<LIMBS>(sx, kKW, BM, xb, g.x_plane, m0, k0, g.M, g.K, xvec,
                        lut, tid, NT);
      stage_cols<LIMBS>(sw, kKW, BN, wb, g.w_plane, k0, n0, g.K, g.N, wvec,
                        lut, tid, NT);
      __syncthreads();
      dot_sub<TM, TN, THM, THN>(acc, sx, kKW * BM, sw, kKW * BN, ty, tx);
      __syncthreads();
    }
    if ((s + 1) % g.flush_period == 0 || s == nsteps - 1) flush_tile(acc, accf);
  }
  store_tile<EB, MB, TM, TN, THM, THN>(g, accf, bz, m0, n0, ty, tx);
}

// B3: grid (sweep groups, cached tiles, slices). CACHE_W selects the cached
// operand: w's column tile (weight-stationary, sweeping M tiles) or x's row
// tile (activation-stationary, sweeping N tiles). The stripe holds the
// cached tile's whole padded K as limb words, [3][Kp / 4][tile edge].
template <int EB, int MB, int TM, int TN, int THM, int THN, bool CACHE_W>
__global__ void __launch_bounds__(THM * THN)
exact_fused_stationary_kernel(Args g, int per) {
  constexpr int BM = TM * THM, BN = TN * THN, NT = THM * THN;
  constexpr int BS = CACHE_W ? BM : BN;   // the streamed operand's edge
  __shared__ uint32_t lut[256];
  __shared__ int stage[3 * kKW * BS];
  extern __shared__ int stripe[];

  const int tid = threadIdx.x;
  const int tx = tid % THN, ty = tid / THN;
  const int bz = blockIdx.z;
  const uint8_t* xb = g.x + bz * g.x_bs;
  const uint8_t* wb = g.w + bz * g.w_bs;
  const bool xvec =
      ((reinterpret_cast<uintptr_t>(xb) | uintptr_t(g.K)) & 3) == 0;
  const bool wvec =
      ((reinterpret_cast<uintptr_t>(wb) | uintptr_t(g.N)) & 3) == 0;
  const int nsteps = (g.K + g.block_k - 1) / g.block_k;
  const int subs = g.block_k / kBKS;
  const int kwp = nsteps * g.block_k / 4;   // stripe words along K
  const int c0 = blockIdx.y * (CACHE_W ? BN : BM);
  const int nsweep = CACHE_W ? (g.M + BM - 1) / BM : (g.N + BN - 1) / BN;
  const int t0 = blockIdx.x * per;
  const int t1 = min(nsweep, t0 + per);
  fill_lut<EB, MB>(lut, tid, NT);
  __syncthreads();

  // decode the cached tile's stripe once (zero past M, N and K)
  if (CACHE_W)
    stage_cols<false>(stripe, kwp, BN, wb, 0, 0, c0, g.K, g.N, wvec, lut, tid,
                      NT);
  else
    stage_rows<false>(stripe, kwp, BM, xb, 0, c0, 0, g.M, g.K, xvec, lut, tid,
                      NT);

  int acc[kClasses][TM][TN];
  float accf[TM][TN];
  for (int t = t0; t < t1; ++t) {
    const int m0 = CACHE_W ? t * BM : c0;
    const int n0 = CACHE_W ? c0 : t * BN;
    zero_tile(acc, accf);
    for (int s = 0; s < nsteps; ++s) {
      for (int u = 0; u < subs; ++u) {
        const int k0 = s * g.block_k + u * kBKS;
        if (CACHE_W)
          stage_rows<false>(stage, kKW, BM, xb, 0, m0, k0, g.M, g.K, xvec,
                            lut, tid, NT);
        else
          stage_cols<false>(stage, kKW, BN, wb, 0, k0, n0, g.K, g.N, wvec,
                            lut, tid, NT);
        __syncthreads();   // also publishes the stripe on the first pass
        if (CACHE_W)
          dot_sub<TM, TN, THM, THN>(acc, stage, kKW * BM,
                                    stripe + (k0 / 4) * BN, kwp * BN, ty, tx);
        else
          dot_sub<TM, TN, THM, THN>(acc, stripe + (k0 / 4) * BM, kwp * BM,
                                    stage, kKW * BN, ty, tx);
        __syncthreads();
      }
      if ((s + 1) % g.flush_period == 0 || s == nsteps - 1)
        flush_tile(acc, accf);
    }
    store_tile<EB, MB, TM, TN, THM, THN>(g, accf, bz, m0, n0, ty, tx);
  }
}

template <bool LIMBS, int EB, int MB, int TM, int TN, int THM, int THN>
int launch(const Args& g, int Bt, int cache_weight, cudaStream_t stream) {
  constexpr int BM = TM * THM, BN = TN * THN, NT = THM * THN;
  if (LIMBS || cache_weight < 0) {   // B1, B4
    dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM, Bt);
    exact_fused_kernel<LIMBS, EB, MB, TM, TN, THM, THN>
        <<<grid, NT, 0, stream>>>(g);
    return int(cudaGetLastError());
  }
  const bool cw = cache_weight != 0;
  auto kern = cw ? exact_fused_stationary_kernel<EB, MB, TM, TN, THM, THN, true>
                 : exact_fused_stationary_kernel<EB, MB, TM, TN, THM, THN, false>;
  const long long kp = (long long)((g.K + g.block_k - 1) / g.block_k) * g.block_k;
  const long long smem = 3 * kp * (cw ? BN : BM);
  if (smem > kStripeBudget) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kStripeBudget));
  if (err != cudaSuccess) return int(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return int(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return int(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, NT, size_t(smem))) != cudaSuccess)
    return int(err);
  const long long cached = cw ? (g.N + BN - 1) / BN : (g.M + BM - 1) / BM;
  const long long nsweep = cw ? (g.M + BM - 1) / BM : (g.N + BN - 1) / BN;
  if (cached > 65535 || Bt > 65535) return int(cudaErrorInvalidConfiguration);
  // as many sweep groups as keep every SM at its occupancy, each group a
  // contiguous range of `per` tiles
  const long long slots = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  long long groups = slots / (cached * Bt);
  groups = groups < 1 ? 1 : (groups > nsweep ? nsweep : groups);
  const long long per = (nsweep + groups - 1) / groups;
  groups = (nsweep + per - 1) / per;
  const dim3 grid{static_cast<unsigned>(groups), static_cast<unsigned>(cached),
                  static_cast<unsigned>(Bt)};
  kern<<<grid, NT, size_t(smem), stream>>>(g, int(per));
  return int(cudaGetLastError());
}

// The card's tile for M rows (tile_shape() in kernels/mgs_matmul.py).
template <bool LIMBS, int EB, int MB>
int launch_fmt(const Args& g, int Bt, int cache_weight, cudaStream_t stream) {
  if (g.M <= 4)        // decode: 4 rows, one output column per thread
    return launch<LIMBS, EB, MB, 4, 1, 1, 64>(g, Bt, cache_weight, stream);
  if (g.M <= 16)
    return launch<LIMBS, EB, MB, 4, 2, 4, 32>(g, Bt, cache_weight, stream);
  return launch<LIMBS, EB, MB, 4, 4, 16, 16>(g, Bt, cache_weight, stream);
}

int dispatch(const void* x, const void* w, const void* scale, const void* bias,
             void* out, int Bt, int M, int K, int N, long long x_bs,
             long long w_bs, int s_bs, int s_ns, int b_bs, int b_ns, int fmt,
             int act, int block_k, int flush_period, int cache_weight,
             void* stream) {
  Args g{static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(w),
         static_cast<const float*>(scale), static_cast<const float*>(bias),
         static_cast<float*>(out), M, K, N, x_bs, w_bs, s_bs, s_ns, b_bs,
         b_ns, act, block_k, flush_period, 0, 0};
  auto st = static_cast<cudaStream_t>(stream);
  return fmt == 0 ? launch_fmt<false, 4, 3>(g, Bt, cache_weight, st)
                  : launch_fmt<false, 3, 4>(g, Bt, cache_weight, st);
}

}  // namespace

// C interface (ctypes). x: (Bt, M, K) u8 codes, w: (Bt, K, N) u8 codes (or
// one shared (K, N) with w_bs = 0), out: (Bt, M, N) f32. scale / bias may be
// null; element [b, n] of each sits at b * *_bs + n * *_ns (a stride of 0
// broadcasts). fmt: 0 = E4M3, 1 = E3M4. act: 0 none, 1 relu, 2 gelu, 3 silu.
// block_k must be a multiple of 32; flush_period is already clamped to
// [1, ceil(K / block_k)]. Each returns cudaGetLastError() after the launch.
extern "C" int mgs_matmul_exact_fused(
    const void* x, const void* w, const void* scale, const void* bias,
    void* out, int Bt, int M, int K, int N, long long x_bs, long long w_bs,
    int s_bs, int s_ns, int b_bs, int b_ns, int fmt, int act, int block_k,
    int flush_period, void* stream) {
  return dispatch(x, w, scale, bias, out, Bt, M, K, N, x_bs, w_bs, s_bs, s_ns,
                  b_bs, b_ns, fmt, act, block_k, flush_period, -1, stream);
}

// B3, the same arguments plus cache_weight (1 = weight-stationary, 0 =
// activation-stationary). Refuses (cudaErrorInvalidValue) a stripe over
// mgs_matmul_stripe_budget() bytes.
extern "C" int mgs_matmul_exact_fused_stationary(
    const void* x, const void* w, const void* scale, const void* bias,
    void* out, int Bt, int M, int K, int N, long long x_bs, long long w_bs,
    int s_bs, int s_ns, int b_bs, int b_ns, int fmt, int act, int block_k,
    int flush_period, int cache_weight, void* stream) {
  return dispatch(x, w, scale, bias, out, Bt, M, K, N, x_bs, w_bs, s_bs, s_ns,
                  b_bs, b_ns, fmt, act, block_k, flush_period,
                  cache_weight ? 1 : 0, stream);
}

extern "C" long long mgs_matmul_stripe_budget() { return kStripeBudget; }

// B4. x: (Bt, 3, M, K) int8 limb planes (x_bs = 3 * M * K), w: (Bt, 3, K, N)
// (or one shared (3, K, N) with w_bs = 0), out: (Bt, M, N) f32 =
// (sum_k x w) * 2^-2(bias+mbits), no epilogue. fmt, block_k and
// flush_period as above.
extern "C" int mgs_matmul_exact(const void* x, const void* w, void* out,
                                int Bt, int M, int K, int N, long long x_bs,
                                long long w_bs, int fmt, int block_k,
                                int flush_period, void* stream) {
  Args g{static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(w),
         nullptr, nullptr, static_cast<float*>(out), M, K, N, x_bs, w_bs, 0,
         0, 0, 0, 0, block_k, flush_period, (long long)M * K,
         (long long)K * N};
  auto st = static_cast<cudaStream_t>(stream);
  return fmt == 0 ? launch_fmt<true, 4, 3>(g, Bt, -1, st)
                  : launch_fmt<true, 3, 4>(g, Bt, -1, st);
}
