// B1: the streaming limb-fused exact FP8 matmul over packed codes.
//
// Replaces the TPU kernel src/repro/kernels/mgs_matmul.py::_exact_fused_kernel
// (launched by mgs_matmul_exact_fused_pallas, schedule="output").
//
//   out[b] = act(((sum_k x[b] w[b]) * 2^-2(bias+mbits)) * scale + bias_row)
//
// with the K-sum exact: each packed code decodes to a 20-bit fixed-point
// integer split into 3 balanced base-128 limbs; the 9 limb-pair dot products
// accumulate into 5 int32 class sums (a+b) with __dp4a, and every
// flush_period K-steps of block_k the classes are added to a float32 wide
// accumulator in ascending class order (the only rounding of the sum).
//
// What bounds it on an H100: at decode (M = batch, a handful of rows) the
// weight codes are read once and dominate the bytes, so the bound is memory
// (K*N bytes at 3.35 TB/s); at prefill (M = 128) the 9 limb dots make it
// integer-throughput bound. This first design is simple: each block owns an
// output tile of one slice, stages a 32-deep K sub-tile of both operands in
// shared memory, decodes each code once per block through a 256-entry
// code->limbs table into K-packed int8x4 words (w transposed to
// K-contiguous), and runs __dp4a from shared memory. Three tile shapes keep
// decode (M <= 4) from wasting rows on padding. It neither overlaps loads
// with compute nor splits K across blocks, so decode leaves most SMs idle;
// wgmma s8, TMA pipelining and split-K are later work (see PERF.md).
#include "mgs_common.cuh"

using namespace mgs;

namespace {

constexpr int kBKS = 32;          // K elements staged per sub-step
constexpr int kKW = kBKS / 4;     // packed int8x4 words per sub-step

// 4 consecutive codes of row `row` from column `col` (zero past the edges:
// code 0 is +0.0, exactly the reference's padding).
__device__ __forceinline__ uint32_t load4(const uint8_t* base, int row,
                                          int col, int rows, int cols,
                                          bool vec) {
  if (row >= rows) return 0u;
  const uint8_t* p = base + (long long)row * cols + col;
  if (vec && col + 3 < cols) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t v = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (col + j < cols) v |= uint32_t(p[j]) << (8 * j);
  return v;
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

template <int EB, int MB, int TM, int TN, int THM, int THN>
__global__ void __launch_bounds__(THM * THN)
exact_fused_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int M, int K, int N, long long x_bs, long long w_bs,
                   int s_bs, int s_ns, int b_bs, int b_ns, int act,
                   int block_k, int flush_period) {
  constexpr int BM = TM * THM, BN = TN * THN, NT = THM * THN;
  __shared__ uint32_t lut[256];
  __shared__ int sx[3][kKW][BM];
  __shared__ int sw[3][kKW][BN];

  const int tid = threadIdx.x;
  const int tx = tid % THN, ty = tid / THN;
  const int bz = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const uint8_t* xb = x + bz * x_bs;
  const uint8_t* wb = w + bz * w_bs;
  const bool xvec = ((reinterpret_cast<uintptr_t>(xb) | uintptr_t(K)) & 3) == 0;
  const bool wvec = ((reinterpret_cast<uintptr_t>(wb) | uintptr_t(N)) & 3) == 0;
  fill_lut<EB, MB>(lut, tid, NT);

  int acc[kClasses][TM][TN];
  float accf[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      accf[i][j] = 0.f;
#pragma unroll
      for (int c = 0; c < kClasses; ++c) acc[c][i][j] = 0;
    }

  const int nsteps = (K + block_k - 1) / block_k;
  const int subs = block_k / kBKS;
  __syncthreads();
  for (int s = 0; s < nsteps; ++s) {
    for (int u = 0; u < subs; ++u) {
      const int k0 = s * block_k + u * kBKS;
      // x tile: BM rows x kKW words, 4 codes along K per word
      for (int i = tid; i < BM * kKW; i += NT) {
        const int m = i / kKW, kw = i % kKW;
        const uint32_t c = load4(xb, m0 + m, k0 + 4 * kw, M, K, xvec);
        const uint32_t l0 = lut[c & 255u], l1 = lut[(c >> 8) & 255u];
        const uint32_t l2 = lut[(c >> 16) & 255u], l3 = lut[c >> 24];
#pragma unroll
        for (int a = 0; a < 3; ++a) sx[a][kw][m] = limb_word(l0, l1, l2, l3, a);
      }
      // w tile: 4x4 code blocks (4 K rows x 4 columns), transposed so each
      // stored word runs along K
      for (int i = tid; i < kKW * (BN / 4); i += NT) {
        const int kw = i / (BN / 4), ng = i % (BN / 4);
        uint32_t r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          r[j] = load4(wb, k0 + 4 * kw + j, n0 + 4 * ng, K, N, wvec);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int sh = 8 * cc;
          const uint32_t l0 = lut[(r[0] >> sh) & 255u];
          const uint32_t l1 = lut[(r[1] >> sh) & 255u];
          const uint32_t l2 = lut[(r[2] >> sh) & 255u];
          const uint32_t l3 = lut[(r[3] >> sh) & 255u];
#pragma unroll
          for (int a = 0; a < 3; ++a)
            sw[a][kw][4 * ng + cc] = limb_word(l0, l1, l2, l3, a);
        }
      }
      __syncthreads();
#pragma unroll
      for (int kw = 0; kw < kKW; ++kw) {
        int xa[3][TM], wv[3][TN];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
          for (int i = 0; i < TM; ++i) xa[a][i] = sx[a][kw][ty + i * THM];
#pragma unroll
          for (int j = 0; j < TN; ++j) wv[a][j] = sw[a][kw][tx + j * THN];
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
      __syncthreads();
    }
    if ((s + 1) % flush_period == 0 || s == nsteps - 1) {
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
  }

  const float osc = out_scale<EB, MB>();
  float* ob = out + (long long)bz * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * THM;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * THN;
      if (n >= N) continue;
      float r = __fmul_rn(accf[i][j], osc);
      if (scale) r = __fmul_rn(r, scale[(long long)bz * s_bs + (long long)n * s_ns]);
      if (bias) r = __fadd_rn(r, bias[(long long)bz * b_bs + (long long)n * b_ns]);
      ob[(long long)m * N + n] = activate(r, act);
    }
  }
}

template <int EB, int MB, int TM, int TN, int THM, int THN>
void launch(const uint8_t* x, const uint8_t* w, const float* scale,
            const float* bias, float* out, int Bt, int M, int K, int N,
            long long x_bs, long long w_bs, int s_bs, int s_ns, int b_bs,
            int b_ns, int act, int block_k, int flush_period,
            cudaStream_t stream) {
  constexpr int BM = TM * THM, BN = TN * THN;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, Bt);
  exact_fused_kernel<EB, MB, TM, TN, THM, THN><<<grid, THM * THN, 0, stream>>>(
      x, w, scale, bias, out, M, K, N, x_bs, w_bs, s_bs, s_ns, b_bs, b_ns,
      act, block_k, flush_period);
}

template <int EB, int MB>
void launch_fmt(const uint8_t* x, const uint8_t* w, const float* scale,
                const float* bias, float* out, int Bt, int M, int K, int N,
                long long x_bs, long long w_bs, int s_bs, int s_ns, int b_bs,
                int b_ns, int act, int block_k, int flush_period,
                cudaStream_t stream) {
  if (M <= 4)        // decode: 4 rows, one output column per thread
    launch<EB, MB, 4, 1, 1, 64>(x, w, scale, bias, out, Bt, M, K, N, x_bs,
                                w_bs, s_bs, s_ns, b_bs, b_ns, act, block_k,
                                flush_period, stream);
  else if (M <= 16)
    launch<EB, MB, 4, 2, 4, 32>(x, w, scale, bias, out, Bt, M, K, N, x_bs,
                                w_bs, s_bs, s_ns, b_bs, b_ns, act, block_k,
                                flush_period, stream);
  else
    launch<EB, MB, 4, 4, 16, 16>(x, w, scale, bias, out, Bt, M, K, N, x_bs,
                                 w_bs, s_bs, s_ns, b_bs, b_ns, act, block_k,
                                 flush_period, stream);
}

}  // namespace

// C interface (ctypes). x: (Bt, M, K) u8 codes, w: (Bt, K, N) u8 codes (or
// one shared (K, N) with w_bs = 0), out: (Bt, M, N) f32. scale / bias may be
// null; element [b, n] of each sits at b * *_bs + n * *_ns (a stride of 0
// broadcasts). fmt: 0 = E4M3, 1 = E3M4. act: 0 none, 1 relu, 2 gelu, 3 silu.
// block_k must be a multiple of 32; flush_period is already clamped to
// [1, ceil(K / block_k)]. Returns cudaGetLastError() after the launch.
extern "C" int mgs_matmul_exact_fused(
    const void* x, const void* w, const void* scale, const void* bias,
    void* out, int Bt, int M, int K, int N, long long x_bs, long long w_bs,
    int s_bs, int s_ns, int b_bs, int b_ns, int fmt, int act, int block_k,
    int flush_period, void* stream) {
  auto xs = static_cast<const uint8_t*>(x);
  auto ws = static_cast<const uint8_t*>(w);
  auto sc = static_cast<const float*>(scale);
  auto bi = static_cast<const float*>(bias);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (fmt == 0)
    launch_fmt<4, 3>(xs, ws, sc, bi, o, Bt, M, K, N, x_bs, w_bs, s_bs, s_ns,
                     b_bs, b_ns, act, block_k, flush_period, st);
  else
    launch_fmt<3, 4>(xs, ws, sc, bi, o, Bt, M, K, N, x_bs, w_bs, s_bs, s_ns,
                     b_bs, b_ns, act, block_k, flush_period, st);
  return int(cudaGetLastError());
}
