// B2: exact-MGS flash-decode attention over packed FP8 K/V tiles.
//
// Replaces the TPU kernel src/repro/kernels/mgs_attention.py::_flash_kernel
// (launched by _flash_pallas; entries mgs_flash_attention,
// mgs_paged_flash_attention and mgs_paged_verify_attention).
//
// Each query slice n walks its live chunks j (j * chunk < live[n]) through
// the block table bt[n, :] and runs the online-softmax update of
// _attn_tile_step on each: exact limb dots for q.k^T,
// s = (combine * 2^-2(bias+mbits)) * qk + b, the running max,
// alpha = exp(m - m_new), p = exp(s - m_new), a neighbour-pair tree for the
// denominator, per-row absmax re-quantization of p * v_scale to the cache
// format, exact limb dots for p.v, then l = l * alpha + psum and
// o = o * alpha + o_chunk. Every float step is a separate correctly rounded
// operation (-fmad=false, _rn intrinsics, expf without fast math), and the
// divide by the format's max finite value is a multiply by its float32
// reciprocal, so the kernel equals its PyTorch twin
// (kernels/mgs_attention.py::_flash_plain) bit for bit on the card.
//
// What bounds it on an H100: decode attention reads each live K/V code once
// (2 bytes per cached element and slice) and the score / scale / bias rows;
// with a few query rows it is memory bound. Measured, a block is a chain of
// short dependent phases (copy, scores, max, cluster barrier, softmax,
// values, barrier, fold) that leaves its SM mostly idle, so the design
// puts many chunks in flight at once. The TPU kernel walks a slice's
// chunks in grid order; here
// * the keys are split exactly: chunk j's update depends only on the prefix
//   maxima m_{j-1} and m_j = max(m_{j-1}, max s_j), and max is exact in any
//   order. So the blocks of one thread-block cluster take consecutive
//   chunks (one each per pass), exchange their chunk maxima through
//   distributed shared memory, compute alpha_j, p_j, psum_j, sp_j and
//   o_chunk_j in parallel, and only the fold l_j = l_{j-1} * alpha_j +
//   psum_j, o_j = o_{j-1} * alpha_j + o_chunk_j runs in ascending j (each
//   block folds a slice of the columns, reading the partials of the others
//   from their shared memory). Slices longer than one pass loop and carry
//   (m, l, o); dead chunks take no part but meet every cluster barrier;
//   no table entry past the live prefix is read;
// * each K and V tile (chunk * D contiguous bytes) lands by one bulk
//   asynchronous copy (cp.async.bulk, completing on an mbarrier) into the
//   block's one tile stage; the copy of the block's next chunk starts as
//   soon as this chunk's values are done, while the other block of the SM
//   computes (a second stage, tried, measured no faster); codes stay bytes
//   in shared memory and are decoded to limbs where they are used, through
//   a 256-entry table replicated once per bank;
// * both contractions run on the int8 tensor cores (mma.sync m16n8k32, no
//   .satfinite, int32 class sums that wrap like the twin's): a block takes
//   a tile of 16 query rows (more rows take more blocks); the scores keep
//   the 9 limb-pair products in 9 accumulators (no chained mma), the values
//   in the 5 classes; classes are combined in ascending order;
// * the softmax runs by warps, the rows in parallel, with no block-wide
//   barrier per row: a tile's rows share the 8 warps (a row takes 1 to 8
//   warps), a lane holds a contiguous power-of-two run of keys, the row max
//   and the absmax by __shfl_xor, and the denominator is the same
//   neighbour-pair tree as _pairwise_sum_cols (the lane's run in registers,
//   five levels across lanes, then the row's warps through shared words),
//   zero-padded to 32 * run * warps keys.
#include <cmath>
#include <cooperative_groups.h>

#include "mgs_common.cuh"

namespace cg = cooperative_groups;
using namespace mgs;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;          // query rows of a block: mma's M
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kMaxRun = 16;        // softmax keys a lane holds
constexpr int kMaxChunk = 32 * kMaxRun;
constexpr float kTiny = 1e-30f;
static_assert(kThreads == 256, "the code table is filled one code a thread");

struct Params {
  const uint8_t* q;
  const uint8_t* kp;
  const uint8_t* vp;
  const int* bt;
  const int* live;
  const float* qk;
  const float* vs;
  const float* bias;
  float* out;
  int T, D, chunk, nb, rs;
  int cl;  // blocks of a cluster: chunks a pass takes
};

// Dynamic shared memory of a block (byte offsets, each 128-aligned).
struct Lay {
  int R;      // rows held (min(T, kRows))
  int P;      // keys of the softmax tree: 32 lanes x run, >= chunk
  int SCS;    // score row stride (words)
  int OS;     // output row stride (words)
  int KS;     // q fragment k-steps (32 columns each; 128-column spans)
  int VK;     // value k-steps (32 keys each)
  long long tile;  // bytes of one K (or V) tile
  long long bar, ring, rep, qa, pa, sc, part, part_sz, o, m, l, sp, red,
      bytes;
};

__host__ __device__ inline long long take(long long& off, long long n) {
  const long long at = off;
  off += (n + 127) / 128 * 128;
  return at;
}

__host__ __device__ inline Lay layout(int T, int D, int chunk) {
  Lay y;
  y.R = T < kRows ? T : kRows;
  int p2 = 1;
  while (p2 < chunk) p2 <<= 1;
  y.P = p2 < 32 ? 32 : p2;
  y.SCS = y.P + 4;
  y.OS = D + 1;
  y.KS = 4 * ((D + 127) / 128);
  y.VK = (chunk + 31) / 32;
  y.tile = (long long)chunk * D;
  long long off = 0;
  y.bar = take(off, 8);                          // the tiles' mbarrier
  y.ring = take(off, 2 * y.tile);                // K then V
  y.rep = take(off, 256 * 32 * 4);               // code -> limbs, per bank
  y.qa = take(off, (long long)y.KS * 3 * 128 * 4);   // q limb fragments
  y.pa = take(off, (long long)y.VK * 3 * 128 * 4);   // p limb fragments
  y.sc = take(off, (long long)y.R * y.SCS * 4);      // scores, then limbs
  // the partials other blocks read, two buffers (passes alternate):
  // o_chunk [R][OS], chunk max, alpha, psum [R]
  y.part_sz = ((long long)(y.R * y.OS + 3 * y.R) * 4 + 127) / 128 * 128;
  y.part = take(off, 2 * y.part_sz);
  y.o = take(off, (long long)y.R * y.OS * 4);    // the carried o
  y.m = take(off, y.R * 4);                      // the carried m
  y.l = take(off, y.R * 4);                      // the carried l
  y.sp = take(off, y.R * 4);                     // this chunk's sp
  y.red = take(off, 3 * y.R * kWarps * 4);       // per-warp max, sum, |pv|
  y.bytes = off;
  return y;
}

// _round_decompose_e4m3(y, fmt, gate_subnormal=False) -> sm << max(e, 1)
template <int EB, int MB>
__device__ __forceinline__ int round_decompose_ix(float y) {
  int e;
  const int sm = round_decompose<Fmt<EB, MB>>(y, false, e);
  return sm * (1 << (e > 1 ? e : 1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global memory into this block's shared memory, completing on bar.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// d += a * b: one 16 x 8 x 32 int8 product, s32 sums that wrap.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The limb words of the 4 codes of w (o[a] byte j: limb a of code j), from
// the replicated table: lane l reads replica l, which sits in bank l.
__device__ __forceinline__ void decode4(const uint32_t* rep, int lane,
                                        uint32_t w, uint32_t (&o)[4]) {
  uint32_t l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    l[j] = rep[(((w >> (8 * j)) & 255u) << 5) | uint32_t(lane)];
  transpose4(l, o);
}

// Word of an A fragment store [k-step][limb][lane][register] holding row t,
// K-packed word kw (elements 4 kw .. 4 kw + 3), limb a. mma.m16n8k32 takes
// registers (row g, quad q), (g + 8, q), (g, q + 4), (g + 8, q + 4) in lane
// 4 g + q, so a lane reads its 4 registers as one 16-byte word.
__device__ __forceinline__ int frag_a(int t, int kw, int a) {
  const int qq = kw & 7;
  const int reg = (t >> 3) | ((qq >> 2) << 1);
  const int ln = ((t & 7) << 2) | (qq & 3);
  return ((((kw >> 3) * 3 + a) * 32 + ln) << 2) | reg;
}

__device__ __forceinline__ void load_frag(const uint32_t* f, int ks, int a,
                                          int lane, uint32_t (&r)[4]) {
  const uint4 v = *reinterpret_cast<const uint4*>(f + (((ks * 3 + a) * 32 +
                                                        lane) << 2));
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
  r[3] = v.w;
}

// a + b mod 2^32, as the mma's s32 sums wrap
__device__ __forceinline__ int wrap_add(int a, int b) {
  return int(uint32_t(a) + uint32_t(b));
}

// r[i] <- r[(i - g) & 7]: undo a lane's rotated load order.
__device__ __forceinline__ void unrotate8(uint32_t (&r)[8], int g) {
#pragma unroll
  for (int b = 1; b < 8; b <<= 1) {
    uint32_t t[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) t[i] = (g & b) ? r[(i - b) & 7] : r[i];
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = t[i];
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Raw scores of one chunk: sc[t][key] = combine(q_t . k_key) * out_scale.
// A warp takes 8-key tiles: mma A is the q fragments, B the key rows. Lane
// (g, q) needs words q + 4 i (i = 0..7) of key row g in each 128-column
// span; it loads them in the order i = (u + g) & 7, so that a warp's 32
// loads meet 32 banks even when rows are 128 bytes apart.
template <int EB, int MB>
__device__ __forceinline__ void chunk_scores(const Lay& y, const uint8_t* kt,
                                             const uint32_t* rep,
                                             const uint32_t* qa, float* sc,
                                             int D, int chunk, int lr,
                                             int lane, int warp) {
  const int g = lane >> 2, q4 = lane & 3;
  const int nsp = (D + 127) / 128;
  const float osc = out_scale<EB, MB>();
  for (int nt = warp; nt < (chunk + 7) / 8; nt += kWarps) {
    const int key = nt * 8 + g;
    const uint8_t* krow = kt + (long long)key * D;
    int acc[9][4] = {};  // limb pair (a, b) at 3 a + b: no chained mma
    for (int s = 0; s < nsp; ++s) {
      uint32_t r[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int dw = 32 * s + q4 + 4 * ((u + g) & 7);
        r[u] = key < chunk && 4 * dw < D
                   ? *reinterpret_cast<const uint32_t*>(krow + 4 * dw)
                   : 0u;
      }
      unrotate8(r, g);
      uint32_t kl[3][8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        uint32_t o[4];
        decode4(rep, lane, r[i], o);
#pragma unroll
        for (int b = 0; b < 3; ++b) kl[b][i] = o[b];
      }
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        const int ks = 4 * s + k4;
        if (32 * ks >= D) break;
        uint32_t qf[3][4];
#pragma unroll
        for (int a = 0; a < 3; ++a) load_frag(qa, ks, a, lane, qf[a]);
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const uint32_t kb[2] = {kl[b][2 * k4], kl[b][2 * k4 + 1]};
#pragma unroll
          for (int a = 0; a < 3; ++a) mma_s8(acc[3 * a + b], qf[a], kb);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = g + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = nt * 8 + 2 * q4 + e;
        if (t < lr && k < chunk) {
          const int i = 2 * h + e;
          const int cls[kClasses] = {
              acc[0][i], wrap_add(acc[1][i], acc[3][i]),
              wrap_add(wrap_add(acc[2][i], acc[4][i]), acc[6][i]),
              wrap_add(acc[5][i], acc[7][i]), acc[8][i]};
          sc[t * y.SCS + k] = __fmul_rn(combine_classes(cls), osc);
        }
      }
    }
  }
}

// o_chunk[t][d] = (combine(p_t . v_d) * out_scale) * sp_t. A warp takes
// 16-column groups as two mma n-tiles: tile jn's column g is d = 16 gi +
// 2 g + jn, so lane (g, q) reads its two columns of 4 keys as 4 halfwords
// and builds both tiles' B words; mma A is the p fragments.
template <int EB, int MB>
__device__ __forceinline__ void chunk_values(const Lay& y, const uint8_t* vt,
                                             const uint32_t* rep,
                                             const uint32_t* pa,
                                             const float* sp, float* och,
                                             int D, int chunk, int lr,
                                             int lane, int warp) {
  const int g = lane >> 2, q4 = lane & 3;
  const float osc = out_scale<EB, MB>();
  for (int gi = warp; gi < (D + 15) / 16; gi += kWarps) {
    const int dcol = 16 * gi + 2 * g;
    int acc[2][kClasses][4] = {};
    for (int ks = 0; ks < y.VK; ++ks) {
      uint32_t bf[2][3][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t L[4][2];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int key = 32 * ks + 16 * h + 4 * q4 + r;
          const uint32_t w =
              dcol < D && key < chunk
                  ? *reinterpret_cast<const uint16_t*>(
                        vt + (long long)key * D + dcol)
                  : 0u;
          L[r][0] = rep[((w & 255u) << 5) | uint32_t(lane)];
          L[r][1] = rep[(((w >> 8) & 255u) << 5) | uint32_t(lane)];
        }
#pragma unroll
        for (int jn = 0; jn < 2; ++jn)
#pragma unroll
          for (int b = 0; b < 3; ++b)
            bf[jn][b][h] = uint32_t(
                limb_word(L[0][jn], L[1][jn], L[2][jn], L[3][jn], b));
      }
      uint32_t pf[3][4];
#pragma unroll
      for (int a = 0; a < 3; ++a) load_frag(pa, ks, a, lane, pf[a]);
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int b = 0; b < 3; ++b)
#pragma unroll
          for (int a = 0; a < 3; ++a) mma_s8(acc[jn][a + b], pf[a], bf[jn][b]);
    }
#pragma unroll
    for (int jn = 0; jn < 2; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = g + 8 * h;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 16 * gi + 4 * q4 + 2 * e + jn;
          if (t < lr && d < D) {
            int cls[kClasses];
#pragma unroll
            for (int c = 0; c < kClasses; ++c) cls[c] = acc[jn][c][2 * h + e];
            och[t * y.OS + d] =
                __fmul_rn(__fmul_rn(combine_classes(cls), osc), sp[t]);
          }
        }
      }
  }
}

// s = raw * qk + bias over a warp's n keys of a row (written back), and
// their max: lane l holds keys [l * run, (l + 1) * run).
__device__ __forceinline__ float chunk_max(float* srow, const float* qk,
                                           const float* bias, int run, int n,
                                           int lane) {
  float mx = -INFINITY;
  for (int i = 0; i < run; ++i) {
    const int k = lane * run + i;
    if (k < n) {
      const float s = __fadd_rn(__fmul_rn(srow[k], qk[k]), bias[k]);
      srow[k] = s;
      mx = fmaxf(mx, s);
    }
  }
  return warp_max(mx);
}

// A warp's share of a row's chunk pieces given m_new: p = exp(s - m_new)
// over the lane's run, pv = p * v written over the scores,
// the warp's node of the neighbour-pair tree (the run in registers, then
// five levels across lanes) and max |pv|.
__device__ __forceinline__ void warp_probs(float* srow, const float* vs,
                                           float m_new, int run, int n,
                                           int lane, float& psum, float& am) {
  float pr[kMaxRun];
  am = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxRun; ++i) {
    const int k = lane * run + i;
    pr[i] = 0.f;
    if (i < run && k < n) {
      pr[i] = expf(srow[k] - m_new);
      const float pv = __fmul_rn(pr[i], vs[k]);
      srow[k] = pv;
      am = fmaxf(am, fabsf(pv));
    }
  }
#pragma unroll
  for (int w = kMaxRun; w > 1; w >>= 1)
    if (w <= run)
#pragma unroll
      for (int i = 0; i < w / 2; ++i)
        pr[i] = __fadd_rn(pr[2 * i], pr[2 * i + 1]);
  psum = pr[0];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
    psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, o));
  am = warp_max(am);
}

// pv / sp re-quantized to the format: the lane's packed limbs, written
// over its pv.
template <int EB, int MB>
__device__ __forceinline__ void requantize(float* srow, float sp, int run,
                                           int n, int lane) {
  uint32_t* pl = reinterpret_cast<uint32_t*>(srow);
  for (int i = 0; i < run; ++i) {
    const int k = lane * run + i;
    if (k < n)
      pl[k] = pack_limbs(round_decompose_ix<EB, MB>(__fdiv_rn(srow[k], sp)));
  }
}

// Row t's p limb fragments from its packed limbs (4 keys a word, zero past
// the chunk): words first, first + step, ... of the vk k-steps.
__device__ __forceinline__ void p_fragments(const float* srow, uint32_t* pa,
                                            int t, int vk, int chunk,
                                            int first, int step) {
  const uint32_t* pl = reinterpret_cast<const uint32_t*>(srow);
  for (int kw = first; kw < vk * 8; kw += step) {
    uint32_t w4[4] = {0u, 0u, 0u, 0u};
    if (4 * kw < chunk)
#pragma unroll
      for (int r = 0; r < 4; ++r) w4[r] = pl[4 * kw + r];
    uint32_t o[4];
    transpose4(w4, o);
#pragma unroll
    for (int b = 0; b < 3; ++b) pa[frag_a(t, kw, b)] = o[b];
  }
}

template <int EB, int MB>
__global__ void __launch_bounds__(kThreads, 2) flash_kernel(const Params a) {
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = a.cl, c = int(cluster.block_rank());
  const int n = blockIdx.x / CL, rt = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = a.T, D = a.D, chunk = a.chunk;
  const Lay y = layout(T, D, chunk);
  const int lr = min(kRows, T - rt * kRows);     // live rows of the tile
  const int d0 = c * D / CL, d1 = (c + 1) * D / CL, nc = d1 - d0;
  float* on = a.out + ((long long)n * T + rt * kRows) * D;

  const int L = max(a.live[n], 0);
  const int nlive = min((L + chunk - 1) / chunk, a.nb);  // live chunks
  const int np = (nlive + CL - 1) / CL;                   // passes
  if (np == 0) {  // a dead slice: o = l = 0, out = 0 / tiny
    for (int i = tid; i < lr * nc; i += kThreads)
      on[(i / nc) * D + d0 + i % nc] = 0.f;
    return;
  }

  uint8_t* ring = smem + y.ring;
  uint32_t* rep = reinterpret_cast<uint32_t*>(smem + y.rep);
  uint32_t* qa = reinterpret_cast<uint32_t*>(smem + y.qa);
  uint32_t* pa = reinterpret_cast<uint32_t*>(smem + y.pa);
  float* sc = reinterpret_cast<float*>(smem + y.sc);
  float* o_c = reinterpret_cast<float*>(smem + y.o);
  float* m_c = reinterpret_cast<float*>(smem + y.m);
  float* l_c = reinterpret_cast<float*>(smem + y.l);
  float* sp_c = reinterpret_cast<float*>(smem + y.sp);
  const uint32_t bar0 = smem_u32(smem + y.bar);
  // the start of row t's logical scale / bias row
  auto row0 = [&](int t) {
    return (long long)(n * a.rs + (a.rs == 1 ? 0 : rt * kRows + t)) *
           a.nb * chunk;
  };

  // chunk j's K and V tiles into the ring
  auto issue = [&](int j) {
    const long long tile = a.bt[(long long)n * a.nb + j];
    mbar_expect_tx(bar0, uint32_t(2 * y.tile));
    bulk_g2s(ring, a.kp + tile * y.tile, uint32_t(y.tile), bar0);
    bulk_g2s(ring + y.tile, a.vp + tile * y.tile, uint32_t(y.tile), bar0);
  };
  if (tid == 0) {
    mbar_init(bar0, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (c < nlive) issue(c);
  }

  // the code table, replicated per bank (thread i: code i, 32 replicas in
  // a rotated order, so a warp's stores meet 32 banks)
  {
    const uint32_t v = pack_limbs(code_to_ix<EB, MB>(tid));
    for (int r = 0; r < 32; ++r) rep[(tid << 5) | ((r + lane) & 31)] = v;
  }
  for (int i = tid; i < y.R * y.OS; i += kThreads) o_c[i] = 0.f;
  for (int i = tid; i < y.R; i += kThreads) {
    m_c[i] = -INFINITY;
    l_c[i] = 0.f;
  }
  for (int i = tid; i < y.VK * 3 * 128; i += kThreads) pa[i] = 0u;
  __syncthreads();
  // q limb fragments once (rows past the tile's live rows are zero)
  {
    const uint8_t* qn = a.q + ((long long)n * T + rt * kRows) * D;
    const int qw = y.KS * 8;
    for (int i = tid; i < kRows * qw; i += kThreads) {
      const int t = i / qw, dw = i % qw;
      const uint32_t w =
          t < lr && 4 * dw < D
              ? *reinterpret_cast<const uint32_t*>(qn + (long long)t * D +
                                                   4 * dw)
              : 0u;
      uint32_t o[4];
      decode4(rep, lane, w, o);
#pragma unroll
      for (int b = 0; b < 3; ++b) qa[frag_a(t, dw, b)] = o[b];
    }
  }
  __syncthreads();

  // The softmax takes wpr warps a row (fewer rows than warps: more warps
  // a row), each a contiguous block of 32 x run keys, and `groups` rows at
  // a time; the tree's levels above a warp go through shared words.
  int rp2 = 1;
  while (rp2 < lr && rp2 < kWarps) rp2 <<= 1;
  const int wpr = min(kWarps / rp2, y.P / 32);
  const int groups = kWarps / wpr, nit = (lr + groups - 1) / groups;
  const int run = y.P / (32 * wpr);
  const int wi = warp % wpr, wg = warp / wpr, k0 = wi * 32 * run;
  float* rmx = reinterpret_cast<float*>(smem + y.red);   // [R][kWarps]
  float* rsum = rmx + y.R * kWarps;
  float* rabs = rsum + y.R * kWarps;
  for (int p = 0; p < np; ++p) {
    const int j = p * CL + c;
    const bool live_j = j < nlive;
    float* part = reinterpret_cast<float*>(smem + y.part + (p & 1) * y.part_sz);
    float* och = part;                 // [R][OS] o_chunk
    float* cmax = part + y.R * y.OS;   // [R] chunk max, alpha, psum
    float* alp = cmax + y.R;
    float* psm = alp + y.R;
    const uint8_t* kt = ring;
    const uint8_t* vt = ring + y.tile;

    if (live_j) {
      while (!mbar_try_wait(bar0, uint32_t(p) & 1u)) {
      }
      chunk_scores<EB, MB>(y, kt, rep, qa, sc, D, chunk, lr, lane, warp);
    }
    __syncthreads();
    for (int it = 0; it < nit; ++it) {
      const int t = it * groups + wg;
      if (t < lr) {
        const long long ro = row0(t) + (long long)j * chunk + k0;
        const float mx =
            live_j ? chunk_max(sc + t * y.SCS + k0, a.qk + ro, a.bias + ro,
                               run, chunk - k0, lane)
                   : -INFINITY;
        if (lane == 0) rmx[t * kWarps + wi] = mx;
      }
    }
    __syncthreads();
    for (int t = tid; t < lr; t += kThreads) {
      float mx = rmx[t * kWarps];
      for (int u = 1; u < wpr; ++u) mx = fmaxf(mx, rmx[t * kWarps + u]);
      cmax[t] = mx;
    }
    cluster.sync();

    // the prefix maxima from the cluster, then this chunk's pieces
    for (int it = 0; it < nit; ++it) {
      const int t = it * groups + wg;
      const bool row = t < lr, work = row && live_j;
      float m_prev = -INFINITY, m_all = -INFINITY, m_new = -INFINITY;
      if (row) {
        float cm[kMaxCluster];
#pragma unroll
        for (int cc = 0; cc < kMaxCluster; ++cc)
          cm[cc] =
              cc < CL ? *cluster.map_shared_rank(cmax + t, cc) : -INFINITY;
        m_prev = m_all = m_c[t];
#pragma unroll
        for (int cc = 0; cc < kMaxCluster; ++cc) {
          if (cc < c) m_prev = fmaxf(m_prev, cm[cc]);
          m_all = fmaxf(m_all, cm[cc]);
        }
        m_new = fmaxf(m_prev, cmax[t]);
      }
      if (work) {
        const long long ro = row0(t) + (long long)j * chunk + k0;
        float ws = 0.f, wa = 0.f;
        warp_probs(sc + t * y.SCS + k0, a.vs + ro, m_new, run, chunk - k0,
                   lane, ws, wa);
        if (lane == 0) {
          rsum[t * kWarps + wi] = ws;
          rabs[t * kWarps + wi] = wa;
        }
      }
      __syncthreads();
      if (work) {
        // the tree's levels above the warps, and sp
        float v[kWarps];
        float am = 0.f;
#pragma unroll
        for (int u = 0; u < kWarps; ++u) {
          v[u] = u < wpr ? rsum[t * kWarps + u] : 0.f;
          if (u < wpr) am = fmaxf(am, rabs[t * kWarps + u]);
        }
#pragma unroll
        for (int w = kWarps; w > 1; w >>= 1)
          if (w <= wpr)
#pragma unroll
            for (int i = 0; i < w / 2; ++i)
              v[i] = __fadd_rn(v[2 * i], v[2 * i + 1]);
        const float sp = __fmul_rn(fmaxf(am, kTiny),
                                   __fdiv_rn(1.f, max_finite<Fmt<EB, MB>>()));
        requantize<EB, MB>(sc + t * y.SCS + k0, sp, run, chunk - k0, lane);
        if (wi == 0 && lane == 0) {
          alp[t] = expf(m_prev - m_new);
          psm[t] = v[0];
          sp_c[t] = sp;
        }
      }
      __syncthreads();
      if (work)
        p_fragments(sc + t * y.SCS, pa, t, y.VK, chunk, wi * 32 + lane,
                    32 * wpr);
      if (row && wi == 0 && lane == 0) m_c[t] = m_all;
    }
    __syncthreads();

    if (live_j)
      chunk_values<EB, MB>(y, vt, rep, pa, sp_c, och, D, chunk, lr, lane,
                           warp);
    __syncthreads();
    // the ring is free: this block's chunk of the next pass goes there
    if (tid == 0 && j + CL < nlive) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(j + CL);
    }
    cluster.sync();

    // the in-order fold of this pass's live chunks: l by every block, o by
    // each block over its columns [d0, d1); the cluster's partials are read
    // first, all at once
    const int nlp = min(CL, nlive - p * CL);
    const int ao = y.R * y.OS + y.R;   // alpha's offset in a partial buffer
    for (int i = tid; i < lr * nc; i += kThreads) {
      const int t = i / nc, d = d0 + i % nc;
      float al[kMaxCluster], oc[kMaxCluster];
#pragma unroll
      for (int cc = 0; cc < kMaxCluster; ++cc)
        if (cc < nlp) {
          const float* rp = cluster.map_shared_rank(part, cc);
          al[cc] = rp[ao + t];
          oc[cc] = rp[t * y.OS + d];
        }
      float o = o_c[t * y.OS + d];
#pragma unroll
      for (int cc = 0; cc < kMaxCluster; ++cc)
        if (cc < nlp) o = __fadd_rn(__fmul_rn(o, al[cc]), oc[cc]);
      o_c[t * y.OS + d] = o;
    }
    for (int t = tid; t < lr; t += kThreads) {
      float al[kMaxCluster], ps[kMaxCluster];
#pragma unroll
      for (int cc = 0; cc < kMaxCluster; ++cc)
        if (cc < nlp) {
          const float* rp = cluster.map_shared_rank(part, cc);
          al[cc] = rp[ao + t];
          ps[cc] = rp[ao + y.R + t];
        }
      float l = l_c[t];
#pragma unroll
      for (int cc = 0; cc < kMaxCluster; ++cc)
        if (cc < nlp) l = __fadd_rn(__fmul_rn(l, al[cc]), ps[cc]);
      l_c[t] = l;
    }
  }
  // no block leaves while another may still read its partials
  cluster.sync();
  for (int i = tid; i < lr * nc; i += kThreads) {
    const int t = i / nc, d = d0 + i % nc;
    on[t * D + d] = __fdiv_rn(o_c[t * y.OS + d], fmaxf(l_c[t], kTiny));
  }
}

int cluster_size(int nb) {
  int cl = 1;
  while (cl < nb && cl < kMaxCluster) cl <<= 1;
  return cl;
}

template <int EB, int MB>
int launch(Params a, int N, cudaStream_t stream) {
  if (N == 0 || a.T == 0) return 0;
  a.cl = cluster_size(a.nb);
  const long long bytes = layout(a.T, a.D, a.chunk).bytes;
  // opt into the card's whole per-block limit once per instantiation and
  // device (the kernel has no static shared memory); the wrapper refuses a
  // call that needs more
  static std::atomic<bool> attr_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = current_device(dev);
  if (err == cudaSuccess)
    err = smem_opt_in_once(flash_kernel<EB, MB>, kSmemOptIn, attr_set, dev);
  if (err != cudaSuccess) return int(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(N * a.cl), unsigned((a.T + kRows - 1) / kRows),
                     1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = size_t(bytes);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(a.cl);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_kernel<EB, MB>, a);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace

// C interface (ctypes). q: (N, T, D) u8 codes; kp / vp: (P, chunk, D) u8
// tile pools; bt: (N, nb) i32 tile ids; live: (N,) i32 live key counts;
// qk / vs / bias: (N, rs, nb * chunk) f32 logical rows with rs in {1, T};
// out: (N, T, D) f32. D and chunk must be multiples of 4, chunk at most
// kMaxChunk, and kp / vp 16-byte aligned (a tile is one bulk copy). fmt:
// 0 = E4M3, 1 = E3M4. Returns the launch's CUDA error (0 = launched;
// cudaErrorInvalidValue for a pool off 16 bytes).
extern "C" int mgs_flash_attention(const void* q, const void* kp,
                                   const void* vp, const void* bt,
                                   const void* live, const void* qk,
                                   const void* vs, const void* bias,
                                   void* out, int N, int T, int D, int chunk,
                                   int nb, int rs, int fmt, void* stream) {
  if ((reinterpret_cast<uintptr_t>(kp) | reinterpret_cast<uintptr_t>(vp)) %
      16)
    return int(cudaErrorInvalidValue);
  Params a{};
  a.q = static_cast<const uint8_t*>(q);
  a.kp = static_cast<const uint8_t*>(kp);
  a.vp = static_cast<const uint8_t*>(vp);
  a.bt = static_cast<const int*>(bt);
  a.live = static_cast<const int*>(live);
  a.qk = static_cast<const float*>(qk);
  a.vs = static_cast<const float*>(vs);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.T = T;
  a.D = D;
  a.chunk = chunk;
  a.nb = nb;
  a.rs = rs;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fmt == 0) return launch<4, 3>(a, N, s);
  return launch<3, 4>(a, N, s);
}

// Dynamic shared memory of a block, in bytes, for the wrapper's check; -1
// for a chunk past kMaxChunk keys.
extern "C" long long mgs_flash_attention_smem(int T, int D, int chunk) {
  if (chunk > kMaxChunk) return -1;
  return layout(T, D, chunk).bytes;
}
