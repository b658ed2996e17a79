// B2: exact-MGS flash-decode attention over packed FP8 K/V tiles.
//
// Replaces the TPU kernel src/repro/kernels/mgs_attention.py::_flash_kernel
// (launched by _flash_pallas; entries mgs_flash_attention,
// mgs_paged_flash_attention and mgs_paged_verify_attention).
//
// One block per slice n walks the slice's live chunks through its block
// table bt[n, :] and runs the online-softmax update of _attn_tile_step on
// each: exact limb dots for q.k^T, s = (combine * 2^-2(bias+mbits)) * qk + b,
// running max, alpha = exp(m - m_new), p = exp(s - m_new), a pairwise
// neighbour tree for the denominator, per-row absmax re-quantization of
// p * v_scale to the cache format, exact limb dots for p.v, and
// o = o * alpha + o_chunk. Chunks with j * chunk >= live[n] are skipped.
// Every float step is a separate correctly rounded operation (-fmad=false,
// _rn intrinsics, expf without fast math) so the kernel equals its PyTorch
// twin (kernels/mgs_attention.py::_flash_plain) bit for bit on the card.
// The constant divide by the format's max finite value is a multiply by its
// float32 reciprocal, as the reference's compiled graph has it.
//
// What bounds it on an H100: decode attention reads each live K/V code once
// (2 bytes per cached element per step) and does 18 int8 MACs per element
// and query row, so at T = 1 query row it is memory bound. This first design
// is simple: the K chunk is decoded into limb words in shared memory (rows
// padded against bank conflicts) and the V chunk into words packed along the
// key axis, so both contractions run __dp4a out of shared memory; the
// per-row softmax runs block-wide. One block per slice gives B * KV blocks,
// about one wave at batch 4 on deepseek-7b; loads are not overlapped with
// compute and a slice is never split across blocks (later work, PERF.md).
#include <cmath>

#include "mgs_common.cuh"

using namespace mgs;

namespace {

constexpr int kThreads = 128;
constexpr float kTiny = 1e-30f;

// _round_decompose_e4m3(y, fmt, gate_subnormal=False) -> sm << max(e, 1)
template <int EB, int MB>
__device__ __forceinline__ int round_decompose_ix(float y) {
  int e;
  const int sm = round_decompose<Fmt<EB, MB>>(y, false, e);
  return sm * (1 << (e > 1 ? e : 1));
}

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < kThreads / 32; ++i) r = fmaxf(r, red[i]);
  return r;
}

struct Smem {
  uint32_t* lut;  // 256
  int* lk;        // [3][chunk][dw + 1]   K limbs, words along D
  int* lv;        // [3][chunk / 4][D]    V limbs, words along the keys
  int* lq;        // [3][T][dw]
  int* lp;        // [3][T][chunk / 4]
  float* sc;      // [T][chunk]
  float* o;       // [T][D]
  float* pb;      // [2][p2]
  float* st;      // [4][T]  m, l, alpha, sp
  float* red;     // [32]
};

__host__ __device__ inline size_t smem_bytes(int T, int D, int chunk, int p2) {
  const int dw = D / 4, cw = chunk / 4;
  size_t n = 256;                             // lut
  n += size_t(3) * chunk * (dw + 1);          // lk
  n += size_t(3) * cw * D;                    // lv
  n += size_t(3) * T * dw;                    // lq
  n += size_t(3) * T * cw;                    // lp
  n += size_t(T) * chunk + size_t(T) * D;     // sc, o
  n += size_t(2) * p2 + size_t(4) * T + 32;   // pb, st, red
  return n * 4;
}

template <int EB, int MB>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ kp,
             const uint8_t* __restrict__ vp, const int* __restrict__ bt,
             const int* __restrict__ live, const float* __restrict__ qk,
             const float* __restrict__ vsc, const float* __restrict__ bias,
             float* __restrict__ out, int T, int D, int chunk, int nb, int rs,
             int p2) {
  extern __shared__ uint32_t smem_raw[];
  const int dw = D / 4, cw = chunk / 4;
  Smem S;
  {
    uint32_t* p = smem_raw;
    S.lut = p; p += 256;
    S.lk = reinterpret_cast<int*>(p); p += 3 * chunk * (dw + 1);
    S.lv = reinterpret_cast<int*>(p); p += 3 * cw * D;
    S.lq = reinterpret_cast<int*>(p); p += 3 * T * dw;
    S.lp = reinterpret_cast<int*>(p); p += 3 * T * cw;
    S.sc = reinterpret_cast<float*>(p); p += T * chunk;
    S.o = reinterpret_cast<float*>(p); p += T * D;
    S.pb = reinterpret_cast<float*>(p); p += 2 * p2;
    S.st = reinterpret_cast<float*>(p); p += 4 * T;
    S.red = reinterpret_cast<float*>(p);
  }
  float* sm_m = S.st;
  float* sm_l = S.st + T;
  float* sm_alpha = S.st + 2 * T;
  float* sm_sp = S.st + 3 * T;

  const int n = blockIdx.x, tid = threadIdx.x;
  const float osc = out_scale<EB, MB>();
  const float rmax = __fdiv_rn(1.f, max_finite<Fmt<EB, MB>>());
  fill_lut<EB, MB>(S.lut, tid, kThreads);
  __syncthreads();

  // q limbs once (the activation-stationary trick of the TPU kernel)
  const uint8_t* qn = q + (long long)n * T * D;
  for (int i = tid; i < T * dw; i += kThreads) {
    const int t = i / dw, kw = i % dw;
    const uint32_t c = *reinterpret_cast<const uint32_t*>(qn + t * D + 4 * kw);
    const uint32_t l0 = S.lut[c & 255u], l1 = S.lut[(c >> 8) & 255u];
    const uint32_t l2 = S.lut[(c >> 16) & 255u], l3 = S.lut[c >> 24];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      S.lq[(a * T + t) * dw + kw] = limb_word(l0, l1, l2, l3, a);
  }
  for (int i = tid; i < T * D; i += kThreads) S.o[i] = 0.f;
  for (int t = tid; t < T; t += kThreads) {
    sm_m[t] = -INFINITY;
    sm_l[t] = 0.f;
  }
  __syncthreads();

  const int L = live[n];
  const long long row_len = (long long)nb * chunk;
  for (int j = 0; j < nb && j * chunk < L; ++j) {
    const long long tile = bt[(long long)n * nb + j];
    const uint8_t* kt = kp + tile * chunk * D;
    const uint8_t* vt = vp + tile * chunk * D;
    for (int i = tid; i < chunk * dw; i += kThreads) {
      const int s = i / dw, kw = i % dw;
      const uint32_t c = *reinterpret_cast<const uint32_t*>(kt + s * D + 4 * kw);
      const uint32_t l0 = S.lut[c & 255u], l1 = S.lut[(c >> 8) & 255u];
      const uint32_t l2 = S.lut[(c >> 16) & 255u], l3 = S.lut[c >> 24];
#pragma unroll
      for (int a = 0; a < 3; ++a)
        S.lk[(a * chunk + s) * (dw + 1) + kw] = limb_word(l0, l1, l2, l3, a);
    }
    for (int i = tid; i < cw * dw; i += kThreads) {
      const int sw = i / dw, dg = i % dw;
      uint32_t r[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        r[jj] = *reinterpret_cast<const uint32_t*>(vt + (4 * sw + jj) * D + 4 * dg);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int sh = 8 * cc;
        const uint32_t l0 = S.lut[(r[0] >> sh) & 255u];
        const uint32_t l1 = S.lut[(r[1] >> sh) & 255u];
        const uint32_t l2 = S.lut[(r[2] >> sh) & 255u];
        const uint32_t l3 = S.lut[(r[3] >> sh) & 255u];
#pragma unroll
        for (int a = 0; a < 3; ++a)
          S.lv[(a * cw + sw) * D + 4 * dg + cc] = limb_word(l0, l1, l2, l3, a);
      }
    }
    __syncthreads();

    // scores: exact q.k^T over D, then (s * out_scale) * qk + bias
    for (int i = tid; i < T * chunk; i += kThreads) {
      const int t = i / chunk, s = i % chunk;
      int acc[kClasses] = {0, 0, 0, 0, 0};
      for (int kw = 0; kw < dw; ++kw) {
        int xa[3], kb[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          xa[a] = S.lq[(a * T + t) * dw + kw];
          kb[a] = S.lk[(a * chunk + s) * (dw + 1) + kw];
        }
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b) acc[a + b] = __dp4a(xa[a], kb[b], acc[a + b]);
      }
      const long long row = (long long)(n * rs + (rs == 1 ? 0 : t)) * row_len
                            + (long long)j * chunk + s;
      const float sv = __fmul_rn(combine_classes(acc), osc);
      S.sc[t * chunk + s] = __fadd_rn(__fmul_rn(sv, qk[row]), bias[row]);
    }
    __syncthreads();

    // per row: online softmax, pairwise denominator, p * v_scale re-quantized
    for (int t = 0; t < T; ++t) {
      float* sct = S.sc + t * chunk;
      float mx = -INFINITY;
      for (int s = tid; s < chunk; s += kThreads) mx = fmaxf(mx, sct[s]);
      mx = block_max(mx, S.red);
      const float m_old = sm_m[t];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      for (int s = tid; s < p2; s += kThreads) {
        float p = 0.f;
        if (s < chunk) {
          p = expf(sct[s] - m_new);
          sct[s] = p;
        }
        S.pb[s] = p;
      }
      __syncthreads();
      // neighbour pairs at every level: x[0::2] + x[1::2]
      int src = 0;
      for (int wdt = p2 / 2; wdt >= 1; wdt >>= 1) {
        const float* in = S.pb + src * p2;
        float* outp = S.pb + (1 - src) * p2;
        for (int s = tid; s < wdt; s += kThreads)
          outp[s] = __fadd_rn(in[2 * s], in[2 * s + 1]);
        __syncthreads();
        src = 1 - src;
      }
      const float psum = S.pb[src * p2];
      const float l_new = __fadd_rn(__fmul_rn(sm_l[t], alpha), psum);
      const long long row0 = (long long)(n * rs + (rs == 1 ? 0 : t)) * row_len
                             + (long long)j * chunk;
      float am = 0.f;
      for (int s = tid; s < chunk; s += kThreads) {
        const float pv = __fmul_rn(sct[s], vsc[row0 + s]);
        sct[s] = pv;
        am = fmaxf(am, fabsf(pv));
      }
      am = block_max(am, S.red);
      const float sp = __fmul_rn(fmaxf(am, kTiny), rmax);
      for (int sw = tid; sw < cw; sw += kThreads) {
        uint32_t lm[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          lm[jj] = pack_limbs(round_decompose_ix<EB, MB>(__fdiv_rn(sct[4 * sw + jj], sp)));
#pragma unroll
        for (int a = 0; a < 3; ++a)
          S.lp[(a * T + t) * cw + sw] = limb_word(lm[0], lm[1], lm[2], lm[3], a);
      }
      __syncthreads();
      if (tid == 0) {
        sm_m[t] = m_new;
        sm_l[t] = l_new;
        sm_alpha[t] = alpha;
        sm_sp[t] = sp;
      }
      __syncthreads();
    }

    // values: exact p.v over the chunk, o = o * alpha + (c * out_scale) * sp
    for (int i = tid; i < T * D; i += kThreads) {
      const int t = i / D, d = i % D;
      int acc[kClasses] = {0, 0, 0, 0, 0};
      for (int sw = 0; sw < cw; ++sw) {
        int pa[3], vb[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          pa[a] = S.lp[(a * T + t) * cw + sw];
          vb[a] = S.lv[(a * cw + sw) * D + d];
        }
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b) acc[a + b] = __dp4a(pa[a], vb[b], acc[a + b]);
      }
      const float oc = __fmul_rn(__fmul_rn(combine_classes(acc), osc), sm_sp[t]);
      S.o[i] = __fadd_rn(__fmul_rn(S.o[i], sm_alpha[t]), oc);
    }
    __syncthreads();
  }

  float* on = out + (long long)n * T * D;
  for (int i = tid; i < T * D; i += kThreads) {
    const int t = i / D;
    on[i] = __fdiv_rn(S.o[i], fmaxf(sm_l[t], kTiny));
  }
}

template <int EB, int MB>
int launch(const uint8_t* q, const uint8_t* kp, const uint8_t* vp,
           const int* bt, const int* live, const float* qk, const float* vs,
           const float* bias, float* out, int N, int T, int D, int chunk,
           int nb, int rs, cudaStream_t stream) {
  int p2 = 1;
  while (p2 < chunk) p2 <<= 1;
  const size_t bytes = smem_bytes(T, D, chunk, p2);
  // opt into the card's whole per-block limit once per instantiation and
  // device; the wrapper refuses a call that needs more
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = current_device(dev);
  if (err == cudaSuccess)
    err = smem_opt_in_once(flash_kernel<EB, MB>, kSmemOptIn, attr_set, dev);
  if (err != cudaSuccess) return int(err);
  flash_kernel<EB, MB><<<N, kThreads, bytes, stream>>>(
      q, kp, vp, bt, live, qk, vs, bias, out, T, D, chunk, nb, rs, p2);
  return int(cudaGetLastError());
}

}  // namespace

// C interface (ctypes). q: (N, T, D) u8 codes; kp / vp: (P, chunk, D) u8
// tile pools; bt: (N, nb) i32 tile ids; live: (N,) i32 live key counts;
// qk / vs / bias: (N, rs, nb * chunk) f32 logical rows with rs in {1, T};
// out: (N, T, D) f32. D and chunk must be multiples of 4. fmt: 0 = E4M3,
// 1 = E3M4. Returns the launch's CUDA error (0 = launched).
extern "C" int mgs_flash_attention(const void* q, const void* kp,
                                   const void* vp, const void* bt,
                                   const void* live, const void* qk,
                                   const void* vs, const void* bias,
                                   void* out, int N, int T, int D, int chunk,
                                   int nb, int rs, int fmt, void* stream) {
  auto args = [&](auto f) {
    return f(static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(kp),
             static_cast<const uint8_t*>(vp), static_cast<const int*>(bt),
             static_cast<const int*>(live), static_cast<const float*>(qk),
             static_cast<const float*>(vs), static_cast<const float*>(bias),
             static_cast<float*>(out), N, T, D, chunk, nb, rs,
             static_cast<cudaStream_t>(stream));
  };
  if (fmt == 0) return args(launch<4, 3>);
  return args(launch<3, 4>);
}

// Dynamic shared memory the kernel needs (bytes), for the wrapper's check.
extern "C" long long mgs_flash_attention_smem(int T, int D, int chunk) {
  int p2 = 1;
  while (p2 < chunk) p2 <<= 1;
  return (long long)smem_bytes(T, D, chunk, p2);
}
