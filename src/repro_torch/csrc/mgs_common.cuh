// Shared device helpers of the MGS kernels.
//
// The packed-code layout and the limb scheme repeat the PyTorch twins in
// repro_torch/core/formats.py (decode_sm_e) and
// repro_torch/kernels/mgs_matmul.py (_limb_split) operation for operation:
//
//   code -> (sm, e) -> ix = sm << max(e, 1) -> 3 balanced base-128 limbs
//
// Limbs are signed bytes; four of them along the contraction axis pack one
// 32-bit word for __dp4a. Every float step that must match the twins bit for
// bit is written with the _rn intrinsics, and the library is compiled with
// -fmad=false, so no a*b+c is ever contracted into one rounding.
#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace mgs {

constexpr int kLimbBase = 7;
constexpr int kClasses = 5;  // limb-weight classes a+b in [0, 4]
constexpr int kMaxDevices = 64;    // devices a launcher's one-time state covers
constexpr int kSmemOptIn = 232448; // dynamic shared memory a block may opt into

// The current device, refused past kMaxDevices.
inline cudaError_t current_device(int& dev) {
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev < 0 || dev >= kMaxDevices))
    err = cudaErrorInvalidDevice;
  return err;
}

// Opt `kern` into `bytes` of dynamic shared memory, once per device: `done`
// is the launcher's function-local flag array. The first call's error is
// returned, and a failed call is retried by the next launch.
template <class F>
inline cudaError_t smem_opt_in_once(F kern, int bytes,
                                    std::atomic<bool> (&done)[kMaxDevices],
                                    int dev) {
  // host threads of a replica fleet launch at once: a race only repeats
  // the (idempotent) attribute call
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return err;
}

// ix = sm << max(e, 1) of one packed code (formats.decode_sm_e).
template <int EB, int MB>
__device__ __forceinline__ int code_to_ix(int code) {
  const int frac = code & ((1 << MB) - 1);
  const int e = (code >> MB) & ((1 << EB) - 1);
  const int mag = e > 0 ? frac + (1 << MB) : frac;
  const int sm = ((code >> (EB + MB)) & 1) ? -mag : mag;
  return sm * (1 << (e > 1 ? e : 1));
}

// Balanced base-128 limbs of ix (mgs_matmul._limb_split), one per byte.
__device__ __forceinline__ uint32_t pack_limbs(int ix) {
  const int c0 = ((ix + 64) & 127) - 64;
  int rem = (ix - c0) >> kLimbBase;
  const int c1 = ((rem + 64) & 127) - 64;
  rem = (rem - c1) >> kLimbBase;
  return (uint32_t(c0) & 0xffu) | ((uint32_t(c1) & 0xffu) << 8) |
         ((uint32_t(rem) & 0xffu) << 16);
}

// Limb a of four consecutive contraction elements (byte i = element i).
__device__ __forceinline__ int limb_word(uint32_t l0, uint32_t l1, uint32_t l2,
                                         uint32_t l3, int a) {
  const uint32_t sel = uint32_t(a) | (uint32_t(4 + a) << 4);
  const uint32_t lo = __byte_perm(l0, l1, sel);
  const uint32_t hi = __byte_perm(l2, l3, sel);
  return int(__byte_perm(lo, hi, 0x5410));
}

// A 4 x 4 byte transpose: byte j of c[i] is byte i of r[j]. Turns 4 staged
// rows (4 columns each) into 4 K-packed column words, or 4 codes' packed
// limbs into one word per limb.
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4],
                                           uint32_t (&c)[4]) {
  const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(lo01, lo23, 0x5410);
  c[1] = __byte_perm(lo01, lo23, 0x7632);
  c[2] = __byte_perm(hi01, hi23, 0x5410);
  c[3] = __byte_perm(hi01, hi23, 0x7632);
}

// Exact float32 2**e for e in [-126, 127].
__device__ __forceinline__ float pow2f(int e) {
  return __int_as_float((e + 127) << 23);
}

// The wide-accumulator add: tot + sum_c float(acc[c]) * 2^(7c), ascending c.
__device__ __forceinline__ float flush_classes(float tot, const int* acc) {
#pragma unroll
  for (int c = 0; c < kClasses; ++c)
    tot = __fadd_rn(tot, __fmul_rn(__int2float_rn(acc[c]),
                                   pow2f(kLimbBase * c)));
  return tot;
}

// _combine_classes: float(acc[0]) + ... in the same ascending order.
__device__ __forceinline__ float combine_classes(const int* acc) {
  float tot = __int2float_rn(acc[0]);
#pragma unroll
  for (int c = 1; c < kClasses; ++c)
    tot = __fadd_rn(tot, __fmul_rn(__int2float_rn(acc[c]),
                                   pow2f(kLimbBase * c)));
  return tot;
}

// ACTIVATIONS of the twins (kernels/mgs_matmul.py), op for op: 0 none,
// 1 relu, 2 tanh-approximate gelu, 3 silu.
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

// 2^-2(bias+mbits): the fixed-point scale of an ix * ix product.
template <int EB, int MB>
__device__ __forceinline__ float out_scale() {
  return pow2f(-2 * (((1 << (EB - 1)) - 1) + MB));
}

// Format traits of an OCP FP8 format (formats.FPFormat). RES: the top
// exponent field is reserved for inf/NaN (E5M2); otherwise only the all-ones
// code of the top binade is NaN (E4M3, E3M4).
template <int EB_, int MB_, bool RES = false>
struct Fmt {
  static constexpr int EB = EB_, MB = MB_;
  static constexpr int bias = (1 << (EB - 1)) - 1;
  static constexpr int emin = 1 - bias;                      // unbiased
  static constexpr int emax = (1 << EB) - (RES ? 2 : 1) - bias;
  static constexpr int max_mant = (1 << (MB + 1)) - (RES ? 1 : 2);
  static constexpr int n_bins = 1 << EB;
};

template <class F>
__device__ __forceinline__ float max_finite() {
  return __fmul_rn(float(F::max_mant), pow2f(F::emax - F::MB));
}

// kernels/mgs_matmul.py::_round_decompose_e4m3, operation for operation:
// RNE-round y to the format through its exponent field (saturating at the
// max finite value; with `gate`, magnitudes below the smallest subnormal go
// to zero), then the rounded value's signed mantissa (returned) and exponent
// bin e. The divide by the binade's quantum 2^(eu - MB) is a multiply by its
// exact reciprocal: both are the correctly rounded value of one real number.
template <class F>
__device__ __forceinline__ int round_decompose(float y, bool gate, int& e) {
  const float ap = fabsf(y);
  int eu = (__float_as_int(ap) >> 23) - 127;
  eu = min(max(eu, F::emin), F::emax);
  float r = __fmul_rn(rintf(__fmul_rn(ap, pow2f(F::MB - eu))),
                      pow2f(eu - F::MB));
  r = fminf(r, max_finite<F>());
  if (gate && ap < pow2f(F::emin - F::MB)) r = 0.f;
  r = ap == 0.f ? 0.f : r;
  const float sgn = y > 0.f ? 1.f : (y < 0.f ? -1.f : 0.f);
  r = __fmul_rn(r, sgn);
  const float ar = fabsf(r);
  int eu2 = (__float_as_int(ar) >> 23) - 127;
  eu2 = min(max(eu2, F::emin), F::emax);
  e = ar < pow2f(F::emin) ? 0 : eu2 + F::bias;
  const int e1 = e > 1 ? e : 1;
  return int(rintf(__fmul_rn(r, pow2f(F::bias + F::MB - e1))));
}

// 256-entry code -> packed limbs table, filled by the whole block.
template <int EB, int MB>
__device__ __forceinline__ void fill_lut(uint32_t* lut, int tid, int nthreads) {
  for (int i = tid; i < 256; i += nthreads) lut[i] = pack_limbs(code_to_ix<EB, MB>(i));
}

}  // namespace mgs
