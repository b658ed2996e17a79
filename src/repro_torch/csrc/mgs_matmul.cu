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
// integer split into 3 balanced base-128 limbs (signed bytes in [-64, 63]);
// the 9 limb-pair products accumulate into 5 int32 class sums (a+b), and
// every flush_period K-steps of block_k the classes are added to a float32
// wide accumulator in ascending class order (the only rounding of the sum).
// Integer sums do not depend on their order (an int32 sum that overflows
// wraps modulo 2^32 in every order alike), so B1, B3 and B4 agree bit for
// bit whatever tiles, instructions or K splits they use, as long as each
// flush adds exactly its own segment's terms.
//
// What bounds them on an H100: at decode (M = slots, a handful of rows) the
// weight bytes, read once (K*N codes, 3 limb bytes each for B4, at
// 3.35 TB/s); at prefill (M >= 64) the 9 int8 limb products per
// multiply-add at the tensor-core rate.
//
// B1, B3 and B4 run one body (exact_body) on the int8 tensor cores:
// mma.sync m16n8k32 s8 x s8 -> s32, without .satfinite, so the sums wrap
// like the twin's int32 classes. A block
// * keeps a ring of 64-deep K stages in dynamic shared memory, filled by
//   16-byte cp.async (zero-filled past the edges) while earlier stages
//   compute. Operands whose rows are not 16-byte aligned (K or N not a
//   multiple of 16, a pointer off 16) are staged by plain loads at the same
//   point of the loop: the same bytes land, so the same bits;
// * converts each landed stage once into limb fragments in shared memory:
//   B1 and B3 decode every code through a 256-entry code->limbs table,
//   replicated once per bank so that a warp's 32 lookups never conflict; B4
//   copies its limb bytes. The K-packed words of w are transposed out of its
//   N-major rows with byte permutes. Fragments are stored in the order mma
//   takes them, XOR-swizzled so that neither the converting writes nor the
//   fragment reads conflict;
// * runs the 9 limb-pair mma of every 16 x 8 x 32 product and flushes the
//   class sums at every flush boundary.
// At decode (M <= 16) the weight is mma's A operand (16 output columns a
// product) and x its B operand (8 rows), so 4 rows pad half of a B tile
// rather than 3/4 of an A tile; a block covers 8 or 16 rows x 128 columns.
// At prefill a block covers 64 x 64. Where the decode tiles fill fewer than
// two blocks per SM, B1 and B4 split K across blocks (split_plan, mirrored
// by kernels/mgs_matmul.py::split_plan): no split crosses a flush boundary,
// each split adds its int32 class partials into its segment's slice of a
// workspace (atomicAdd), and the last split of an output tile to arrive (a
// counter per tile) flushes the segments in ascending order, runs the
// epilogue and returns workspace and counter to zero. One launch per call.
//
// B3 is the same body with one operand cached: a block converts the cached
// operand's limb fragments for its K range once, into a resident stripe of
// dynamic shared memory in the order mma takes them (activation-stationary:
// x's rows; weight-stationary: w's columns), then sweeps a contiguous run
// of the other operand's tiles, streaming only that operand through the
// ring; the ring runs on from one swept tile into the next. Where the
// cached operand is mma's B side (x at decode, w at prefill), only its live
// lines are stored and the fragments of the rest read as zero, so 4 decode
// rows take 4 rows of shared memory, not 8. B3 always plans its K split
// (stationary_plan, mirrored by kernels/mgs_matmul.py::stationary_plan):
// each block's part of the stripe must fit beside its ring and the table
// (in half an SM at decode, so that two blocks share one), and the blocks
// must fill the SMs; the splits then reduce exactly as B1's. Which shapes
// run B3 at all is the schedules' admission rule (kStripeBudget), not this
// layout.
//
// Sharded serving cuts K across ranks, and a float32 output per rank cannot
// be added back into B1's bits. So B1 has a second pair of entries: the
// partials entry runs exact_body (PART) over one cut of K, given where the
// cut starts in the whole K, and writes the int32 class partials of every
// flush segment of the whole K ([segment][class][slice][M][N], the split-K
// workspace layout; each block adds its piece of one segment by atomicAdd)
// and flushes nothing; the ranks sum these partials (an integer all-reduce,
// exact in any order), and the flush entry (flush_kernel) adds the segments
// in ascending order and the classes in ascending order with flush_classes,
// then runs B1's epilogue. Any cut of K then gives the one call's bits.
// B4 has the same partials entry (exact_body with LIMBS and PART), over
// the cut's limb planes; its class sums are B1's, so B1's flush closes them.
// B3 has the same partials entry (exact_body with CACHE and PART): each block
// keeps the cached operand's stripe over its run of the rank's K range only,
// and writes its piece of a segment of the whole K as B1's partials do. It is
// admitted by the stationary rule over the cut's K (the dispatch falls back to
// B1's partials first), and planned as B3 plans (stationary_part_plan).
#include "mgs_common.cuh"

using namespace mgs;

namespace {

// ---------------------------------------------------------------------------
// shared by B1, B3 and B4
// ---------------------------------------------------------------------------

// Kernel arguments. scale / bias element [b, n] sits at b * *_bs + n * *_ns
// (a stride of 0 broadcasts).
struct Args {
  const uint8_t* x = nullptr;
  const uint8_t* w = nullptr;
  const float* scale = nullptr;
  const float* bias = nullptr;
  float* out = nullptr;
  int M = 0, K = 0, N = 0;
  long long x_bs = 0, w_bs = 0;
  int s_bs = 0, s_ns = 0, b_bs = 0, b_ns = 0;
  int act = 0, block_k = 0, flush_period = 0;
  long long x_plane = 0, w_plane = 0;  // bytes between limb planes (B4)
  // the K split (see Plan), its workspace, and the staging path
  int* ws = nullptr;
  int* cnt = nullptr;
  int splits = 1, per = 1, run = 0, seg = 0;
  bool async = false;
  // B3: the resident stripe's lines and the swept tiles of a block
  int lines = 0, pg = 1;
  // the partials entry: where this cut of K starts in the whole K
  int k_off = 0;
};

// The epilogue of one output: act(acc * out_scale * scale + bias).
template <int EB, int MB>
__device__ __forceinline__ void finish(const Args& g, int bz, int m, int n,
                                       float acc) {
  float r = __fmul_rn(acc, out_scale<EB, MB>());
  if (g.scale)
    r = __fmul_rn(r, g.scale[(long long)bz * g.s_bs + (long long)n * g.s_ns]);
  if (g.bias)
    r = __fadd_rn(r, g.bias[(long long)bz * g.b_bs + (long long)n * g.b_ns]);
  g.out[(long long)bz * g.M * g.N + (long long)m * g.N + n] =
      activate(r, g.act);
}

// ---------------------------------------------------------------------------
// B1, B3 and B4: int8 tensor cores, a cp.async ring, exact split-K
// ---------------------------------------------------------------------------

constexpr int kRK = 64;            // K elements per ring stage
constexpr int kRW = kRK / 4;       // K-packed words per line and stage
constexpr int kPad = 16;           // bytes past each staged row (banks)
constexpr int kDecodeRows = 16;    // M up to which decode tiles and split-K
constexpr int kDecodeCols = 128;   // output columns of a decode tile
constexpr int kSMs = 132;          // SMs of an H100
constexpr int kSplitTarget = 2 * kSMs;  // blocks in one wave: 2 per SM
constexpr int kMinRun = 4;         // least 32-element K units a split takes
// Dynamic shared memory a B3 block may take: the opt-in less room for the
// kernel's static shared memory (which the opt-in counts too), and the same
// for each of two blocks on one SM (the SM's 228 KB less 1 KB reserved per
// block, halved).
constexpr int kStaticReserve = 256;
constexpr int kStatBytes = kSmemOptIn - kStaticReserve;
constexpr int kPairBytes = (233472 - 2 * 1024) / 2 - kStaticReserve;
// The stationary schedules' admission rule (kernels/mgs_matmul.py
// WS_STRIPE_BUDGET_BYTES, check_stripe): a 3 x Kp x edge limb stripe over
// tile_shape()'s edge (4, 16 or 64) larger than this is refused, and the
// dispatch falls back to B1 first. The rule of B3's first, __dp4a layout
// (the opt-in less a table and a 32-deep staged tile), kept so that every
// shape runs the schedule it ran before; the kernel's own layout is
// stationary_plan's.
constexpr long long kStripeBudget = kSmemOptIn - 256 * 4 - 3 * 32 * 64;

// A block tile of exact_body. Its warps form a WA x WB grid, each holding
// TA mma A tiles (16 lines) by TB B tiles (8 lines). SWAP: A is w^T (its
// lines are output columns) and B is x (rows); else A is x and B is w^T.
template <bool SWAP_, int WA_, int WB_, int TA_, int TB_>
struct Tile {
  static constexpr bool SWAP = SWAP_;
  static constexpr int WA = WA_, WB = WB_, TA = TA_, TB = TB_;
  static constexpr int LA = 16 * TA * WA, LB = 8 * TB * WB;
  static constexpr int BM = SWAP ? LB : LA, BN = SWAP ? LA : LB;
  static constexpr int NT = 32 * WA * WB;
};
using Decode8 = Tile<true, 8, 1, 1, 1>;    // M <= 8: 8 x 128
using Decode16 = Tile<true, 8, 1, 1, 2>;   // M <= 16: 16 x 128
using Prefill = Tile<false, 2, 4, 2, 2>;   // 64 x 64
static_assert(Decode8::BN == kDecodeCols && Decode16::BN == kDecodeCols &&
                  Decode16::BM == kDecodeRows,
              "split_plan counts decode tiles of kDecodeCols columns");

// exact_body's dynamic shared memory (bytes): the ring (per stage, each
// staged plane's x rows then its w rows, every row kPad bytes longer than
// its data), one stage of A and B limb fragments (3 planes of kRW words per
// line), B1's / B3's code->limbs table (256 words, then 32 replicas of it
// laid out [code][lane]), and B3's resident stripe after it (sized by
// stationary_plan). CACHE: the operand B3 keeps resident, 0 none (B1, B4),
// 1 x (activation-stationary), 2 w (weight-stationary); it is not staged,
// and has no stage fragments. STAGES: the deepest ring that leaves room for
// two blocks on an SM (B4's 16-row decode tile still fits only one; B3's 4
// leave room for its stripe); MINB: the blocks an SM must hold (registers
// capped to fit), 1 for the prefill tile of B1 and B3, which would spill
// under the cap.
template <bool LIMBS, class T, int CACHE = 0>
struct Layout {
  static constexpr int P = LIMBS ? 3 : 1;
  // the cached operand is mma's A side (w at decode, x at prefill) or B side
  static constexpr bool RES_A = CACHE == (T::SWAP ? 2 : 1);
  static constexpr bool RES_B = CACHE == (T::SWAP ? 1 : 2);
  static constexpr int STAGES =
      CACHE ? 4 : LIMBS ? (T::SWAP ? 3 : 2) : (T::SWAP ? 5 : 4);
  static constexpr int MINB = LIMBS || T::SWAP ? 2 : 1;
  static constexpr int XS = kRK + kPad, WS = T::BN + kPad;
  static constexpr int XP = CACHE == 1 ? 0 : T::BM * XS;
  static constexpr int WP = CACHE == 2 ? 0 : kRK * WS;
  static constexpr int STAGE = P * (XP + WP);
  static constexpr int FA = RES_A ? 0 : 3 * kRW * T::LA;   // words
  static constexpr int FB = RES_B ? 0 : 3 * kRW * T::LB;
  static constexpr int LUT = LIMBS ? 0 : 256 * 33;
  static constexpr int BYTES = STAGES * STAGE + 4 * (FA + FB + LUT);
};

// How K is cut across blocks (kernels/mgs_matmul.py::split_plan, line for
// line). Units of 32 K elements.
struct Plan {
  int splits;  // blocks along K per output tile; 1: one block walks all K
  int per;     // splits inside each flush segment
  int run;     // units a split takes
  int seg;     // units of one flush segment (flush_period * block_k / 32)
};

Plan split_plan(int Bt, int M, int K, int N, int block_k, int fp) {
  const int units = (K + 31) / 32, seg = fp * (block_k / 32);
  const Plan direct{1, 1, units, seg};
  const long long tiles =
      (long long)Bt * ((N + kDecodeCols - 1) / kDecodeCols);
  if (M > kDecodeRows || tiles >= kSplitTarget) return direct;
  const long long nseg = (units + seg - 1) / seg;
  const long long span = units < seg ? units : seg;
  long long per = kSplitTarget / (tiles * nseg);
  if (per < 1) per = 1;
  long long run = (span + per - 1) / per;
  if (run < kMinRun) run = kMinRun;
  per = (span + run - 1) / run;
  if (nseg * per == 1) return direct;
  return {int(nseg * per), int(per), int(run), seg};
}

// B3's plan (kernels/mgs_matmul.py::stationary_plan, line for line): the K
// split, the sweep groups, the stripe's lines and a block's shared memory.
struct StatPlan {
  Plan k;      // the K split, as split_plan's
  int groups;  // blocks along the swept operand's tiles
  int pg;      // swept tiles a block takes
  int lines;   // lines of the resident stripe (x rows or w columns)
  int bytes;   // dynamic shared memory of a block
};

// B3's layout at tile T: the bytes of ring, fragments and table, the
// resident lines (the A side whole, the B side only its live lines), the
// blocks an SM must hold, and the tile.
struct StatLayout {
  int fixed, lines, minb, bm, bn;
};

template <class T, int CACHE>
StatLayout stat_layout(int M, int N) {
  using L = Layout<false, T, CACHE>;
  const int live = CACHE == 1 ? M : N;
  return {L::BYTES, L::RES_A ? T::LA : live < T::LB ? live : T::LB, L::MINB,
          T::BM, T::BN};
}

StatLayout stat_layout_of(int M, int N, bool cw) {
  return M <= 8 ? (cw ? stat_layout<Decode8, 2>(M, N)
                      : stat_layout<Decode8, 1>(M, N))
         : M <= kDecodeRows ? (cw ? stat_layout<Decode16, 2>(M, N)
                                  : stat_layout<Decode16, 1>(M, N))
                            : (cw ? stat_layout<Prefill, 2>(M, N)
                                  : stat_layout<Prefill, 1>(M, N));
}

// The K split of B3 over span units of a flush segment (nseg segments): runs
// short enough that the stripe fits, and more while the blocks do not fill
// the SMs; then the sweep groups, the stripe's lines and a block's bytes.
// piece: every segment is cut into pieces (the partials entry), even one.
StatPlan stat_split(const StatLayout& s, int Bt, int M, int N, int units,
                    int seg, long long nseg, bool cw, bool piece) {
  const long long mt = (M + s.bm - 1) / s.bm, nt = (N + s.bn - 1) / s.bn;
  const long long cached = cw ? nt : mt, sweep = cw ? mt : nt;
  const long long budget = s.minb == 2 ? kPairBytes : kStatBytes;
  const long long target = (long long)s.minb * kSMs;
  // the units of K a block's part of the stripe may span
  long long cap = (budget - s.fixed) / (96LL * s.lines);
  if (cap < 1) cap = 1;
  const long long span = units < seg ? units : seg;
  long long per = (span + cap - 1) / cap;
  const long long fill = target / ((long long)Bt * cached * sweep * nseg);
  if (per < fill) per = fill;
  long long run = (span + per - 1) / per;
  const long long least = cap < kMinRun ? cap : kMinRun;
  if (run < least) run = least;
  per = (span + run - 1) / run;
  StatPlan p;
  p.k = nseg * per == 1 && !piece
            ? Plan{1, 1, units, seg}
            : Plan{int(nseg * per), int(per), int(run), seg};
  const long long items = (long long)Bt * cached * p.k.splits;
  long long groups = (target + items - 1) / items;
  if (groups > sweep) groups = sweep;
  const long long pg = (sweep + groups - 1) / groups;
  p.pg = int(pg);
  p.groups = int((sweep + pg - 1) / pg);
  p.lines = s.lines;
  p.bytes = int(s.fixed + 96LL * p.k.run * s.lines);
  return p;
}

StatPlan stationary_plan(int Bt, int M, int K, int N, int block_k, int fp,
                         bool cw) {
  const int units = (K + 31) / 32, seg = fp * (block_k / 32);
  return stat_split(stat_layout_of(M, N, cw), Bt, M, N, units, seg,
                    (units + seg - 1) / seg, cw, false);
}

// B3's partials entry: the pieces of the flush segments of the whole K that
// the cut [k_off, k_off + K) touches (as part_plan), each cut into runs as
// stationary_plan cuts a segment.
StatPlan stationary_part_plan(int Bt, int M, int K, int N, int block_k,
                              int fp, int k_off, bool cw) {
  const int seg = fp * (block_k / 32), seg_len = 32 * seg;
  const long long nseg =
      ((long long)k_off + K - 1) / seg_len - k_off / seg_len + 1;
  return stat_split(stat_layout_of(M, N, cw), Bt, M, N, (K + 31) / 32, seg,
                    nseg, cw, true);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  // bytes of the 16 past src_bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a * b: one 16 x 8 x 32 int8 product, s32 sums that wrap.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The limb words of 4 codes along K (o[a] byte j: limb a of code[j]), from
// the replicated table: lane l reads replica l, which sits in bank l.
__device__ __forceinline__ void code_limbs(const uint32_t* rep, int lane,
                                           const uint32_t (&code)[4],
                                           uint32_t (&o)[4]) {
  uint32_t l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) l[j] = rep[(code[j] << 5) | uint32_t(lane)];
  transpose4(l, o);
}

// Limb fragments of one stage, ordered [mma step][tile][register][lane] as
// mma.m16n8k32 takes them (A: 16-line tiles, registers (row g, quad q),
// (g + 8, q), (g, q + 4), (g + 8, q + 4) of lane 4g + q; B: 8-line tiles,
// registers quad q, q + 4 of line g). The lane is XOR-swizzled per tile (and
// per A register half), so that a warp writing 32 lines of one quad, or
// reading one register of its tiles, meets 32 banks.
__device__ __forceinline__ int swz_a(int tile, int reg) {
  return ((tile << 1) | (reg & 1)) & 15;
}
__device__ __forceinline__ int swz_b(int tile) { return (tile << 1) & 15; }

// Word offset, in one limb plane of A (LA lines), of line l's K-packed word
// kw (0 .. kRW - 1 of a stage; B3's resident A side: any kw of its range).
template <int LA>
__device__ __forceinline__ int frag_a(int l, int kw) {
  const int tile = l >> 4, q = kw & 7;
  const int reg = ((l >> 3) & 1) | ((q >> 2) << 1);
  return (((kw >> 3) * (LA / 16) + tile) * 4 + reg) * 32 +
         (((l & 7) * 4 + (q & 3)) ^ swz_a(tile, reg));
}

template <int LB>
__device__ __forceinline__ int frag_b(int l, int kw) {
  const int tile = l >> 3, q = kw & 7;
  return (((kw >> 3) * (LB / 8) + tile) * 2 + (q >> 2)) * 32 +
         (((l & 7) * 4 + (q & 3)) ^ swz_b(tile));
}

// B3's resident B side holds only its `live` lines: per mma step and limb
// plane, tile t's 2 registers of the lanes of its min(8, live - 8t) lines,
// unswizzled (written once, read by lanes in order).
__device__ __forceinline__ int frag_b_live(int l, int kw, int live) {
  const int tile = l >> 3, q = kw & 7;
  const int lt = min(8, live - 8 * tile);
  return (kw >> 3) * 8 * live + tile * 64 + (q >> 2) * 4 * lt +
         (l & 7) * 4 + (q & 3);
}

// 4 bytes of a row from column col, zero at and past lim (the plain-load
// staging path): one 32-bit load where the address allows.
__device__ __forceinline__ uint32_t load_word(const uint8_t* row, int col,
                                              int lim) {
  const uint8_t* p = row + col;
  if (col + 3 < lim && (reinterpret_cast<uintptr_t>(p) & 3) == 0)
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  uint32_t v = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (col + j < lim) v |= uint32_t(__ldg(p + j)) << (8 * j);
  return v;
}

// Stage K elements [k, k + kRK) of the block's x rows and w columns (zero
// past M, N and k1) into ring slot st; B3 stages only the streamed operand.
template <bool LIMBS, class T, int CACHE>
__device__ __forceinline__ void load_stage(uint8_t* st, const Args& g,
                                           const uint8_t* xb,
                                           const uint8_t* wb, int m0, int n0,
                                           int k, int k1, int tid) {
  using L = Layout<LIMBS, T, CACHE>;
  uint8_t* sw = st + L::P * L::XP;
  if (g.async) {
    constexpr int XC = kRK / 16, WC = T::BN / 16;   // 16-byte chunks a row
    if constexpr (CACHE != 1)
      for (int i = tid; i < L::P * T::BM * XC; i += T::NT) {
        const int c = i % XC, m = (i / XC) % T::BM, a = i / (XC * T::BM);
        const int kk = k + 16 * c;
        const int n = m0 + m < g.M ? min(max(k1 - kk, 0), 16) : 0;
        const uint8_t* src =
            n ? xb + a * g.x_plane + (long long)(m0 + m) * g.K + kk : xb;
        cp_async16(st + a * L::XP + m * L::XS + 16 * c, src, n);
      }
    if constexpr (CACHE != 2)
      for (int i = tid; i < L::P * kRK * WC; i += T::NT) {
        const int c = i % WC, r = (i / WC) % kRK, a = i / (WC * kRK);
        const int nn = n0 + 16 * c;
        const int n = k + r < k1 ? min(max(g.N - nn, 0), 16) : 0;
        const uint8_t* src =
            n ? wb + a * g.w_plane + (long long)(k + r) * g.N + nn : wb;
        cp_async16(sw + a * L::WP + r * L::WS + 16 * c, src, n);
      }
    return;
  }
  constexpr int XW = kRK / 4, WW = T::BN / 4;       // words a row
  if constexpr (CACHE != 1)
    for (int i = tid; i < L::P * T::BM * XW; i += T::NT) {
      const int j = i % XW, m = (i / XW) % T::BM, a = i / (XW * T::BM);
      const uint32_t v =
          m0 + m < g.M
              ? load_word(xb + a * g.x_plane + (long long)(m0 + m) * g.K,
                          k + 4 * j, k1)
              : 0u;
      *reinterpret_cast<uint32_t*>(st + a * L::XP + m * L::XS + 4 * j) = v;
    }
  if constexpr (CACHE != 2)
    for (int i = tid; i < L::P * kRK * WW; i += T::NT) {
      const int j = i % WW, r = (i / WW) % kRK, a = i / (WW * kRK);
      const uint32_t v =
          k + r < k1 ? load_word(wb + a * g.w_plane + (long long)(k + r) * g.N,
                                 n0 + 4 * j, g.N)
                     : 0u;
      *reinterpret_cast<uint32_t*>(sw + a * L::WP + r * L::WS + 4 * j) = v;
    }
}

// Convert ring slot st into the limb fragments fa (A) and fb (B); B3
// converts only the streamed operand.
template <bool LIMBS, class T, int CACHE>
__device__ __forceinline__ void convert(const uint8_t* st, uint32_t* fa,
                                        uint32_t* fb, const uint32_t* rep,
                                        int tid) {
  using L = Layout<LIMBS, T, CACHE>;
  const int lane = tid & 31;
  uint32_t* fx = T::SWAP ? fb : fa;
  uint32_t* fw = T::SWAP ? fa : fb;
  constexpr int XPL = kRW * T::BM, WPL = kRW * T::BN;  // words a limb plane
  // x rows: a warp takes 8 lines x 4 words, which meets 32 banks in the
  // staged rows and writes 32 consecutive fragment words
  constexpr int XI = T::BM * kRW, WI = T::BN / 4 * kRW;   // items
  if constexpr (CACHE != 1) {
#pragma unroll
    for (int u = 0; u < (XI + T::NT - 1) / T::NT; ++u) {
      const int i = tid + u * T::NT;
      if (XI % T::NT != 0 && i >= XI) break;
      const int r = i >> 5;
      const int kw = ((r & 3) << 2) | (i & 3),
                l = ((r >> 2) << 3) | ((i >> 2) & 7);
      const uint8_t* src = st + l * L::XS + 4 * kw;
      uint32_t o[4];
      if constexpr (LIMBS) {
#pragma unroll
        for (int a = 0; a < 3; ++a)
          o[a] = *reinterpret_cast<const uint32_t*>(src + a * L::XP);
      } else {
        const uint32_t c = *reinterpret_cast<const uint32_t*>(src);
        const uint32_t code[4] = {c & 255u, (c >> 8) & 255u,
                                  (c >> 16) & 255u, c >> 24};
        code_limbs(rep, lane, code, o);
      }
      const int off = T::SWAP ? frag_b<T::BM>(l, kw) : frag_a<T::BM>(l, kw);
#pragma unroll
      for (int a = 0; a < 3; ++a) fx[a * XPL + off] = o[a];
    }
  }
  // w columns: 4 rows x 4 columns an item, transposed into K-packed words
  if constexpr (CACHE != 2) {
    constexpr int NG = T::BN / 4;
    const uint8_t* sw = st + L::P * L::XP;
#pragma unroll
    for (int u = 0; u < (WI + T::NT - 1) / T::NT; ++u) {
      const int i = tid + u * T::NT;
      if (WI % T::NT != 0 && i >= WI) break;
      const int ng = i % NG, kw = i / NG;
      const uint8_t* src = sw + 4 * kw * L::WS + 4 * ng;
      int off[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        off[cc] = T::SWAP ? frag_a<T::BN>(4 * ng + cc, kw)
                          : frag_b<T::BN>(4 * ng + cc, kw);
#pragma unroll
      for (int a = 0; a < L::P; ++a) {
        uint32_t r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          r[j] = *reinterpret_cast<const uint32_t*>(src + a * L::WP +
                                                    j * L::WS);
        if constexpr (LIMBS) {
          uint32_t t[4];
          transpose4(r, t);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) fw[a * WPL + off[cc]] = t[cc];
        } else {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const uint32_t code[4] = {
                (r[0] >> (8 * cc)) & 255u, (r[1] >> (8 * cc)) & 255u,
                (r[2] >> (8 * cc)) & 255u, (r[3] >> (8 * cc)) & 255u};
            uint32_t o[4];
            code_limbs(rep, lane, code, o);
#pragma unroll
            for (int b = 0; b < 3; ++b) fw[b * WPL + off[cc]] = o[b];
          }
        }
      }
    }
  }
}

// B3: the cached operand's codes over [k0, k1) of the tile at (m0, n0),
// decoded through the table into the resident stripe res (limb plane a at
// a * plane words), once per block: zero past M, N and k1, to the end of the
// last 32-deep mma step. The A side is stored whole in frag_a's order over
// the range; the B side only its `live` lines (frag_b_live).
template <class T, int CACHE>
__device__ __forceinline__ void convert_resident(
    uint32_t* res, int plane, const Args& g, const uint8_t* xb,
    const uint8_t* wb, int m0, int n0, int k0, int k1, int live,
    const uint32_t* lut, int tid) {
  using L = Layout<false, T, CACHE>;
  const int nkw = (k1 - k0 + 31) / 32 * 8;   // K-packed words a line
  const int nl = L::RES_A ? T::LA : live;    // lines stored
  auto put = [&](int l, int kw, const uint32_t (&c)[4]) {
    uint32_t lw[4], o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) lw[j] = lut[c[j]];
    transpose4(lw, o);
    const int at =
        L::RES_A ? frag_a<T::LA>(l, kw) : frag_b_live(l, kw, live);
#pragma unroll
    for (int a = 0; a < 3; ++a) res[a * plane + at] = o[a];
  };
  if constexpr (CACHE == 1) {   // x rows: 4 codes along K a word
    for (int i = tid; i < nl * nkw; i += T::NT) {
      const int l = i / nkw, kw = i % nkw;
      const uint32_t v =
          m0 + l < g.M
              ? load_word(xb + (long long)(m0 + l) * g.K, k0 + 4 * kw, k1)
              : 0u;
      const uint32_t c[4] = {v & 255u, (v >> 8) & 255u, (v >> 16) & 255u,
                             v >> 24};
      put(l, kw, c);
    }
  } else {   // w columns: 4 rows x 4 columns an item, transposed
    const int ng = (nl + 3) / 4;
    for (int i = tid; i < ng * nkw; i += T::NT) {
      const int c4 = i % ng, kw = i / ng;
      uint32_t r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + 4 * kw + j;
        r[j] = k < k1 ? load_word(wb + (long long)k * g.N, n0 + 4 * c4, g.N)
                      : 0u;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        if (4 * c4 + cc >= nl) break;
        const uint32_t c[4] = {
            (r[0] >> (8 * cc)) & 255u, (r[1] >> (8 * cc)) & 255u,
            (r[2] >> (8 * cc)) & 255u, (r[3] >> (8 * cc)) & 255u};
        put(4 * c4 + cc, kw, c);
      }
    }
  }
}

// One 32-deep mma step of a warp's tiles: the 9 limb pairs (a, b) into class
// a + b. A's fragments of step ka sit in fa with pa words a limb plane, B's
// of step kb in fb with pb; a stage holds steps 0 and 1, B3's resident side
// every step of its range. BL: B is B3's resident B side of `live` lines.
template <class T, bool BL>
__device__ __forceinline__ void mma_step(
    int (&acc)[kClasses][T::TA][T::TB][4], const uint32_t* fa, int pa,
    int ka, const uint32_t* fb, int pb, int kb, int live, int wa, int wb,
    int lane) {
  uint32_t bf[3][T::TB][2];
#pragma unroll
  for (int b = 0; b < 3; ++b)
#pragma unroll
    for (int tb = 0; tb < T::TB; ++tb) {
      const int tile = wb * T::TB + tb;
      if constexpr (BL) {
        const int lt = min(8, live - 8 * tile);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          bf[b][tb][r] = lane < 4 * lt ? fb[b * pb + kb * 8 * live +
                                            tile * 64 + r * 4 * lt + lane]
                                       : 0u;
      } else {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          bf[b][tb][r] = fb[b * pb + ((kb * (T::LB / 8) + tile) * 2 + r) * 32 +
                            (lane ^ swz_b(tile))];
      }
    }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    uint32_t af[T::TA][4];
#pragma unroll
    for (int ta = 0; ta < T::TA; ++ta) {
      const int tile = wa * T::TA + ta;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        af[ta][r] = fa[a * pa + ((ka * (T::LA / 16) + tile) * 4 + r) * 32 +
                       (lane ^ swz_a(tile, r))];
    }
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int ta = 0; ta < T::TA; ++ta)
#pragma unroll
        for (int tb = 0; tb < T::TB; ++tb)
          mma_s8(acc[a + b][ta][tb], af[ta], bf[b][tb]);
  }
}

// B1 (codes), B4 (LIMBS: limb planes) and B3 (CACHE). Grid, B1 / B4:
// (column tiles, row tiles or K splits, slices); B3: (sweep groups, cached
// tiles x K splits, slices). PART (the partials entries): every block takes
// one piece of one flush segment of the whole K (part_plan, B3's
// stationary_part_plan) and adds its class partials into g.ws at that
// segment; nothing is flushed. Grid, B1: (column tiles, row tiles x pieces,
// slices); B3: (sweep groups, cached tiles x pieces, slices).
template <bool LIMBS, int EB, int MB, class T, int CACHE, bool PART = false>
__device__ __forceinline__ void exact_body(const Args& g) {
  using L = Layout<LIMBS, T, CACHE>;
  constexpr int TA = T::TA, TB = T::TB;
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* fa = reinterpret_cast<uint32_t*>(smem + L::STAGES * L::STAGE);
  uint32_t* fb = fa + L::FA;
  uint32_t* lut = fb + L::FB;
  uint32_t* rep = lut + 256;
  uint32_t* res = rep + 256 * 32;   // B3's resident stripe
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ya = warp % T::WA, yb = warp / T::WA;  // the warp's place
  const int bz = blockIdx.z;
  const bool split = PART || g.splits > 1;
  // the block's K split, and its output tiles: B1 / B4 one, B3 a run of pg
  // tiles along the swept operand from s0, beside cached tile ct
  const int sp = CACHE || PART ? blockIdx.y % g.splits : blockIdx.y;
  const int ct = CACHE ? blockIdx.y / g.splits : 0;
  const int s0 = CACHE ? blockIdx.x * g.pg : 0;
  const int ntile =
      CACHE ? min(g.pg, (CACHE == 1 ? (g.N + T::BN - 1) / T::BN
                                    : (g.M + T::BM - 1) / T::BM) - s0)
            : 1;
  auto origin = [&](int j, int& m0, int& n0) {
    if (CACHE == 1) {
      m0 = ct * T::BM;
      n0 = (s0 + j) * T::BN;
    } else if (CACHE == 2) {
      m0 = (s0 + j) * T::BM;
      n0 = ct * T::BN;
    } else {
      m0 = PART ? blockIdx.y / g.splits * T::BM
                : split ? 0 : blockIdx.y * T::BM;
      n0 = blockIdx.x * T::BN;
    }
  };
  const int seg_len = 32 * g.seg;
  // this block's K range: all of K, or one split inside one flush segment;
  // PART: one run of the piece of (global) segment seg that this cut holds
  int seg = 0, k0 = 0, k1 = g.K;
  if (PART) {
    seg = g.k_off / seg_len + sp / g.per;
    const int ps = max(seg * seg_len - g.k_off, 0);
    const int pe = min((seg + 1) * seg_len - g.k_off, g.K);
    k0 = min(ps + (sp % g.per) * 32 * g.run, pe);
    k1 = min(k0 + 32 * g.run, pe);
  } else if (split) {
    seg = sp / g.per;
    k0 = seg * seg_len + (sp % g.per) * 32 * g.run;
    k1 = min(min(k0 + 32 * g.run, seg_len * (seg + 1)), g.K);
  }
  const uint8_t* xb = g.x + bz * g.x_bs;
  const uint8_t* wb = g.w + bz * g.w_bs;
  int acc[kClasses][TA][TB][4];
  float tot[TA][TB][4];
#pragma unroll
  for (int ta = 0; ta < TA; ++ta)
#pragma unroll
    for (int tb = 0; tb < TB; ++tb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tot[ta][tb][i] = 0.f;
#pragma unroll
        for (int c = 0; c < kClasses; ++c) acc[c][ta][tb][i] = 0;
      }

  // the block's stream: stage s is K stage s % nst of its tile s / nst
  const int nst = k1 > k0 ? (k1 - k0 + kRK - 1) / kRK : 0;
  const int nstream = ntile * nst;
  auto stage_in = [&](int s) {
    const int j = CACHE ? s / nst : 0, t = CACHE ? s - j * nst : s;
    int m0, n0;
    origin(j, m0, n0);
    load_stage<LIMBS, T, CACHE>(smem + (s % L::STAGES) * L::STAGE, g, xb,
                                wb, m0, n0, k0 + t * kRK, k1, tid);
  };
  for (int s = 0; s < L::STAGES - 1; ++s) {
    if (s < nstream) stage_in(s);
    cp_async_commit();
  }
  if constexpr (!LIMBS) {   // while the first stages load
    fill_lut<EB, MB>(lut, tid, T::NT);
    __syncthreads();
    for (int i = tid; i < 256 * 32; i += T::NT) rep[i] = lut[i >> 5];
  }   // published by the first barrier of the loop
  // B3: the resident stripe of the cached tile, converted once (published
  // by the same barrier)
  const int plane = g.run * 8 * g.lines;   // words a resident limb plane
  int live = 0;
  if constexpr (CACHE != 0) {
    int m0, n0;
    origin(0, m0, n0);
    live = L::RES_A ? T::LA
                    : min(CACHE == 1 ? g.M - m0 : g.N - n0, T::LB);
    convert_resident<T, CACHE>(res, plane, g, xb, wb, m0, n0, k0, k1, live,
                               lut, tid);
  }
  const uint32_t* src_a = L::RES_A ? res : fa;
  const uint32_t* src_b = L::RES_B ? res : fb;
  const int pa = L::RES_A ? plane : kRW * T::LA;
  const int pb = L::RES_B ? plane : kRW * T::LB;
  const long long mn = (long long)g.M * g.N, cs = mn * gridDim.z;
  const int mtiles = (g.M + T::BM - 1) / T::BM;
  const int ntiles = (g.N + T::BN - 1) / T::BN;

  int u = 0;   // stages consumed
  for (int j = 0; j < ntile; ++j) {
    int m0, n0;
    origin(j, m0, n0);
    for (int t = 0; t < nst; ++t, ++u) {
      cp_async_wait<L::STAGES - 2>();   // stage u has landed (own copies)
      __syncthreads();                  // everyone's; the last mma pass is done
      const int s = u + L::STAGES - 1;  // refill the slot converted at u - 1
      if (s < nstream) stage_in(s);
      cp_async_commit();
      convert<LIMBS, T, CACHE>(smem + (u % L::STAGES) * L::STAGE, fa, fb,
                               rep, tid);
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int kend = k0 + t * kRK + 32 * (ks + 1);
        if (kend - 32 >= k1) break;
        const int kr = 2 * t + ks;   // the resident side's mma step
        mma_step<T, L::RES_B>(acc, src_a, pa, L::RES_A ? kr : ks, src_b, pb,
                              L::RES_B ? kr : ks, live, ya, yb, lane);
        if (!split && (kend % seg_len == 0 || kend >= k1)) {
#pragma unroll
          for (int ta = 0; ta < TA; ++ta)
#pragma unroll
            for (int tb = 0; tb < TB; ++tb)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                int cl[kClasses];
#pragma unroll
                for (int c = 0; c < kClasses; ++c) {
                  cl[c] = acc[c][ta][tb][i];
                  acc[c][ta][tb][i] = 0;
                }
                tot[ta][tb][i] = flush_classes(tot[ta][tb][i], cl);
              }
        }
      }
    }

    // accumulator (ta, tb, i) holds mma row 16 tile + g + 8 (i / 2) and
    // column 8 tile + 2 q + i % 2 of lane 4 g + q
    const int g8 = lane >> 2, q = lane & 3;
    auto element = [&](int ta, int tb, int i, int& m, int& n) {
      const int la = (ya * TA + ta) * 16 + g8 + 8 * (i >> 1);
      const int lb = (yb * TB + tb) * 8 + 2 * q + (i & 1);
      m = m0 + (T::SWAP ? lb : la);
      n = n0 + (T::SWAP ? la : lb);
    };
    if (!split) {
#pragma unroll
      for (int ta = 0; ta < TA; ++ta)
#pragma unroll
        for (int tb = 0; tb < TB; ++tb)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            int m, n;
            element(ta, tb, i, m, n);
            if (m < g.M && n < g.N)
              finish<EB, MB>(g, bz, m, n, tot[ta][tb][i]);
            tot[ta][tb][i] = 0.f;
          }
      continue;
    }

    // split: add the partials into the workspace, [segment][class][slice][M][N]
    int* wsb = g.ws + (long long)seg * kClasses * cs + bz * mn;
#pragma unroll
    for (int ta = 0; ta < TA; ++ta)
#pragma unroll
      for (int tb = 0; tb < TB; ++tb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          int m, n;
          element(ta, tb, i, m, n);
#pragma unroll
          for (int c = 0; c < kClasses; ++c) {
            if (m < g.M && n < g.N && acc[c][ta][tb][i])
              atomicAdd(wsb + c * cs + (long long)m * g.N + n,
                        acc[c][ta][tb][i]);
            acc[c][ta][tb][i] = 0;
          }
        }
    if constexpr (PART) continue;   // the flush entry flushes
    // the barrier orders the block's partials before thread 0's fence,
    // which releases them with the arrival (and acquires the other splits'
    // for the last arrival): the grid-barrier pattern of cooperative groups
    __syncthreads();
    int* cnt = g.cnt + ((long long)bz * mtiles + m0 / T::BM) * ntiles +
               n0 / T::BN;
    if (tid == 0) {
      __threadfence();
      last = atomicAdd(cnt, 1) == g.splits - 1;
      if (last) __threadfence();
    }
    __syncthreads();
    if (!last) continue;
    // the tile's last split: flush every segment in ascending order
    const int nseg = g.splits / g.per;
    static_assert(T::BM * T::BN % T::NT == 0, "whole rounds of outputs");
#pragma unroll
    for (int v = 0; v < T::BM * T::BN / T::NT; ++v) {
      const int o = tid + v * T::NT;
      const int m = m0 + o / T::BN, n = n0 + o % T::BN;
      if (m >= g.M || n >= g.N) continue;
      float r = 0.f;
      for (int s = 0; s < nseg; ++s) {
        int cl[kClasses];
#pragma unroll
        for (int c = 0; c < kClasses; ++c) {
          int* p = g.ws + (long long)(s * kClasses + c) * cs + bz * mn +
                   (long long)m * g.N + n;
          cl[c] = __ldcg(p);
          __stcg(p, 0);
        }
        r = flush_classes(r, cl);
      }
      finish<EB, MB>(g, bz, m, n, r);
    }
    if (tid == 0) *cnt = 0;
  }
}

template <bool LIMBS, int EB, int MB, class T, bool PART = false>
__global__ void __launch_bounds__(T::NT, (Layout<LIMBS, T>::MINB))
    exact_kernel(Args g) {
  exact_body<LIMBS, EB, MB, T, 0, PART>(g);
}

// The flush entry: output o adds the segments' class partials in ascending
// segment order, each with flush_classes, then B1's epilogue. part is
// [segment][class][slice][M][N].
template <int EB, int MB>
__global__ void __launch_bounds__(256)
    flush_kernel(Args g, const int* part, int nseg, int Bt) {
  const long long mn = (long long)g.M * g.N, total = mn * Bt;
  for (long long o = blockIdx.x * 256LL + threadIdx.x; o < total;
       o += (long long)gridDim.x * 256) {
    const int bz = int(o / mn);
    const long long r = o - bz * mn;
    float acc = 0.f;
    for (int s = 0; s < nseg; ++s) {
      int cl[kClasses];
#pragma unroll
      for (int c = 0; c < kClasses; ++c)
        cl[c] = part[(long long)(s * kClasses + c) * total + o];
      acc = flush_classes(acc, cl);
    }
    finish<EB, MB>(g, bz, int(r / g.N), int(r % g.N), acc);
  }
}

template <int EB, int MB, class T, int CACHE, bool PART = false>
__global__ void __launch_bounds__(T::NT, (Layout<false, T, CACHE>::MINB))
    exact_fused_stationary_kernel(Args g) {
  exact_body<false, EB, MB, T, CACHE, PART>(g);
}

template <bool LIMBS, int EB, int MB, class T, bool PART = false>
int launch_exact(const Args& g, int Bt, cudaStream_t stream) {
  using L = Layout<LIMBS, T>;
  auto kern = exact_kernel<LIMBS, EB, MB, T, PART>;
  static std::atomic<bool> attr_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = current_device(dev);
  if (err == cudaSuccess) err = smem_opt_in_once(kern, L::BYTES, attr_set, dev);
  if (err != cudaSuccess) return int(err);
  const long long gx = (g.N + T::BN - 1) / T::BN;
  const long long mt = (g.M + T::BM - 1) / T::BM;
  const long long gy = PART ? mt * g.splits : g.splits > 1 ? g.splits : mt;
  if (gx > 2147483647LL || gy > 65535 || Bt > 65535)
    return int(cudaErrorInvalidConfiguration);
  kern<<<dim3(unsigned(gx), unsigned(gy), unsigned(Bt)), T::NT, L::BYTES,
         stream>>>(g);
  return int(cudaGetLastError());
}

template <int EB, int MB, class T, int CACHE, bool PART = false>
int launch_stationary(const Args& g, int Bt, const StatPlan& p,
                      cudaStream_t stream) {
  auto kern = exact_fused_stationary_kernel<EB, MB, T, CACHE, PART>;
  static std::atomic<bool> attr_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = current_device(dev);
  if (err == cudaSuccess)
    err = smem_opt_in_once(kern, kStatBytes, attr_set, dev);
  if (err != cudaSuccess) return int(err);
  const long long cached =
      CACHE == 1 ? (g.M + T::BM - 1) / T::BM : (g.N + T::BN - 1) / T::BN;
  const long long gy = cached * g.splits;
  if (gy > 65535 || Bt > 65535 || p.bytes > kStatBytes)
    return int(cudaErrorInvalidConfiguration);
  kern<<<dim3(unsigned(p.groups), unsigned(gy), unsigned(Bt)), T::NT,
         p.bytes, stream>>>(g);
  return int(cudaGetLastError());
}

// Take the plan's split into the arguments and check the workspace: ws_len
// int32 for its segments' class sums, cnt_len tile counters (bm x bn tiles).
bool take_split(Args& g, const Plan& p, int Bt, int bm, int bn,
                long long ws_len, long long cnt_len) {
  g.splits = p.splits;
  g.per = p.per;
  g.run = p.run;
  g.seg = p.seg;
  if (p.splits == 1) return true;
  const long long ws_need =
      (long long)(p.splits / p.per) * kClasses * Bt * g.M * g.N;
  const long long cnt_need = (long long)Bt * ((g.M + bm - 1) / bm) *
                             ((g.N + bn - 1) / bn);
  return g.ws && g.cnt && ws_len >= ws_need && cnt_len >= cnt_need;
}

// The staging path: cp.async where every row is 16-byte aligned (and, for
// the partials entry, every piece starts on 16 elements: the cut's offset).
void take_async(Args& g) {
  g.async = ((reinterpret_cast<uintptr_t>(g.x) |
              reinterpret_cast<uintptr_t>(g.w)) & 15) == 0 &&
            g.K % 16 == 0 && g.N % 16 == 0 && g.k_off % 16 == 0;
}

// The partials entry's pieces: the flush segments of the whole K that this
// cut [k_off, k_off + K) touches, each cut into per runs of run units (at
// decode, where the tiles leave SMs idle, as split_plan cuts a segment;
// else one run a piece). A run lies inside one segment's piece.
Plan part_plan(int Bt, int M, int K, int N, int block_k, int fp, int k_off) {
  const int seg = fp * (block_k / 32), seg_len = 32 * seg;
  const long long nseg =
      ((long long)k_off + K - 1) / seg_len - k_off / seg_len + 1;
  const int units = (K + 31) / 32;
  const long long span = units < seg ? units : seg;
  long long per = 1, least = 1;
  if (M <= kDecodeRows) {
    const long long tiles =
        (long long)Bt * ((N + kDecodeCols - 1) / kDecodeCols);
    per = kSplitTarget / (tiles * nseg);
    if (per < 1) per = 1;
    least = kMinRun;
  }
  long long run = (span + per - 1) / per;
  if (run < least) run = least;
  per = (span + run - 1) / run;
  return {int(nseg * per), int(per), int(run), seg};
}

template <bool LIMBS, int EB, int MB>
int launch_part_fmt(Args g, int Bt, cudaStream_t stream) {
  const Plan p = part_plan(Bt, g.M, g.K, g.N, g.block_k, g.flush_period,
                           g.k_off);
  g.splits = p.splits;
  g.per = p.per;
  g.run = p.run;
  g.seg = p.seg;
  take_async(g);
  if (g.M <= 8)
    return launch_exact<LIMBS, EB, MB, Decode8, true>(g, Bt, stream);
  if (g.M <= kDecodeRows)
    return launch_exact<LIMBS, EB, MB, Decode16, true>(g, Bt, stream);
  return launch_exact<LIMBS, EB, MB, Prefill, true>(g, Bt, stream);
}

template <int EB, int MB>
int launch_flush(const Args& g, const int* part, int nseg, int Bt,
                 cudaStream_t stream) {
  const long long total = (long long)g.M * g.N * Bt;
  long long blocks = (total + 255) / 256;
  if (blocks > 16 * kSMs) blocks = 16 * kSMs;
  flush_kernel<EB, MB><<<unsigned(blocks), 256, 0, stream>>>(g, part, nseg,
                                                              Bt);
  return int(cudaGetLastError());
}

// Plan the split, check the workspace, pick the staging path and the tile.
template <bool LIMBS, int EB, int MB>
int launch_exact_fmt(Args g, int Bt, long long ws_len, long long cnt_len,
                     cudaStream_t stream) {
  const Plan p = split_plan(Bt, g.M, g.K, g.N, g.block_k, g.flush_period);
  if (!take_split(g, p, Bt, kDecodeRows, kDecodeCols, ws_len, cnt_len))
    return int(cudaErrorInvalidValue);
  take_async(g);
  if (g.M <= 8) return launch_exact<LIMBS, EB, MB, Decode8>(g, Bt, stream);
  if (g.M <= kDecodeRows)
    return launch_exact<LIMBS, EB, MB, Decode16>(g, Bt, stream);
  return launch_exact<LIMBS, EB, MB, Prefill>(g, Bt, stream);
}

template <int EB, int MB, class T, bool PART = false>
int launch_stationary_tile(const Args& g, int Bt, const StatPlan& p, bool cw,
                           cudaStream_t stream) {
  return cw ? launch_stationary<EB, MB, T, 2, PART>(g, Bt, p, stream)
            : launch_stationary<EB, MB, T, 1, PART>(g, Bt, p, stream);
}

// The stationary schedules' admission rule over g.K (kStripeBudget).
bool stripe_admitted(const Args& g, bool cw) {
  const long long kp =
      (long long)((g.K + g.block_k - 1) / g.block_k) * g.block_k;
  const int edge = cw || g.M > kDecodeRows ? 64 : g.M <= 4 ? 4 : 16;
  return 3 * kp * edge <= kStripeBudget;
}

// B3's partials: refuse what the admission rule refuses over the cut's K,
// then plan the pieces, pick the staging path and the tile.
template <int EB, int MB>
int launch_stationary_part_fmt(Args g, int Bt, bool cw, cudaStream_t stream) {
  if (!stripe_admitted(g, cw)) return int(cudaErrorInvalidValue);
  const StatPlan p = stationary_part_plan(Bt, g.M, g.K, g.N, g.block_k,
                                          g.flush_period, g.k_off, cw);
  g.splits = p.k.splits;
  g.per = p.k.per;
  g.run = p.k.run;
  g.seg = p.k.seg;
  g.lines = p.lines;
  g.pg = p.pg;
  take_async(g);
  if (g.M <= 8)
    return launch_stationary_tile<EB, MB, Decode8, true>(g, Bt, p, cw, stream);
  if (g.M <= kDecodeRows)
    return launch_stationary_tile<EB, MB, Decode16, true>(g, Bt, p, cw,
                                                          stream);
  return launch_stationary_tile<EB, MB, Prefill, true>(g, Bt, p, cw, stream);
}

// B3: refuse what the admission rule refuses, then plan, check the
// workspace, pick the staging path and the tile.
template <int EB, int MB>
int launch_stationary_fmt(Args g, int Bt, bool cw, long long ws_len,
                          long long cnt_len, cudaStream_t stream) {
  if (!stripe_admitted(g, cw)) return int(cudaErrorInvalidValue);
  const StatPlan p = stationary_plan(Bt, g.M, g.K, g.N, g.block_k,
                                     g.flush_period, cw);
  const int bm = g.M <= 8 ? 8 : g.M <= kDecodeRows ? kDecodeRows : 64;
  const int bn = g.M <= kDecodeRows ? kDecodeCols : 64;
  if (!take_split(g, p.k, Bt, bm, bn, ws_len, cnt_len))
    return int(cudaErrorInvalidValue);
  g.lines = p.lines;
  g.pg = p.pg;
  take_async(g);
  if (g.M <= 8)
    return launch_stationary_tile<EB, MB, Decode8>(g, Bt, p, cw, stream);
  if (g.M <= kDecodeRows)
    return launch_stationary_tile<EB, MB, Decode16>(g, Bt, p, cw, stream);
  return launch_stationary_tile<EB, MB, Prefill>(g, Bt, p, cw, stream);
}

Args codes_args(const void* x, const void* w, const void* scale,
                const void* bias, void* out, int M, int K, int N,
                long long x_bs, long long w_bs, int s_bs, int s_ns, int b_bs,
                int b_ns, int act, int block_k, int flush_period) {
  Args g;
  g.x = static_cast<const uint8_t*>(x);
  g.w = static_cast<const uint8_t*>(w);
  g.scale = static_cast<const float*>(scale);
  g.bias = static_cast<const float*>(bias);
  g.out = static_cast<float*>(out);
  g.M = M;
  g.K = K;
  g.N = N;
  g.x_bs = x_bs;
  g.w_bs = w_bs;
  g.s_bs = s_bs;
  g.s_ns = s_ns;
  g.b_bs = b_bs;
  g.b_ns = b_ns;
  g.act = act;
  g.block_k = block_k;
  g.flush_period = flush_period;
  return g;
}

}  // namespace

// C interface (ctypes). x: (Bt, M, K) u8 codes, w: (Bt, K, N) u8 codes (or
// one shared (K, N) with w_bs = 0), out: (Bt, M, N) f32. scale / bias may be
// null; element [b, n] of each sits at b * *_bs + n * *_ns (a stride of 0
// broadcasts). fmt: 0 = E4M3, 1 = E3M4. act: 0 none, 1 relu, 2 gelu, 3 silu.
// block_k must be a multiple of 32; flush_period is already clamped to
// [1, ceil(K / block_k)]. Each returns cudaGetLastError() after the launch.

// B1. ws / cnt: the split-K workspace (ws_len int32, zero) and tile counters
// (cnt_len int32, zero), left zero again; null when mgs_matmul_split_plan
// gives one split. Refuses (cudaErrorInvalidValue) a workspace too small.
extern "C" int mgs_matmul_exact_fused(
    const void* x, const void* w, const void* scale, const void* bias,
    void* out, int Bt, int M, int K, int N, long long x_bs, long long w_bs,
    int s_bs, int s_ns, int b_bs, int b_ns, int fmt, int act, int block_k,
    int flush_period, void* ws, long long ws_len, void* cnt,
    long long cnt_len, void* stream) {
  Args g = codes_args(x, w, scale, bias, out, M, K, N, x_bs, w_bs, s_bs, s_ns,
                      b_bs, b_ns, act, block_k, flush_period);
  g.ws = static_cast<int*>(ws);
  g.cnt = static_cast<int*>(cnt);
  auto st = static_cast<cudaStream_t>(stream);
  return fmt == 0 ? launch_exact_fmt<false, 4, 3>(g, Bt, ws_len, cnt_len, st)
                  : launch_exact_fmt<false, 3, 4>(g, Bt, ws_len, cnt_len, st);
}

// B3, the arguments of B1 plus cache_weight (1 = weight-stationary, 0 =
// activation-stationary) before the workspace, which is null when
// mgs_matmul_stationary_plan gives one split. Refuses
// (cudaErrorInvalidValue) a stripe over mgs_matmul_stripe_budget() bytes
// (the admission rule) and a workspace too small.
extern "C" int mgs_matmul_exact_fused_stationary(
    const void* x, const void* w, const void* scale, const void* bias,
    void* out, int Bt, int M, int K, int N, long long x_bs, long long w_bs,
    int s_bs, int s_ns, int b_bs, int b_ns, int fmt, int act, int block_k,
    int flush_period, int cache_weight, void* ws, long long ws_len,
    void* cnt, long long cnt_len, void* stream) {
  Args g = codes_args(x, w, scale, bias, out, M, K, N, x_bs, w_bs, s_bs, s_ns,
                      b_bs, b_ns, act, block_k, flush_period);
  g.ws = static_cast<int*>(ws);
  g.cnt = static_cast<int*>(cnt);
  auto st = static_cast<cudaStream_t>(stream);
  const bool cw = cache_weight != 0;
  return fmt == 0
             ? launch_stationary_fmt<4, 3>(g, Bt, cw, ws_len, cnt_len, st)
             : launch_stationary_fmt<3, 4>(g, Bt, cw, ws_len, cnt_len, st);
}

extern "C" long long mgs_matmul_stripe_budget() { return kStripeBudget; }

// The launchers' K split for these arguments (flush_period clamped as
// above): plan = {splits, per segment, run, segment}, in 32-element units.
extern "C" void mgs_matmul_split_plan(int Bt, int M, int K, int N,
                                      int block_k, int flush_period,
                                      int* plan) {
  const Plan p = split_plan(Bt, M, K, N, block_k, flush_period);
  plan[0] = p.splits;
  plan[1] = p.per;
  plan[2] = p.run;
  plan[3] = p.seg;
}

// B3's plan: {splits, per segment, run, segment, groups, tiles a group,
// resident lines, dynamic shared memory bytes}.
extern "C" void mgs_matmul_stationary_plan(int Bt, int M, int K, int N,
                                           int block_k, int flush_period,
                                           int cache_weight, int* plan) {
  const StatPlan p = stationary_plan(Bt, M, K, N, block_k, flush_period,
                                     cache_weight != 0);
  plan[0] = p.k.splits;
  plan[1] = p.k.per;
  plan[2] = p.k.run;
  plan[3] = p.k.seg;
  plan[4] = p.groups;
  plan[5] = p.pg;
  plan[6] = p.lines;
  plan[7] = p.bytes;
}

// B4. x: (Bt, 3, M, K) int8 limb planes (x_bs = 3 * M * K), w: (Bt, 3, K, N)
// (or one shared (3, K, N) with w_bs = 0), out: (Bt, M, N) f32 =
// (sum_k x w) * 2^-2(bias+mbits), no epilogue. fmt, block_k, flush_period
// and the workspace as for B1.
extern "C" int mgs_matmul_exact(const void* x, const void* w, void* out,
                                int Bt, int M, int K, int N, long long x_bs,
                                long long w_bs, int fmt, int block_k,
                                int flush_period, void* ws, long long ws_len,
                                void* cnt, long long cnt_len, void* stream) {
  Args g = codes_args(x, w, nullptr, nullptr, out, M, K, N, x_bs, w_bs, 0, 0,
                      0, 0, 0, block_k, flush_period);
  g.x_plane = (long long)M * K;
  g.w_plane = (long long)K * N;
  g.ws = static_cast<int*>(ws);
  g.cnt = static_cast<int*>(cnt);
  auto st = static_cast<cudaStream_t>(stream);
  return fmt == 0 ? launch_exact_fmt<true, 4, 3>(g, Bt, ws_len, cnt_len, st)
                  : launch_exact_fmt<true, 3, 4>(g, Bt, ws_len, cnt_len, st);
}

// The partials entry. x: (Bt, M, K) u8 codes, w: (Bt, K, N) u8 codes (or one
// shared (K, N) with w_bs = 0) holding K elements [k_off, k_off + K) of the
// whole K; flush_period: the whole K's, clamped as B1 clamps it. part:
// (segments of the whole K, 5, Bt, M, N) int32, zero on entry; this cut's
// class partials are added at their segments. fmt and block_k as for B1.
extern "C" int mgs_matmul_exact_partials(const void* x, const void* w,
                                         void* part, int Bt, int M, int K,
                                         int N, long long x_bs,
                                         long long w_bs, int fmt, int block_k,
                                         int flush_period, int k_off,
                                         void* stream) {
  Args g = codes_args(x, w, nullptr, nullptr, nullptr, M, K, N, x_bs, w_bs, 0,
                      0, 0, 0, 0, block_k, flush_period);
  g.ws = static_cast<int*>(part);
  g.k_off = k_off;
  auto st = static_cast<cudaStream_t>(stream);
  return fmt == 0 ? launch_part_fmt<false, 4, 3>(g, Bt, st)
                  : launch_part_fmt<false, 3, 4>(g, Bt, st);
}

// B4's partials entry: B1's partials entry over limb planes. x: (Bt, 3, M,
// K) int8 limb planes (x_bs = 3 * M * K), w: (Bt, 3, K, N) (or one shared
// (3, K, N) with w_bs = 0), both holding K elements [k_off, k_off + K) of
// the whole K; the rest as for mgs_matmul_exact_partials. Its partials are
// B1's class sums, so mgs_matmul_exact_flush closes them.
extern "C" int mgs_matmul_exact_limb_partials(const void* x, const void* w,
                                              void* part, int Bt, int M,
                                              int K, int N, long long x_bs,
                                              long long w_bs, int fmt,
                                              int block_k, int flush_period,
                                              int k_off, void* stream) {
  Args g = codes_args(x, w, nullptr, nullptr, nullptr, M, K, N, x_bs, w_bs, 0,
                      0, 0, 0, 0, block_k, flush_period);
  g.x_plane = (long long)M * K;
  g.w_plane = (long long)K * N;
  g.ws = static_cast<int*>(part);
  g.k_off = k_off;
  auto st = static_cast<cudaStream_t>(stream);
  return fmt == 0 ? launch_part_fmt<true, 4, 3>(g, Bt, st)
                  : launch_part_fmt<true, 3, 4>(g, Bt, st);
}

// B3's partials entry: the arguments of B1's plus cache_weight (as for B3).
// Refuses (cudaErrorInvalidValue) a stripe over mgs_matmul_stripe_budget()
// bytes for the cut's K (the dispatch falls back to B1's partials first).
extern "C" int mgs_matmul_stationary_partials(
    const void* x, const void* w, void* part, int Bt, int M, int K, int N,
    long long x_bs, long long w_bs, int fmt, int block_k, int flush_period,
    int k_off, int cache_weight, void* stream) {
  Args g = codes_args(x, w, nullptr, nullptr, nullptr, M, K, N, x_bs, w_bs, 0,
                      0, 0, 0, 0, block_k, flush_period);
  g.ws = static_cast<int*>(part);
  g.k_off = k_off;
  auto st = static_cast<cudaStream_t>(stream);
  const bool cw = cache_weight != 0;
  return fmt == 0 ? launch_stationary_part_fmt<4, 3>(g, Bt, cw, st)
                  : launch_stationary_part_fmt<3, 4>(g, Bt, cw, st);
}

// The flush entry. part: (nseg, 5, Bt, M, N) int32 summed partials; out:
// (Bt, M, N) f32 = act(flushed * 2^-2(bias+mbits) * scale + bias), scale /
// bias strided as for B1.
extern "C" int mgs_matmul_exact_flush(const void* part, const void* scale,
                                      const void* bias, void* out, int nseg,
                                      int Bt, int M, int N, int s_bs,
                                      int s_ns, int b_bs, int b_ns, int fmt,
                                      int act, void* stream) {
  Args g = codes_args(nullptr, nullptr, scale, bias, out, M, 0, N, 0, 0, s_bs,
                      s_ns, b_bs, b_ns, act, 32, 1);
  auto st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(part);
  return fmt == 0 ? launch_flush<4, 3>(g, p, nseg, Bt, st)
                  : launch_flush<3, 4>(g, p, nseg, Bt, st);
}
