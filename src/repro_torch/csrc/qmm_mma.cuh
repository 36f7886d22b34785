// The int8 tensor-core tile of the quantized dense kernels at prefill M
// (M > 8) for Hopper (sm_90a), shared by fused_qmm.cu and packed_qmm.cu
// the way flash_mma.cuh serves both flash kernels.  At M <= 8 both keep
// their GEMV kernel (qmm_gemv.cuh); tests/test_torch_qmm_tile.py
// emulates this file's arithmetic on the CPU.
//
// What bounds it: int8 operations (2 M K N at M = 256 is 50 us a layer of
// qwen3-8b at the 1,979 TOP/s peak), then what the reference's order adds
// per cluster -- the weight decode, the float32 rescale -- and the L2
// traffic of re-reading the int8 rows of x once per block column.
//
// A block owns a kBM x kBN (128 x 128) output tile, 8 warps of 64 x 32,
// and walks its k range in stages of kKs = 128 elements (64 at group 16):
//   - a ring of stages in shared memory, filled by cp.async: the block's
//     int8 rows of x (activations quantized once per row, by fused_qmm.cu's
//     pre-pass or the caller's quantize_rows), the raw weight words and the
//     int8 scale mantissas;
//   - one stage ahead of the products, the raw words are decoded into the
//     B operand's K-major layout [n][k] (ternary: 16 2-bit codes through a
//     byte_perm table; int4 / nf4: lut4; int8: 4 x 4 byte transposes), and
//     each cluster's scale mantissa into float32 (sm, -1.5 * 2^23 * sm);
//   - rows of both tiles are kKs bytes with their 16-byte chunks XOR-
//     swizzled by the row, so the eight rows of an ldmatrix and the decode's
//     stores fall on distinct banks;
//   - each warp takes A and B through ldmatrix and runs
//     mma.sync m16n8k32 (m16n8k16 at group 16) s8 x s8 -> s32: the mma of
//     all 16 C fragments of a cluster back to back (independent), then
//     their conversions.
// The stage's fixed work (copies, decode, addresses) is kept small: every
// per-thread loop has a compile-time trip count (a runtime bound compiles
// into a generic loop several times the stage's size), k-tiles end on
// stage boundaries (no per-cluster division), and a warp's 64 x 32 tile
// spreads it over 32 mma a stage.  K is any multiple of the cluster: a
// ragged last k-tile (gemma3's 3840 = 7 x 512 + 256) ends on the stage
// that holds K, whose copies past K are zero-filled -- x's zero rows make
// those clusters' dots 0, and RN(0 * 0) added to a sum leaves it as it is.  What remains: the phases of a stage
// (ldmatrix and mma, conversions, decode, copies) run one after another
// between the block's barriers (PERF.md, the qdense tile).
//
// The reference's order (repro/kernels/_common.py, fused_qmm.py's
// cluster_sums): per cluster an exact int32 dot, times its scale mantissa,
// added in cluster order into a k-tile sum that starts at 0; the k-tile
// sums added in tile order into the output, which starts at 0.  A cluster's
// int32 dot is exact in whatever order the tensor core sums it, so only the
// float adds keep an order: each C fragment of a cluster starts at the bits
// of 1.5 * 2^23 (the first mma's C operand), so its result d holds
// 1.5 * 2^23 + dot as a float32; fma(d, sm, -1.5 * 2^23 * sm) is the exact
// dot * sm rounded once, which is the reference's float(dot) * sm.  That
// needs |dot| < 2^22: |dot| <= group * 128 * 128 = 2^21 at the largest
// group the wrapper admits (128).  The product is added (__fadd_rn) into
// the k-tile sum in registers; at a k-tile's end that goes into the
// output sum, which lives in shared memory (one slot per thread and
// element, so no other thread touches it), or, for a later split, to its
// slot of the scratch, and restarts at 0.
//
// An MoE expert site (packed_qmm over E experts, one launch) stacks the
// experts on the grid's y, E x the row blocks: a block finds its expert
// there; the Loader starts at that expert's x (E, M, K), weights (E, ...)
// and scale mantissas (E, K / G, N), the epilogue at its out (E, M, N) and
// split scratch; the arrival counters are one per block column and row of
// the whole grid.  The reference vmaps its pallas_call over the experts, a
// batch axis of the grid: each expert's sums are bit for bit its own
// launch's.
//
// Sites whose output blocks fill at most half the SMs (chunks of up to 128
// rows) split their k-tiles over grid.z when the scratch stays small (the
// wrapper's tile_plan): the first split
// keeps its running output, each later split writes every k-tile sum to
// its own scratch slot, and the last block of the output tile to arrive
// (an arrival counter, reset after use) adds the slots in tile order, so
// the order is the reference's for any split.  Then the epilogue: x
// 2**(scale_e + e), + bias, activation (fused), or the raw sums
// (packed_qmm).
#pragma once

#include "qmm_common.cuh"

namespace qmm {
namespace tile {
// Internal linkage: fused_qmm.cu and packed_qmm.cu build into two libraries
// loaded into one process, and a function-local static of a template with
// external linkage (launch's `configured`) would be one object for both.
namespace {

constexpr int kBM = 128;       // output rows of a block
constexpr int kBN = 128;       // output columns of a block
constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N
constexpr int kWarpsN = 4;
constexpr int kWM = 64, kWN = 32;             // one warp's output tile
constexpr int kMi = kWM / 16, kNi = kWN / 8;  // its m16n8 C fragments
constexpr int kOut = kMi * kNi * 4;           // output sums a thread
constexpr int kMagicBits = 0x4B400000;        // the float 1.5 * 2^23
constexpr float kMagic = 12582912.0f;

template <int D, int G>
struct Plan {
  static constexpr int kKs = G == 16 ? 64 : 128;  // k of one stage
  static constexpr int kRing = kKs == 64 ? 4 : 3;  // stages in flight (shared memory at kKs = 128)
  static constexpr int kChunks = kKs / 16;     // 16-byte chunks of a tile row
  static constexpr int kClusters = kKs / G;
  static constexpr int kWRows = D == kInt8 ? kKs : kKs / Layout<D>::kUnitK;  // raw weight rows a stage
  static constexpr int kW = D == kInt8 ? kKs * kBN : kWRows * kBN * 4;
  static constexpr int kA = kBM * kKs;           // int8 rows of x
  static constexpr int kS = kClusters * kBN;     // int8 scale mantissas
  static constexpr int kB = kBN * kKs;           // decoded weights, [n][k]
  static constexpr int kF = 2 * kClusters * kBN * 4;  // float (sm, -kMagic * sm)
  static constexpr int kOffW = kRing * kA;
  static constexpr int kOffS = kOffW + kRing * kW;
  static constexpr int kOffB = kOffS + kRing * kS;
  static constexpr int kOffF = kOffB + 2 * kB;
  static constexpr int kOffO = kOffF + 2 * kF;
  static constexpr int kSmem = kOffO + kOut * kThreads * 4;  // + the output sums
};

// f(i) for i = threadIdx.x, threadIdx.x + kThreads, ... below N: a loop
// with a compile-time trip count.
template <int N, typename F>
__device__ __forceinline__ void each(F&& f) {
#pragma unroll
  for (int it = 0; it < (N + kThreads - 1) / kThreads; ++it) {
    const int i = static_cast<int>(threadIdx.x) + it * kThreads;
    if (N % kThreads == 0 || i < N) f(i);
  }
}

// Byte offset of 16-byte chunk c of row r in a [rows][KS] tile: the chunk
// index XOR (r / 2) % 4 (KS = 64: two rows a 128-byte bank line) or r % 8
// (KS = 128), so 8 consecutive rows at one logical chunk hit 8 bank groups.
template <int KS>
__device__ __forceinline__ int tile_off(int r, int c) {
  const int swz = KS == 64 ? (r >> 1) & 3 : r & 7;
  return r * KS + ((c ^ swz) << 4);
}

// Raw int8 weights of a stage, [KS][kBN] bytes: chunk c of row r at c ^ (r / 4) % 8,
// so the decode's 4-row reads spread over the banks.
__device__ __forceinline__ int raw8_off(int r, int c) { return r * kBN + ((c ^ ((r >> 2) & 7)) << 4); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// the same with every element of C equal to c (a cluster's first mma)
__device__ __forceinline__ void mma_k32_c(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1, int c) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(c));
}
__device__ __forceinline__ void mma_k16_c(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t b, int c) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "r"(c));
}

// 16 ternary codes (code i in bits 2i..2i+1) -> 16 int8 weights ((c + 1) & 3) - 1
// in k order: the even and odd codes as nibbles select from the table
// {0, 1, 2, -1}, then the two byte streams interleave.
__device__ __forceinline__ uint4 decode_ternary16(unsigned w) {
  constexpr unsigned kTable = 0xFF020100u;
  const unsigned ev = w & 0x33333333u, od = (w >> 2) & 0x33333333u;  // nibble j: code 2j, code 2j + 1
  const unsigned e0 = __byte_perm(kTable, 0, ev), e1 = __byte_perm(kTable, 0, ev >> 16);
  const unsigned o0 = __byte_perm(kTable, 0, od), o1 = __byte_perm(kTable, 0, od >> 16);
  return make_uint4(__byte_perm(e0, o0, 0x5140), __byte_perm(e0, o0, 0x7362), __byte_perm(e1, o1, 0x5140),
                    __byte_perm(e1, o1, 0x7362));
}

struct Args {
  const int8_t* xq;     // (M, K) int8 mantissas
  const void* w;        // packed weights
  const int8_t* sm;     // (K / G, N) scale mantissas
  const float* e;       // (M) float exponents; nullptr: write the raw sums (packed_qmm)
  const int* scale_e;   // the weights' shared exponent (fused)
  const float* bias;    // (N) or nullptr
  float* out;           // (M, N)
  float* ws;            // splits > 1: slot 0 the first split's sum, slot i its i-th later k-tile
  int* counters;        // splits > 1: one zeroed arrival counter per output tile
  int M, K, N, bk, tps, splits, act;
  uint4 lut;
};

// One thread's share of a stage's cp.async copies, planned once per block:
// source pointers at the block's first stage (each stage moves them on by
// kKs elements of k), shared-memory offsets and column guards.
template <int D, int G>
struct Loader {
  using P = Plan<D, G>;
  static constexpr int KS = P::kKs;
  static constexpr int kAc = kBM * P::kChunks, kAIt = (kAc + kThreads - 1) / kThreads;
  static constexpr int kWc = D == kInt8 ? KS * (kBN / 16) : P::kWRows * (kBN / 4);
  static constexpr int kWIt = (kWc + kThreads - 1) / kThreads;
  static constexpr int kSc = P::kClusters * (kBN / 4);
  const int8_t* a_src[kAIt];
  int a_dst[kAIt];
  bool a_ok[kAIt];
  const unsigned char* w_src[kWIt];
  int w_dst[kWIt], w_col[kWIt];
  const int8_t* s_src;
  int s_dst;
  bool s_ok;
  size_t w_step, s_step;  // bytes of weights and scale rows a stage
  int a_k[kAIt], w_k[kWIt], s_k;  // k of each copy within its stage
  int k_left;                     // K - k_begin: copies at or past it are zero-filled

  __device__ __forceinline__ Loader(const Args& a, int ex, int k_begin, int row0, int col0) {
    const int tid = threadIdx.x;
    k_left = a.K - k_begin;
    const int8_t* xq = a.xq + static_cast<size_t>(ex) * a.M * a.K;  // expert ex's rows, weights and scales
    const unsigned char* w = static_cast<const unsigned char*>(a.w) +
        static_cast<size_t>(ex) * (D == kInt8 ? a.K : a.K / Layout<D>::kUnitK * 4) * a.N;
    const int8_t* sm = a.sm + static_cast<size_t>(ex) * (a.K / G) * a.N;
#pragma unroll
    for (int it = 0; it < kAIt; ++it) {
      const int i = tid + it * kThreads, r = i / P::kChunks, c = i % P::kChunks, m = row0 + r;
      a_k[it] = 16 * c;
      a_ok[it] = (kAc % kThreads == 0 || i < kAc) && m < a.M;
      a_src[it] = a_ok[it] ? xq + static_cast<size_t>(m) * a.K + k_begin + 16 * c : a.xq;
      a_dst[it] = tile_off<KS>(r, c);
    }
#pragma unroll
    for (int it = 0; it < kWIt; ++it) {
      const int i = tid + it * kThreads;
      if constexpr (D == kInt8) {
        const int r = i / (kBN / 16), c = i % (kBN / 16);
        w_k[it] = r;
        w_col[it] = col0 + 16 * c;
        w_src[it] = w + static_cast<size_t>(k_begin + r) * a.N + col0 + 16 * c;
        w_dst[it] = raw8_off(r, c);
      } else {
        const int r = i / (kBN / 4), c = i % (kBN / 4);
        w_k[it] = r * Layout<D>::kUnitK;
        w_col[it] = col0 + 4 * c;
        w_src[it] = w + (static_cast<size_t>(k_begin / Layout<D>::kUnitK + r) * a.N + col0 + 4 * c) * 4;
        w_dst[it] = (r * kBN + 4 * c) * 4;
      }
    }
    w_step = D == kInt8 ? static_cast<size_t>(KS) * a.N : static_cast<size_t>(P::kWRows) * a.N * 4;
    const int r = tid / (kBN / 4), c = tid % (kBN / 4);
    s_ok = tid < kSc && col0 + 4 * c < a.N;
    s_k = r * G;
    s_src = sm + static_cast<size_t>(k_begin / G + r) * a.N + col0 + 4 * c;
    s_dst = P::kOffS + r * kBN + 4 * c;
    s_step = static_cast<size_t>(P::kClusters) * a.N;
  }

  // stage s (of the block's k range) into ring slot `slot`
  __device__ __forceinline__ void issue(unsigned char* smem, int slot, int s, const Args& a) const {
    unsigned char* As = smem + slot * P::kA;
    const int left = k_left - s * KS;  // k of this stage below K
#pragma unroll
    for (int it = 0; it < kAIt; ++it) {
      const bool ok = a_ok[it] && a_k[it] < left;
      cp16(As + a_dst[it], ok ? a_src[it] + static_cast<size_t>(s) * KS : a.xq, ok);
    }
    unsigned char* Ws = smem + P::kOffW + slot * P::kW;
#pragma unroll
    for (int it = 0; it < kWIt; ++it) {
      if (kWc % kThreads != 0 && static_cast<int>(threadIdx.x) + it * kThreads >= kWc) continue;
      const unsigned char* src = w_src[it] + s * w_step;
      const int col = w_k[it] < left ? w_col[it] : a.N;  // past K: as past N, zero-filled
      if (D != kInt8 || (a.N & 15) == 0) {
        cp16(Ws + w_dst[it], col < a.N ? src : a.w, col < a.N);
      } else {  // int8 rows only 4-byte aligned
#pragma unroll
        for (int j = 0; j < 4; ++j) cp4(Ws + w_dst[it] + 4 * j, col + 4 * j < a.N ? src + 4 * j : a.w, col + 4 * j < a.N);
      }
    }
    if (threadIdx.x < kSc) {
      const bool ok = s_ok && s_k < left;
      cp4(smem + s_dst + slot * P::kS, ok ? s_src + s * s_step : a.sm, ok);
    }
  }
};

// Ring slot `slot` -> decoded weights and float scales of buffer `buf`.
template <int D, int G>
__device__ __forceinline__ void decode_stage(unsigned char* smem, int slot, int buf, const uint4& lut) {
  using P = Plan<D, G>;
  constexpr int KS = P::kKs;
  const unsigned char* Ws = smem + P::kOffW + slot * P::kW;
  const int8_t* Ss = reinterpret_cast<const int8_t*>(smem + P::kOffS + slot * P::kS);
  unsigned char* Bs = smem + P::kOffB + buf * P::kB;
  float* Fs = reinterpret_cast<float*>(smem + P::kOffF + buf * P::kF);
  each<P::kClusters * kBN>([&](int i) {
    const float s = static_cast<float>(Ss[i]);
    Fs[i] = s;
    Fs[P::kClusters * kBN + i] = __fmul_rn(-kMagic, s);  // exact: s has at most 8 significant bits
  });
  if constexpr (D == kTernary) {
    const unsigned* wv = reinterpret_cast<const unsigned*>(Ws);
    each<(KS / 16) * kBN>([&](int i) {
      const int c = i / kBN, n = i % kBN;  // word row c of column n: k 16c..16c+15
      *reinterpret_cast<uint4*>(Bs + tile_off<KS>(n, c)) = decode_ternary16(wv[i]);
    });
  } else if constexpr (D == kLut4) {
    const unsigned* wv = reinterpret_cast<const unsigned*>(Ws);
    each<(KS / 16) * kBN>([&](int i) {
      const int c = i / kBN, n = i % kBN;  // word rows 2c, 2c + 1: k 16c..16c+15
      const unsigned w0 = wv[2 * c * kBN + n], w1 = wv[(2 * c + 1) * kBN + n];
      *reinterpret_cast<uint4*>(Bs + tile_off<KS>(n, c)) =
          make_uint4(static_cast<unsigned>(lut4(w0, lut)), static_cast<unsigned>(lut4(w0 >> 16, lut)),
                     static_cast<unsigned>(lut4(w1, lut)), static_cast<unsigned>(lut4(w1 >> 16, lut)));
    });
  } else {
    each<(KS / 4) * (kBN / 4)>([&](int i) {
      const int kq = i % (KS / 4), nq = i / (KS / 4);  // k 4kq..4kq+3 of columns 4nq..4nq+3
      unsigned r[4], c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r[j] = *reinterpret_cast<const unsigned*>(Ws + raw8_off(4 * kq + j, nq >> 2) + 4 * (nq & 3));
      transpose4(r, c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<unsigned*>(Bs + tile_off<KS>(4 * nq + j, kq >> 2) + 4 * (kq & 3)) = c[j];
    });
  }
}

// The finished value of output (m, n) from its sum o.
__device__ __forceinline__ float finish(const Args& a, float o, int m, int n, float se) {
  if (a.e == nullptr) return o;
  float y = __fmul_rn(o, exp2i_f(__fadd_rn(se, a.e[m])));
  if (a.bias != nullptr) y = __fadd_rn(y, a.bias[n]);
  return activate(y, a.act);
}

// acc += (the cluster's dot) * sm for every C fragment, rounded as the
// reference: fma(1.5 * 2^23 + dot, sm, -1.5 * 2^23 * sm) = RN(dot * sm), then
// one __fadd_rn.  cl: the cluster within the stage; col: this lane's first
// column in the block.
template <typename P>
__device__ __forceinline__ void convert(float (&acc)[kMi][kNi][4], const int (&d)[kMi][kNi][4], const float* Fs,
                                        int cl, int col) {
#pragma unroll
  for (int ni = 0; ni < kNi; ++ni) {
    const float2 fs = *reinterpret_cast<const float2*>(Fs + cl * kBN + col + 8 * ni);
    const float2 fn = *reinterpret_cast<const float2*>(Fs + (P::kClusters + cl) * kBN + col + 8 * ni);
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e], __fmaf_rn(__int_as_float(d[mi][ni][e]), (e & 1) ? fs.y : fs.x,
                                                             (e & 1) ? fn.y : fn.x));
  }
}

template <int D, int G>
__global__ void __launch_bounds__(kThreads, 1) qmm_tile_kernel(const Args a) {
  using P = Plan<D, G>;
  constexpr int KS = P::kKs, kRing = P::kRing;
  constexpr int kSpan = G > 32 ? G : 32;  // k of one step of the product loop
  constexpr int kSteps = kSpan / 32;      // its mma k32 steps
  extern __shared__ __align__(128) unsigned char tile_smem[];
  unsigned char* smem = tile_smem;
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int g = lane >> 2, t4 = lane & 3;
  const int mblocks = (a.M + kBM - 1) / kBM, ex = blockIdx.y / mblocks;  // the expert (see the header), else 0
  const int row0 = (blockIdx.y - ex * mblocks) * kBM, col0 = blockIdx.x * kBN, z = blockIdx.z;
  const int nk = (a.K + a.bk - 1) / a.bk;
  const int t_begin = z * a.tps, t_end = min(nk, t_begin + a.tps);
  const int k_begin = t_begin * a.bk;
  const int tile_stages = a.bk / KS;  // the wrapper makes k-tiles whole stages (a ragged last one: fewer)
  const int n_stages = (min(t_end * a.bk, a.K) - k_begin + KS - 1) / KS;
  const size_t plane = static_cast<size_t>(a.M) * a.N;
  // ldmatrix offsets of this lane, fixed for the kernel: A matrices (rows 0-7,
  // 8-15) x (k 0-15, 16-31); B matrices (k 0-15, 16-31) x (n 0-7, 8-15)
  int a_off[kMi][KS / 32], b_off[kNi / 2][KS / 32];
#pragma unroll
  for (int q = 0; q < KS / 32; ++q) {
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi)
      a_off[mi][q] = tile_off<KS>(wm * kWM + 16 * mi + (lane & 7) + 8 * ((lane >> 3) & 1), 2 * q + (lane >> 4));
#pragma unroll
    for (int np = 0; np < kNi / 2; ++np)
      b_off[np][q] = tile_off<KS>(wn * kWN + 16 * np + (lane & 7) + 8 * (lane >> 4), 2 * q + ((lane >> 3) & 1));
  }
  // this thread's output sums: element (mi, ni, e) at os[((mi * kNi + ni) * 4 + e) * kThreads]
  float* os = reinterpret_cast<float*>(smem + P::kOffO) + tid;
  const Loader<D, G> ld(a, ex, k_begin, row0, col0);

  float acc[kMi][kNi][4];
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f, os[((mi * kNi + ni) * 4 + e) * kThreads] = 0.0f;

#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) {
    if (i < n_stages) ld.issue(smem, i, i, a);
    commit();
  }
  wait_group<kRing - 2>();
  __syncthreads();
  if (n_stages > 0) decode_stage<D, G>(smem, 0, 0, a.lut);

  int slot = 0, in_tile = 0, tl = 0;  // tl: k-tiles of this split closed so far
  for (int s = 0; s < n_stages; ++s) {
    wait_group<kRing - 3>();  // stage s + 1 has landed
    __syncthreads();          // stage s decoded; slot (s - 1) % kRing and buffer (s + 1) % 2 free
    const int next = slot == 0 ? kRing - 1 : slot - 1;  // (s + kRing - 1) % kRing
    if (s + kRing - 1 < n_stages) ld.issue(smem, next, s + kRing - 1, a);
    commit();
    const unsigned char* As = smem + slot * P::kA;
    const unsigned char* Bs = smem + P::kOffB + (s & 1) * P::kB;
    const float* Fs = reinterpret_cast<const float*>(smem + P::kOffF + (s & 1) * P::kF);
#pragma unroll
    for (int sp = 0; sp < KS / kSpan; ++sp) {
      int d[kMi][kNi][4];  // a cluster's C fragments, all mma issued before any conversion
      if constexpr (G == 16) {  // one k32 step holds two clusters: k16 mma on its halves
        uint32_t af[kMi][4], bf[kNi][2];
#pragma unroll
        for (int mi = 0; mi < kMi; ++mi) ldsm_x4(af[mi], As + a_off[mi][sp]);
#pragma unroll
        for (int np = 0; np < kNi / 2; ++np) {
          uint32_t r[4];
          ldsm_x4(r, Bs + b_off[np][sp]);
          bf[2 * np][0] = r[0], bf[2 * np][1] = r[1], bf[2 * np + 1][0] = r[2], bf[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
            for (int ni = 0; ni < kNi; ++ni)
              mma_k16_c(d[mi][ni], af[mi][2 * j], af[mi][2 * j + 1], bf[ni][j], kMagicBits);
          convert<P>(acc, d, Fs, 2 * sp + j, wn * kWN + 2 * t4);
        }
      } else {
#pragma unroll
        for (int st = 0; st < kSteps; ++st) {
          uint32_t af[kMi][4], bf[kNi][2];
#pragma unroll
          for (int mi = 0; mi < kMi; ++mi) ldsm_x4(af[mi], As + a_off[mi][sp * kSteps + st]);
#pragma unroll
          for (int np = 0; np < kNi / 2; ++np) {
            uint32_t r[4];
            ldsm_x4(r, Bs + b_off[np][sp * kSteps + st]);
            bf[2 * np][0] = r[0], bf[2 * np][1] = r[1], bf[2 * np + 1][0] = r[2], bf[2 * np + 1][1] = r[3];
          }
#pragma unroll
          for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
            for (int ni = 0; ni < kNi; ++ni) {
              if (st == 0)
                mma_k32_c(d[mi][ni], af[mi], bf[ni][0], bf[ni][1], kMagicBits);
              else
                mma_k32(d[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
            }
        }
        convert<P>(acc, d, Fs, sp, wn * kWN + 2 * t4);
      }
    }
    if (++in_tile == tile_stages || s + 1 == n_stages) {  // a k-tile closes: into the output sums, or to
      in_tile = 0;                                         // this split's slot
      ++tl;
      if (z == 0) {
#pragma unroll
        for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
          for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float& o = os[((mi * kNi + ni) * 4 + e) * kThreads];
              o = __fadd_rn(o, acc[mi][ni][e]);
            }
      } else {
        // tile t = t_begin + tl - 1 goes to slot t - tps + 1
        float* ws = a.ws + (static_cast<size_t>(ex) * (1 + nk - a.tps) + (z - 1) * a.tps + tl) * plane;
#pragma unroll
        for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
          for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int m = row0 + wm * kWM + 16 * mi + g + 8 * h, n = col0 + wn * kWN + 8 * ni + 2 * t4;
              if (m < a.M && n < a.N)
                *reinterpret_cast<float2*>(ws + static_cast<size_t>(m) * a.N + n) =
                    make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
            }
      }
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
    }
    if (s + 1 < n_stages) decode_stage<D, G>(smem, slot == kRing - 1 ? 0 : slot + 1, (s + 1) & 1, a.lut);
    slot = slot == kRing - 1 ? 0 : slot + 1;
  }

  const float se = a.e != nullptr ? static_cast<float>(a.scale_e[0]) : 0.0f;
  float* const out = a.out + ex * plane;  // this expert's output and split scratch
  float* const ws0 = a.splits == 1 ? nullptr : a.ws + static_cast<size_t>(ex) * (1 + nk - a.tps) * plane;
  if (a.splits == 1 || z == 0) {
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = row0 + wm * kWM + 16 * mi + g + 8 * h, n = col0 + wn * kWN + 8 * ni + 2 * t4;
          if (m >= a.M || n >= a.N) continue;
          const float o0 = os[((mi * kNi + ni) * 4 + 2 * h) * kThreads];
          const float o1 = os[((mi * kNi + ni) * 4 + 2 * h + 1) * kThreads];
          const size_t i = static_cast<size_t>(m) * a.N + n;
          if (a.splits == 1)
            *reinterpret_cast<float2*>(out + i) = make_float2(finish(a, o0, m, n, se), finish(a, o1, m, n + 1, se));
          else
            *reinterpret_cast<float2*>(ws0 + i) = make_float2(o0, o1);
        }
    if (a.splits == 1) return;
  }

  // the last block of the output tile to arrive adds the slots in tile order,
  // 16 groups of four columns a thread
  __threadfence();
  __syncthreads();
  int* counter = a.counters + blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) is_last = atomicAdd(counter, 1) == a.splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int slots = 1 + nk - a.tps;
  constexpr int kItems = kBM * (kBN / 4) / kThreads;  // float4 groups a thread
  float4 o[kItems];
  for (int sl = 0; sl < slots; ++sl) {  // every item's load of a slot in flight, then the adds in slot order
    float4 v[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = tid + it * kThreads, m = row0 + i / (kBN / 4), n = col0 + 4 * (i % (kBN / 4));
      if (m < a.M && n < a.N)
        v[it] = __ldcg(reinterpret_cast<const float4*>(ws0 + sl * plane + static_cast<size_t>(m) * a.N + n));
    }
#pragma unroll
    for (int it = 0; it < kItems; ++it)
      o[it] = sl == 0 ? v[it]
                      : make_float4(__fadd_rn(o[it].x, v[it].x), __fadd_rn(o[it].y, v[it].y),
                                    __fadd_rn(o[it].z, v[it].z), __fadd_rn(o[it].w, v[it].w));
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = tid + it * kThreads, m = row0 + i / (kBN / 4), n = col0 + 4 * (i % (kBN / 4));
    if (m < a.M && n < a.N)
      *reinterpret_cast<float4*>(out + static_cast<size_t>(m) * a.N + n) =
          make_float4(finish(a, o[it].x, m, n, se), finish(a, o[it].y, m, n + 1, se),
                      finish(a, o[it].z, m, n + 2, se), finish(a, o[it].w, m, n + 3, se));
  }
  if (tid == 0) *counter = 0;  // ready for the next call
}

template <int D, int G>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream, int experts) {
  if (smem != static_cast<size_t>(Plan<D, G>::kSmem)) return cudaErrorInvalidValue;  // the wrapper's sizing disagrees
  auto kernel = qmm_tile_kernel<D, G>;
  static bool configured = false;
  const cudaError_t err = raise_smem_cap(kernel, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + kBN - 1) / kBN, (a.M + kBM - 1) / kBM * experts, a.splits);
  kernel<<<grid, kThreads, Plan<D, G>::kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_group(int group, const Args& a, size_t smem, cudaStream_t s, int experts) {
  switch (group) {
    case 16: return launch<D, 16>(a, smem, s, experts);
    case 32: return launch<D, 32>(a, smem, s, experts);
    case 64: return launch<D, 64>(a, smem, s, experts);
    case 128: return launch<D, 128>(a, smem, s, experts);
    default: return cudaErrorInvalidValue;
  }
}

// The tile for decode mode `decode` (Decode) and cluster length `group`;
// `smem`, the wrapper's shared-memory plan, must be the kernel's Plan;
// `experts`: E of an expert-stacked launch, 1 for one site.
inline cudaError_t launch_any(int decode, int group, const Args& a, size_t smem, cudaStream_t s, int experts = 1) {
  switch (decode) {
    case kTernary: return launch_group<kTernary>(group, a, smem, s, experts);
    case kInt8: return launch_group<kInt8>(group, a, smem, s, experts);
    case kLut4: return launch_group<kLut4>(group, a, smem, s, experts);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace tile
}  // namespace qmm
