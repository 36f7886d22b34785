// The GEMV of the quantized dense kernels at decode M (M <= 8) for Hopper
// (sm_90a), shared by fused_qmm.cu and packed_qmm.cu as qmm_mma.cuh's tile
// is at M > 8; tests/test_torch_qmm_gemv.py emulates this file's data flow
// on the CPU.
//
// Every decode; an int8 site whose 128-column blocks alone fill the card
// (lm_head) keeps the loop of qmm_gemv8.cuh instead.  What bounds it: the
// packed weight stream (2 bits a ternary weight, 4 an int4 / nf4 one, 8 an
// int8 one, at 3.35 TB/s), then the instructions per weight (the decode,
// the dot products, the per-cluster rescale).  The design:
//
// - Work.  A warp owns a strip of 32 output columns (8 lane groups g of 4
//   adjacent columns: one 16-byte load of the (K/16, N) or (K/8, N) int32
//   words holds a lane's 4 columns) and walks "pieces" of k in order: a
//   piece is one k-tile of block_k elements (its clusters folded in
//   registers) or, on sites with few columns, one cluster.  A block (8
//   warps) takes `wn` strips x a range of whole k-tiles (its k-split z,
//   up to 8 splits), and loops over such column items (blockIdx.x,
//   + gridDim.x, ...), so every site fills the SMs;
//   kernels/fused_qmm.py::gemv_plan sizes it.
// - The weight stream.  Each lane copies its own bytes of the next steps
//   into a per-warp ring of kRing shared-memory stages with cp.async (16
//   bytes a lane a step; int8: 4 bytes of each of its k-rows), kRing - 1
//   steps ahead of
//   the products, so ~4 KB a warp and ~64 KB an SM stay in flight without
//   holding registers; the first stages go out before the block's
//   prologue.  Scale mantissas ride along, 4 bytes a lane at a cluster's
//   first step.
// - The dot products, mma.sync s8 on the tensor cores: A = the weights
//   (16 mma rows = 2 of the lane's columns for 8 lane groups; m16n8k32, or
//   m16n8k16 at group 16), B = x's int8 rows (n = 8: rows M..7 read as 0),
//   C = one cluster's exact int32 dot, started at the bits of 1.5 * 2^23.
//   The four lanes t of a group hold the k of one step (their A bytes and
//   B bytes meet the same k: x rows sit in shared memory in the order the
//   decode produces, `perm8` within each 8 elements for ternary and int4).
//   A step is 64 k (ternary, group >= 64: a lane's whole word), 32 k, or
//   16 k (group 16); a cluster is one or more steps.
// - Decodes straight into A registers: ternary, the codes of even and odd
//   positions as nibbles through one __byte_perm table each (4 codes an
//   instruction); int4, each field as the high nibble of a byte (16 x its
//   value, the scale divided by 16: exact); nf4 through lut4; int8, 4 x 4
//   byte transposes of (K, N) rows.
// - The reference's order (repro/kernels/_common.py, fused_qmm.py's
//   cluster_sums): per cluster, fma(1.5 * 2^23 + dot, sm, -1.5 * 2^23 * sm)
//   = RN(dot * sm), added (__fadd_rn) into the piece's sum from 0.  A piece
//   sum goes to its shared-memory slot; after the block's barrier one
//   thread per output adds the slots of each k-tile in order (a tile of
//   single clusters: the reference's cluster order; a whole-tile piece:
//   0 + its sum), the tiles in order into the output, which starts at 0.
//   The k-splits of an item (blockIdx.y) are one thread block cluster:
//   each stores its tile sums into block 0's shared memory (distributed
//   shared memory), and after a cluster barrier block 0 adds them in tile
//   order -- one launch, no scratch in device memory.  Where block 0
//   cannot hold every split's tile sums (K = 49152: 96 tiles x M x 32 x 4
//   bytes; the plan's `pull`), each split leaves them in its own piece
//   slots and block 0 reads them in split and tile order, with one more
//   cluster barrier before the blocks move on.  Then
//   x 2**(scale_e + e), + bias, activation (fused), or the raw sums
//   (packed).
// - MoE expert sites (packed_qmm over E experts, one launch): the grid's z
//   is the expert, each expert's blocks offset x (E, M, K), the packed
//   weights (E, ...), the scale mantissas (E, K / G, N) and out (E, M, N)
//   by whole experts (at_expert) and then run the single-site kernel
//   unchanged -- the reference's jax.vmap over pallas_call, a batch axis of
//   the grid -- so each expert's sums are bit for bit its own launch's.  The
//   wrapper plans for E x its blocks (gemv_plan at sms / E).  The expert
//   launch is an instance of its own (kExperts), so one site's kernel is the
//   one it was before the expert axis, as in qmm_gemv8.cuh.
// - Any K that is a multiple of the cluster: the k-tiles start at 0 and the
//   last one is ragged (gemma3's 3840 = 7 x 512 + 256), so its piece holds
//   fewer clusters (whole-tile pieces) or the tile fewer pieces (single
//   clusters); the float order is the same tile order.
// - The prologue (fused): each split reads only its k range of the M rows;
//   the splits exchange their row maxima (and NaN flags) through
//   distributed shared memory for the exponent over the full K, then
//   quantize their range (read again from L1) into shared memory; packed
//   blocks copy their range of the int8 rows.  Where a block's whole range
//   does not fit (K = 49152 at M = 8: qwen1.5-110b's down projection), the
//   plan's `tpc` k-tiles of x are staged at a time, again for every item,
//   between two block barriers.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "../../src/repro_torch/csrc/qmm_common.cuh"

namespace qmm {
namespace gemv {
// Internal linkage: fused_qmm.cu and packed_qmm.cu build into two libraries
// loaded into one process (see qmm_mma.cuh).
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 32;    // output columns of a warp
constexpr int kMaxRows = 8;   // the mma's n
constexpr int kBlocksPerSm = 2;  // resident blocks the registers allow (fused_qmm.py: GEMV_BLOCKS_PER_SM)
constexpr int kMagicBits = 0x4B400000;  // the float 1.5 * 2^23
constexpr float kMagic = 12582912.0f;

// The lane -> (word, k) maps, one per decode and step size.
enum Var : int { kT64 = 0, kT32, kT16, kI4_32, kI4_16, kN4_32, kN4_16, kI8_32, kI8_16 };

template <int V>
struct Map {
  static constexpr int kDec = V <= kT16 ? kTernary : V <= kI4_16 ? kInt4 : V <= kN4_16 ? kLut4 : kInt8;
  static constexpr int kSK = V == kT64 ? 64 : (V == kT16 || V == kI4_16 || V == kN4_16 || V == kI8_16) ? 16 : 32;
  static constexpr int kRegs = kSK / 16;  // A registers a column (and B registers) a lane holds a step
  static constexpr int kWordK = kDec == kTernary ? 16 : kDec == kInt8 ? 1 : 8;  // k of a packed word (int8: a row)
  static constexpr int kShare = kDec == kInt8 ? 1 : kWordK * 4 / kSK;          // lanes t reading one word
  static constexpr int kLaneBytes = kDec == kInt8 ? kSK : 16;  // weight bytes a lane copies a step
  static constexpr int kRing = kLaneBytes == 32 ? 4 : 8;      // ring stages (4 KB a warp)
  static constexpr bool kPerm = kDec == kTernary || kDec == kInt4;  // x rows in perm8 order
};

struct Args {
  const void* x;        // (M, K) float / bf16 (fused) or int8 mantissas (packed)
  const void* w;        // packed weights
  const int8_t* sm;     // (K / G, N) scale mantissas
  const int* scale_e;   // the weights' shared exponent (fused)
  const float* bias;    // (N) or nullptr
  float* out;           // (M, N)
  int M, K, N, group, bk, act, act_bits, has_static, static_e;
  int tps, splits, wn, cpp, items, tpc, pull;  // the plan: k-tiles a split, splits (a cluster), strips an
                                               // item, clusters a piece, items, k-tiles of x staged at a
                                               // time, block 0 reads the splits' tile sums
  uint4 lut;
};

__host__ __device__ inline int x_stride(int krange) { return ((krange + 127) & ~127) + 16; }

__host__ __device__ inline int x_range(const Args& a) { return min(a.tpc * a.bk, a.K); }  // k of x staged at once

// Dynamic shared memory of a block: the warps' rings (weights, scale
// words), the int8 rows of `tpc` k-tiles of its k range, the piece slots
// of one item and, with k-splits that push, the item's k-tile sums of
// every split (block 0's are read).
template <int V>
__host__ __device__ inline size_t smem_bytes(const Args& a) {
  using P = Map<V>;
  const int ppt = a.bk / a.group / a.cpp, nk = (a.K + a.bk - 1) / a.bk;
  return static_cast<size_t>(kWarps) * P::kRing * 32 * (P::kLaneBytes + 4) +
         static_cast<size_t>(a.M) * x_stride(x_range(a)) +
         static_cast<size_t>(a.tps * ppt + (a.splits > 1 && !a.pull ? nk : 0)) * a.M * a.wn * kStrip * 4;
}

// Eight consecutive x elements, widened to float.
__device__ __forceinline__ void load8(const float* p, float* v) { load_vec(p, v), load_vec(p + 4, v + 4); }
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) { load_vec(p, v); }

// Bytes of eight consecutive k (lo: k 0-3, hi: k 4-7) -> shared memory, in
// perm8 order (positions 0-3: k 0, 2, 4, 6; 4-7: k 1, 3, 5, 7) or as they are.
template <bool kPerm>
__device__ __forceinline__ void store8(int8_t* dst, unsigned lo, unsigned hi) {
  if constexpr (kPerm) {
    const unsigned ev = __byte_perm(lo, hi, 0x6420), od = __byte_perm(lo, hi, 0x7531);
    lo = ev, hi = od;
  }
  *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
}

// A step's weight bytes of this lane -> A registers, A[c][j] = four int8
// weights of column c whose k meet x bytes 4j..4j+3 of the lane's B
// registers.  2- and 4-bit: one word of each of the lane's 4 columns;
// int8: 4 k-rows of the 4 columns a 16 bytes, transposed.
template <int V>
__device__ __forceinline__ void decode(const uint4 (&src)[Map<V>::kLaneBytes / 16], int t, const uint4& lut,
                                       uint32_t (&A)[4][Map<V>::kRegs]) {
  if constexpr (Map<V>::kDec == kInt8) {
#pragma unroll
    for (int j = 0; j < Map<V>::kRegs; ++j) {
      const unsigned rows[4] = {src[j].x, src[j].y, src[j].z, src[j].w};
      unsigned cols[4];
      transpose4(rows, cols);
#pragma unroll
      for (int c = 0; c < 4; ++c) A[c][j] = cols[c];
    }
  } else {
    const unsigned wv[4] = {src[0].x, src[0].y, src[0].z, src[0].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned w = wv[c];
      if constexpr (V == kT64) {  // codes 0,2,4,6 | 1,3,5,7 | 8,..,14 | 9,..,15
        const unsigned ev = w & 0x33333333u, od = (w >> 2) & 0x33333333u;
        A[c][0] = __byte_perm(kTernaryTable, 0, ev), A[c][1] = __byte_perm(kTernaryTable, 0, od);
        A[c][2] = __byte_perm(kTernaryTable, 0, ev >> 16), A[c][3] = __byte_perm(kTernaryTable, 0, od >> 16);
      } else if constexpr (V == kT32) {  // half t & 1 of the word: codes 8h + 0,2,4,6 | 8h + 1,3,5,7
        const unsigned h = w >> (16 * (t & 1));
        A[c][0] = __byte_perm(kTernaryTable, 0, h & 0x3333u);
        A[c][1] = __byte_perm(kTernaryTable, 0, (h >> 2) & 0x3333u);
      } else if constexpr (V == kT16) {  // codes 8(t >> 1) + (t & 1) + 0, 2, 4, 6
        A[c][0] = __byte_perm(kTernaryTable, 0, (w >> (16 * (t >> 1) + 2 * (t & 1))) & 0x3333u);
      } else if constexpr (V == kI4_32) {  // fields 0,2,4,6 | 1,3,5,7, each 16 x its value
        A[c][0] = (w << 4) & 0xF0F0F0F0u, A[c][1] = w & 0xF0F0F0F0u;
      } else if constexpr (V == kI4_16) {  // fields (t & 1) + 0, 2, 4, 6
        A[c][0] = (w << (4 - 4 * (t & 1))) & 0xF0F0F0F0u;
      } else if constexpr (V == kN4_32) {  // fields 0-3 | 4-7
        A[c][0] = static_cast<uint32_t>(lut4(w, lut)), A[c][1] = static_cast<uint32_t>(lut4(w >> 16, lut));
      } else if constexpr (V == kN4_16) {  // fields 4(t & 1) + 0..3
        A[c][0] = static_cast<uint32_t>(lut4(w >> (16 * (t & 1)), lut));
      }
    }
  }
}

// o + v[0] + v[1] + ... + v[count - 1], added in that order, v[i] at p + i * stride
// (shared memory, this block's or another split's); eight loads in flight at a time.
__device__ __forceinline__ float sum_in_order(const float* p, size_t stride, int count, float o = 0.0f) {
  for (int i0 = 0; i0 < count; i0 += 8) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (i0 + j < count) v[j] = p[(i0 + j) * stride];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (i0 + j < count) o = __fadd_rn(o, v[j]);
  }
  return o;
}

// The finished value of output (r, n) from its sum o.
template <bool kFused>
__device__ __forceinline__ float finish(const Args& a, float o, float e, int n, float se) {
  if constexpr (!kFused) return o;
  float y = __fmul_rn(o, exp2i_f(__fadd_rn(se, e)));
  if (a.bias != nullptr) y = __fadd_rn(y, a.bias[n]);
  return activate(y, a.act);
}

// Expert blockIdx.z of an expert-stacked launch (see the header; packed
// only): a at that expert's x, weights, scale mantissas and out; a itself
// for one site.
template <bool kExperts, int V>
__device__ __forceinline__ Args at_expert(Args a) {
  using P = Map<V>;
  if constexpr (kExperts) {
    const size_t e = blockIdx.z;
    a.x = static_cast<const int8_t*>(a.x) + e * a.M * a.K;
    a.w = static_cast<const unsigned char*>(a.w) + e * (a.K / P::kWordK) * a.N * (P::kDec == kInt8 ? 1 : 4);
    a.sm += e * (a.K / a.group) * a.N;
    a.out += e * a.M * a.N;
  }
  return a;
}

// T: float / bf16 x (the fused site) or int8_t (packed: x already quantized).
// kExperts: an expert-stacked launch (packed only).
template <typename T, int V, bool kExperts, int kStage>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) gemv_kernel(const Args args) {
  unsigned sink = 0;  // stages < 4: what the dropped stages would read, so nothing before them is dead code
  using P = Map<V>;
  const Args a = at_expert<kExperts, V>(args);
  constexpr bool kFused = !std::is_same<T, int8_t>::value;
  constexpr int kRing = P::kRing, kSK = P::kSK, kRegs = P::kRegs;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float e_sh[kMaxRows];
  __shared__ float red_m[kWarps][kMaxRows];
  __shared__ int red_nan[kWarps][kMaxRows];
  __shared__ float part_m[kMaxRows];  // this split's row maxima and NaN flags
  __shared__ int part_nan[kMaxRows];
  const cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int M = a.M, K = a.K, N = a.N, G = a.group, bk = a.bk;
  const int nk = (K + bk - 1) / bk, ppt = bk / G / a.cpp;
  const int z = blockIdx.y, t0 = z * a.tps, tiles = min(a.tps, nk - t0);
  const int kb = t0 * bk, krange = min(tiles * bk, K - kb), xstride = x_stride(x_range(a));
  const int pps = (krange + a.cpp * G - 1) / (a.cpp * G);  // pieces of a strip in this block (ragged: fewer)
  const int xk = a.tpc * bk, nch = (tiles + a.tpc - 1) / a.tpc;  // x staged xk at a time, in nch chunks
  const int wn = a.wn, wk = kWarps / wn, wsub = warp % wn, wk0 = warp / wn, bn = wn * kStrip;
  const int spc = G / kSK;  // steps a cluster
  unsigned char* ring_w = smem + warp * (kRing * 32 * P::kLaneBytes);
  int* ring_s = reinterpret_cast<int*>(smem + kWarps * kRing * 32 * P::kLaneBytes) + warp * kRing * 32;
  int8_t* xs = reinterpret_cast<int8_t*>(smem + kWarps * kRing * 32 * (P::kLaneBytes + 4));
  float* slots = reinterpret_cast<float*>(xs + M * xstride);  // [piece][row][column]; pulled tile sums: [tile][..]
  float* tsum = slots + static_cast<size_t>(a.tps) * ppt * M * bn;  // pushed k-split sums: [tile][row][column]
  auto piece_k = [&](int piece) { return kb + (piece / ppt) * bk + (piece % ppt) * a.cpp * G; };
  auto piece_cl = [&](int k) { return min(a.cpp, (K - k) / G); };  // clusters of the piece at k (ragged: fewer)

  // The load cursor walks this warp's steps in the order they are used:
  // items, then its pieces (wk0, wk0 + wk, ...), clusters, steps.  Within a
  // piece the lane's word and scale pointers advance by a fixed stride.
  int li = blockIdx.x, lp = wk0, lc = 0, lcl = 0, ls = 0, issued = 0;
  bool lvalid = li < a.items && wk0 < pps, lok = false;
  const unsigned char* lw = nullptr;  // the lane's first weight row of the next step
  const int8_t* lsm = nullptr;
  constexpr int kElem = P::kDec == kInt8 ? 1 : 4;  // bytes of a packed element
  const size_t row_bytes = static_cast<size_t>(N) * kElem, step_bytes = (kSK / P::kWordK) * row_bytes;
  auto seek = [&]() {  // the first step of piece lp of item li
    const int col = (li * wn + wsub) * kStrip + 4 * g, k = piece_k(lp);
    lok = col < N;
    lcl = piece_cl(k);
    const int row = P::kDec == kInt8 ? k + (kSK / 4) * t : k / P::kWordK + t / P::kShare;  // int8: k-rows
    lw = static_cast<const unsigned char*>(a.w) + row * row_bytes + static_cast<size_t>(col) * kElem;
    lsm = a.sm + static_cast<size_t>(k / G) * N + col;
  };
  if (lvalid) seek();
  auto issue = [&]() {
    const int slot = issued & (kRing - 1);
    if (lvalid) {
      unsigned char* dst = ring_w + (slot * 32 + lane) * P::kLaneBytes;
      if constexpr (P::kDec == kInt8) {  // 4 bytes (the lane's 4 columns) of each of its kSK / 4 k-rows
#pragma unroll
        for (int i = 0; i < kSK / 4; ++i) cp4(dst + 4 * i, lok ? lw + i * row_bytes : a.w, lok);
      } else {
        cp16(dst, lok ? lw : a.w, lok);  // the lane's 4 columns' words
      }
      if (ls == 0) cp4(ring_s + slot * 32 + lane, lok ? lsm : a.sm, lok);
      lw += step_bytes;
      if (++ls == spc) {
        ls = 0;
        lsm += N;
        if (++lc == lcl) {
          lc = 0;
          lp += wk;
          if (lp >= pps) lp = wk0, li += gridDim.x, lvalid = li < a.items;
          if (lvalid) seek();
        }
      }
    }
    commit();  // one group a step, empty past the end, so the waits below count steps
    ++issued;
  };
#pragma unroll 1
  for (int i = 0; i < kRing - 1; ++i) issue();
  // A block touches another's shared memory only once every block of its
  // cluster runs: arrive here, wait before the first access.
  const bool clustered = a.splits > 1;
  if (clustered) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // Prologue: each split reads only its k range of the rows: their maxima
  // (and NaNs) are exchanged across the cluster of splits for the rows'
  // exponents over the full K (fused), then the range is quantized (from L1)
  // into shared memory.
  if constexpr (kFused) {
    constexpr int kVec = 16 / sizeof(T);
    const T* x = static_cast<const T*>(a.x);
    const float qmax = static_cast<float>((1 << (a.act_bits - 1)) - 1);
    if (a.has_static) {
      if (tid < kMaxRows) e_sh[tid] = static_cast<float>(a.static_e);
    } else {
      float m[kMaxRows];
      int nan[kMaxRows];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) m[r] = 0.0f, nan[r] = 0;
#pragma unroll 4
      for (int k0 = kb + tid * kVec; k0 < kb + krange; k0 += kThreads * kVec) {  // four steps of loads in flight
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < M) {
            float v[kVec];
            load_vec(x + static_cast<size_t>(r) * K + k0, v);
#pragma unroll
            for (int j = 0; j < kVec; ++j) nan[r] |= isnan(v[j]), m[r] = fmaxf(m[r], fabsf(v[j]));
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
#pragma unroll
        for (int o = 16; o; o >>= 1) {
          m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], o));
          nan[r] |= __shfl_xor_sync(0xffffffffu, nan[r], o);
        }
        if (lane == 0) red_m[warp][r] = m[r], red_nan[warp][r] = nan[r];
      }
      __syncthreads();
      if (tid < M) {
        float mx = 0.0f;
        int any_nan = 0;
        for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w][tid]), any_nan |= red_nan[w][tid];
        part_m[tid] = mx, part_nan[tid] = any_nan;
      }
      if (clustered) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
      cluster.sync();  // every split's partial maxima are in its shared memory
      if (tid < M) {
        float mx = 0.0f;
        int any_nan = 0;
        for (int zz = 0; zz < a.splits; ++zz)
          mx = fmaxf(mx, *cluster.map_shared_rank(&part_m[tid], zz)),
          any_nan |= *cluster.map_shared_rank(&part_nan[tid], zz);
        e_sh[tid] = row_exponent(mx, any_nan, qmax);
      }
    }
    __syncthreads();
  }
  // k [kb + c0, kb + c0 + len) of the M rows -> xs from 0: quantized (fused) or copied
  auto stage = [&](int c0, int len) {
    if constexpr (kFused) {
      const T* x = static_cast<const T*>(a.x);
      const float qmax = static_cast<float>((1 << (a.act_bits - 1)) - 1);
      const int n8 = len / 8;
#pragma unroll 4
      for (int i = tid; i < M * n8; i += kThreads) {
        const int r = i / n8, k8 = (i - r * n8) * 8;
        float v[8];
        load8(x + static_cast<size_t>(r) * K + kb + c0 + k8, v);
        const float sc = exp2i_f(-e_sh[r]);
        unsigned lo = 0, hi = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo |= (static_cast<unsigned>(quantize_value(v[j], sc, qmax)) & 0xFFu) << (8 * j);
          hi |= (static_cast<unsigned>(quantize_value(v[4 + j], sc, qmax)) & 0xFFu) << (8 * j);
        }
        store8<P::kPerm>(xs + r * xstride + k8, lo, hi);
      }
    } else {
      const int8_t* xq = static_cast<const int8_t*>(a.x);
      const int n16 = len / 16;
#pragma unroll 4
      for (int i = tid; i < M * n16; i += kThreads) {
        const int r = i / n16, k16 = (i - r * n16) * 16;
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(xq + static_cast<size_t>(r) * K + kb + c0 + k16));
        store8<P::kPerm>(xs + r * xstride + k16, v.x, v.y);
        store8<P::kPerm>(xs + r * xstride + k16 + 8, v.z, v.w);
      }
    }
  };
  if (nch == 1) stage(0, krange);
  if (clustered && (!kFused || a.has_static)) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  __syncthreads();

  const float se = kFused ? static_cast<float>(a.scale_e[0]) : 0.0f;
  const int8_t* xrow = xs + min(g, M - 1) * xstride + kRegs * 4 * t;  // this lane's B bytes of a step at + its k
  int consumed = 0;
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    int piece = wk0;
    for (int ch = 0; ch < nch; ++ch) {
      if (nch > 1) {  // this chunk of x, once every warp is done with the last one
        __syncthreads();
        stage(ch * xk, min(xk, krange - ch * xk));
        __syncthreads();
      }
      for (const int p_end = min((ch + 1) * a.tpc * ppt, pps); piece < p_end; piece += wk) {
        const int8_t* xp = xrow + piece_k(piece) - kb - ch * xk;  // the lane's B bytes of the piece's first step
        const int ncl = piece_cl(piece_k(piece));
        float acc[2][4];
#pragma unroll
        for (int jp = 0; jp < 2; ++jp)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[jp][e] = 0.0f;
        for (int cl = 0; cl < ncl; ++cl) {
          int c[2][4];
#pragma unroll
          for (int jp = 0; jp < 2; ++jp)
#pragma unroll
            for (int e = 0; e < 4; ++e) c[jp][e] = kMagicBits;
          unsigned smc = 0;
          for (int st = 0; st < spc; ++st) {
            // this step's bytes out of shared memory, the copy into the slot
            // freed one step ago, then the math
            wait_group<kRing - 2>();
            const int slot = consumed & (kRing - 1);
            if (st == 0) smc = static_cast<unsigned>(ring_s[slot * 32 + lane]);
            uint4 w4[P::kLaneBytes / 16];
#pragma unroll
            for (int j = 0; j < P::kLaneBytes / 16; ++j)
              w4[j] = reinterpret_cast<const uint4*>(ring_w + (slot * 32 + lane) * P::kLaneBytes)[j];
            uint32_t X[kRegs];
            if constexpr (kRegs == 4) {
              const uint4 v = g < M ? *reinterpret_cast<const uint4*>(xp) : make_uint4(0, 0, 0, 0);
              X[0] = v.x, X[1] = v.y, X[2] = v.z, X[3] = v.w;
            } else if constexpr (kRegs == 2) {
              const uint2 v = g < M ? *reinterpret_cast<const uint2*>(xp) : make_uint2(0, 0);
              X[0] = v.x, X[1] = v.y;
            } else {
              X[0] = g < M ? *reinterpret_cast<const uint32_t*>(xp) : 0u;
            }
            ++consumed;
            xp += kSK;
            issue();  // into the slot used one step ago
            if constexpr (kStage == 0) {
              sink ^= w4[0].x ^ w4[0].y ^ w4[0].z ^ w4[0].w ^ smc ^ X[0];
              continue;
            }
            uint32_t A[4][kRegs];
            decode<V>(w4, t, a.lut, A);
            if constexpr (kStage == 1) {
#pragma unroll
              for (int cc = 0; cc < 4; ++cc)
#pragma unroll
                for (int j = 0; j < kRegs; ++j) sink ^= A[cc][j];
              sink ^= smc ^ X[0];
              continue;
            }
#pragma unroll
            for (int jp = 0; jp < 2; ++jp) {  // mma rows g, g + 8: columns 4g + 2jp, 4g + 2jp + 1
              if constexpr (kSK == 16) {
                mma_k16(c[jp], A[2 * jp][0], A[2 * jp + 1][0], X[0]);
              } else {
#pragma unroll
                for (int s = 0; s < kRegs / 2; ++s) {
                  const uint32_t af[4] = {A[2 * jp][2 * s], A[2 * jp + 1][2 * s], A[2 * jp][2 * s + 1],
                                          A[2 * jp + 1][2 * s + 1]};
                  mma_k32(c[jp], af, X[2 * s], X[2 * s + 1]);
                }
              }
            }
          }
          if constexpr (kStage == 2) {
#pragma unroll
            for (int jp = 0; jp < 2; ++jp)
#pragma unroll
              for (int e = 0; e < 4; ++e) sink ^= c[jp][e] ^ smc;
            continue;
          }
          // the cluster closes: RN(dot * sm) from the magic-number fragment, into the piece sum
          float f[4], nf[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            f[q] = static_cast<float>(static_cast<int8_t>(smc >> (8 * q)));
            if constexpr (P::kDec == kInt4) f[q] = __fmul_rn(f[q], 0.0625f);  // the dot is 16 x the fields
            nf[q] = __fmul_rn(-kMagic, f[q]);  // exact: f has at most 8 significant bits
          }
#pragma unroll
          for (int jp = 0; jp < 2; ++jp)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int q = 2 * jp + (e >> 1);
              acc[jp][e] = __fadd_rn(acc[jp][e], __fmaf_rn(__int_as_float(c[jp][e]), f[q], nf[q]));
            }
        }
        // the piece sum -> its slot: C element e of lane (g, t) is column 4g + 2jp + (e >> 1), row 2t + (e & 1)
        float* sp = slots + static_cast<size_t>(piece) * M * bn + wsub * kStrip + 4 * g;
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          if (2 * t < M) *reinterpret_cast<float2*>(sp + (2 * t) * bn + 2 * jp) = make_float2(acc[jp][0], acc[jp][2]);
          if (2 * t + 1 < M)
            *reinterpret_cast<float2*>(sp + (2 * t + 1) * bn + 2 * jp) = make_float2(acc[jp][1], acc[jp][3]);
        }
      }
    }
    if constexpr (kStage < 4) continue;  // no reduction, no barrier between items
    __syncthreads();

    // one thread an output: the slots of each k-tile in order (a ragged
    // tile has fewer), the tiles in order.  A k-split stores its tile sums
    // into block 0's shared memory, or with `pull` leaves them in its own
    // slots (tile tl over slot tl: this thread read that one already), and
    // block 0 adds all of them in tile order after the cluster barrier.
    float* tbuf = clustered && !a.pull ? cluster.map_shared_rank(tsum, 0) : tsum;
    for (int i = tid; i < M * bn; i += kThreads) {
      const int r = i / bn, cc = i - r * bn, n = item * bn + cc;
      if (n >= N) continue;
      float run = 0.0f;
      for (int tl = 0; tl < tiles; ++tl) {
        const float ts = sum_in_order(slots + (static_cast<size_t>(tl * ppt) * M + r) * bn + cc,
                                      static_cast<size_t>(M) * bn, min(ppt, pps - tl * ppt));
        if (!clustered)
          run = __fadd_rn(run, ts);
        else if (a.pull)
          slots[(static_cast<size_t>(tl) * M + r) * bn + cc] = ts;
        else
          tbuf[(static_cast<size_t>(t0 + tl) * M + r) * bn + cc] = ts;
      }
      if (!clustered) a.out[static_cast<size_t>(r) * N + n] = finish<kFused>(a, run, e_sh[r], n, se);
    }
    if (clustered) {
      cluster.sync();  // every split's tile sums are in place
      if (z == 0) {
        for (int i = tid; i < M * bn; i += kThreads) {
          const int r = i / bn, cc = i - r * bn, n = item * bn + cc;
          if (n >= N) continue;
          const size_t at = static_cast<size_t>(r) * bn + cc, stride = static_cast<size_t>(M) * bn;
          float run = 0.0f;
          if (a.pull)
            for (int zz = 0; zz < a.splits; ++zz)
              run = sum_in_order(cluster.map_shared_rank(slots, zz) + at, stride, min(a.tps, nk - zz * a.tps), run);
          else
            run = sum_in_order(tbuf + at, stride, nk);
          a.out[static_cast<size_t>(r) * N + n] = finish<kFused>(a, run, e_sh[r], n, se);
        }
      }
      // block 0 has read them: the slots (pull) or its buffer may be refilled, and (pull) the blocks may exit
      if (a.pull || item + static_cast<int>(gridDim.x) < a.items) cluster.sync();
    }
    __syncthreads();  // the slots are free for the next item
  }
  wait_group<0>();
  if (sink == 0x9E3779B9u) a.out[0] = 1.0f;  // never in practice; keeps the stream live
}

// The map for a decode mode (qmm::Decode) and cluster length; -1 if none.
inline int variant(int decode, int group) {
  if (group != 16 && group != 32 && group != 64 && group != 128) return -1;
  switch (decode) {
    case kTernary: return group == 16 ? kT16 : group == 32 ? kT32 : kT64;
    case kInt4: return group == 16 ? kI4_16 : kI4_32;
    case kLut4: return group == 16 ? kN4_16 : kN4_32;
    case kInt8: return group == 16 ? kI8_16 : kI8_32;
    default: return -1;
  }
}

template <typename T, int V, bool kExperts, int kStage>
cudaError_t launch_kernel(const Args& a, int grid_x, size_t smem, cudaStream_t stream, int experts) {
  auto kernel = gemv_kernel<T, V, kExperts, kStage>;
  static bool configured = false;
  const cudaError_t err = raise_smem_cap(kernel, configured);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;  // the k-splits of an item: one cluster along y
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1, cluster.val.clusterDim.y = a.splits, cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, a.splits, experts);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <int kStage>
cudaError_t launch_stage(const Args& a, int grid_x, size_t smem, cudaStream_t stream, int experts) {
  if (smem != smem_bytes<kT64>(a)) return cudaErrorInvalidValue;
  return launch_kernel<int8_t, kT64, true, kStage>(a, grid_x, smem, stream, experts);
}

}  // namespace
}  // namespace gemv
}  // namespace qmm
