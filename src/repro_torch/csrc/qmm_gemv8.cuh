// The int8 loop at decode M (M <= 8) for Hopper (sm_90a), shared by
// fused_qmm.cu and packed_qmm.cu.  It replaces, for int8 weights, the TPU
// kernels repro/kernels/_common.py::fused_qmm_call (:274, through
// int8_matmul.py::int8_matmul_fused and mx_matmul.py) and ::packed_qmm_call
// (:133, through int8_matmul.py::int8_matmul).  It runs the int8 sites
// whose 128-column items x k-tiles fill the card (fused_qmm.py::
// uses_int8_loop: every family's lm_head, the mx layers' wide sites); the
// rest run qmm_gemv.cuh.  tests/test_torch_int8_loop.py emulates this
// file's data flow on the CPU.
//
// What bounds it: the int8 weight stream, one byte a weight, read once at
// 3.35 TB/s (qwen3-8b's lm_head: 623 MB, 0.19 ms), then x, the scales and
// the float32 output.  The design, from what the card showed
// (tools/int8_loop_variants.py times each part alone):
//
// - Work.  The output is cut into items of kCols = 128 columns and each
//   item's k-tiles into `splits` ranges of `tps` tiles: a unit is one
//   (range, item), numbered range-major.  The grid is persistent: grid_x
//   blocks (one an SM) of `warps` warps, and warp r = warp * grid_x +
//   block walks units r, r + W, ... (W warps in all), so the SMs take
//   neighbouring units at once and the card streams the same weight rows
//   together -- unsplit, the copies alone reached 2.8 TB/s at qwen3-8b's
//   lm_head, split into far-apart k ranges 1.9-2.1 TB/s, so the plan
//   splits only where the items alone leave SMs idle (arctic, zamba2, the
//   mx sites).  Each warp runs its units alone -- no block barrier after
//   the prologue -- so no warp waits on another's k range whatever K / 512
//   is (the loop before gave a whole 512-wide k-tile to a warp and left
//   warps idle at K = 512, 3072, 3584, 6144, 7168).
// - The weight stream.  Each warp owns a ring of kRing stages in shared
//   memory; a stage is kStageK = 32 weight rows x the item's 128 columns
//   (4 KB) plus the scale rows of the clusters that close in it.  The
//   warp's copy i (16-byte cp.async, 8 a lane a stage) takes four whole
//   128-byte rows, 4i..4i+3 -- rows in order: copies that each took rows
//   4t + i, 16 + 4t + i streamed 1.8 TB/s where these stream 2.8 --, chunk
//   c of row r at r * 128 + 16 (c ^ 2 ((r >> 2) & 3)) so that the reads of
//   a quarter warp fall on 8 bank groups.  The first kRing - 1 stages of
//   every warp go out before the block's prologue, so quantizing x
//   overlaps the first weight bytes, and a block runs the prologue once
//   for all its units (one block an SM, not one per 128 columns).
// - The dot products on the tensor cores: A = 16 weight columns x k (mma
//   row g = column 16g + 2jp, row g + 8 = column 16g + 2jp + 1: eight mma
//   tiles jp cover the item), lane (g, t)'s 4 k-rows x 4 columns
//   transposed in registers (transpose4); B = x's int8 rows (n = 8, rows
//   past M read as 0), 4 bytes at k + 4t; C = a cluster's exact int32 dot.
//   Clusters of a multiple of 32 rows (up to 256) take a stage as one
//   m16n8k32 (its rows 4t..4t+3 and 16+4t..16+4t+3 are the lane's A and B
//   registers) and close at a stage's end with one fma: the fragment starts
//   at the bits of 1.5 * 2^23, and fma(1.5 * 2^23 + dot, sm, -1.5 * 2^23 *
//   sm) = RN(dot * sm) while |dot| < 2^22.  Any other group of whole 4-row
//   units takes 16-k steps (m16n8k16): the clusters that meet a step in
//   order, B zero outside each (a cluster closing mid-step), and
//   RN(float(dot) * sm) (__int2float_rn, __fmul_rn) at each close.
// - The reference's float order (fused_qmm.py's cluster_sums): the
//   products added (__fadd_rn) into the k-tile's sum from 0 in cluster
//   order, the tile sums in tile order into the output from 0.  Lane (g, t)
//   holds columns 16g..16g+15 x x-rows 2t, 2t + 1 of both chains in
//   registers.  With splits > 1 a unit writes its tile sums to device
//   scratch (`ws`, one plane of rows x 128 floats a tile) and adds its tile
//   count to the item's arrival counter; the warp that completes the count
//   adds the item's tile sums in tile order (loads through L2) and resets
//   the counter -- one launch.  Not a thread block cluster gathering them
//   through distributed shared memory, as qmm_gemv.cuh does: a split here
//   is a unit any warp of the card takes, while a cluster would bind an
//   item's splits to co-scheduled blocks and hold every warp of those
//   blocks at its barriers; the scratch is written and read once, M x 128
//   x 4 bytes each way a tile against the tile's 64 KB of weights (6% each
//   way at M = 8).  Then x 2**(scale_e + e), + bias, activation (fused),
//   or the raw sums (packed).
// - x: the block's rows (all M, or `rows` of them where x would not fit
//   beside the rings: grid y) sit in shared memory for the whole launch:
//   fused, the exponent over the full row (or the static one) and the
//   mantissas, as quantize_rows; packed, the int8 rows copied.  K is any
//   multiple of the cluster and of 4: the k-tiles start at 0, the last one
//   ragged (gemma3's 3840 = 7 x 512 + 256); copies past a tile or past N
//   are zero-filled.  N % 16 != 0 copies 4 bytes at a time.
#pragma once

#include <type_traits>

#include "qmm_common.cuh"

namespace qmm {
namespace gemv8 {
// Internal linkage: fused_qmm.cu and packed_qmm.cu build into two libraries
// loaded into one process (see qmm_mma.cuh).
namespace {

constexpr int kCols = 128;     // output columns of an item (a warp's)
constexpr int kStageK = 32;    // weight rows of a ring stage
constexpr int kRing = 4;       // ring stages a warp (fused_qmm.py: LOOP_RING)
constexpr int kMaxWarps = 12;  // warps a block, at most (fused_qmm.py: LOOP_MAX_WARPS)
constexpr int kMaxRows = 8;    // x rows a block: the mma's n
constexpr int kMagicBits = 0x4B400000;  // the float 1.5 * 2^23
constexpr float kMagic = 12582912.0f;

struct Args {
  const void* x;        // (M, K) float / bf16 (fused) or int8 mantissas (packed)
  const int8_t* w;      // (K, N) int8 weights
  const int8_t* sm;     // (K / G, N) scale mantissas
  const int* scale_e;   // the weights' shared exponent (fused)
  const float* bias;    // (N) or nullptr
  float* out;           // (M, N)
  float* ws;            // splits > 1: [row block][item][tile][rows][kCols] tile sums
  int* counters;        // splits > 1: one zeroed arrival counter an item and row block
  int M, K, N, group, bk, act, act_bits, has_static, static_e;
  int rows, splits, tps;  // x rows a block, k-splits of an item, k-tiles a split
};

__host__ __device__ inline int x_stride(int K) { return ((K + 127) & ~127) + 16; }  // rows on other banks
__host__ __device__ inline int closes(int group) { return (kStageK + group - 1) / group; }  // clusters ending a stage
__host__ __device__ inline int slot_bytes(int group) { return (kStageK + closes(group)) * kCols; }

// Dynamic shared memory of a block: the warps' rings, then the int8 rows of x.
__host__ __device__ inline size_t smem_bytes(int warps, int rows, int K, int group) {
  return static_cast<size_t>(warps) * kRing * slot_bytes(group) + static_cast<size_t>(rows) * x_stride(K);
}

__device__ __forceinline__ unsigned word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Stage row r's 16-byte chunk c: rows of 128 bytes, the chunk XOR 2 ((r >> 2) & 3),
// so lane (g, t)'s chunk g of rows 4t + j (j fixed) falls on 8 bank groups a quarter warp.
__device__ __forceinline__ int chunk_at(int r, int c) { return r * kCols + 16 * (c ^ (((r >> 2) & 3) << 1)); }

// Step s's 4 k-rows of the lane's 16 columns -> A[jp][0 | 1] (mma rows g, g + 8:
// columns 16g + 2jp, + 1), 4 consecutive k a register.
__device__ __forceinline__ void a_regs(const unsigned char* slot, int s, int g, int t, uint32_t (&A)[8][2]) {
  uint4 v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = *reinterpret_cast<const uint4*>(slot + chunk_at(16 * s + 4 * t + j, g));
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // columns 16g + 4q .. + 3
    const unsigned r4[4] = {word(v[0], q), word(v[1], q), word(v[2], q), word(v[3], q)};
    unsigned cw[4];
    transpose4(r4, cw);
    A[2 * q][0] = cw[0], A[2 * q][1] = cw[1], A[2 * q + 1][0] = cw[2], A[2 * q + 1][1] = cw[3];
  }
}

// The activation out of line: finish is inlined at every output a lane
// holds (32 a store), and expf / tanhf inlined there too made the fused
// kernel 17,088 SASS instructions against the packed one's 3,304 and
// whisper-base's lm_head 0.0315 ms against 0.0288 out of line (H100).
__device__ __noinline__ float activate_call(float y, int act) { return activate(y, act); }

// The finished value of output (r, n) from its sum o.
template <bool kFused>
__device__ __forceinline__ float finish(const Args& a, float o, float e, int n, float se) {
  if constexpr (!kFused) return o;
  float y = __fmul_rn(o, exp2i_f(__fadd_rn(se, e)));
  if (a.bias != nullptr) y = __fadd_rn(y, a.bias[n]);
  return a.act == ACT_NONE ? y : activate_call(y, a.act);
}

// T: float / bf16 x (the fused site) or int8_t (packed: x already quantized).
// Grid (grid_x, ceil(M / rows)), warps * 32 threads.
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) loop_kernel(const Args a) {
  constexpr bool kFused = !std::is_same<T, int8_t>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float e_sh[kMaxRows];
  __shared__ float red_m[kMaxWarps][kMaxRows];
  __shared__ int red_nan[kMaxWarps][kMaxRows];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int nthreads = static_cast<int>(blockDim.x), warps = nthreads >> 5;
  const int M = a.M, K = a.K, N = a.N, G = a.group, bk = a.bk;
  const int row0 = blockIdx.y * a.rows, rows = min(a.rows, M - row0);
  const int nk = (K + bk - 1) / bk, items = (N + kCols - 1) / kCols, units = items * a.splits;
  const int sbytes = slot_bytes(G), xstride = x_stride(K);
  unsigned char* ring = smem + static_cast<size_t>(warp) * kRing * sbytes;
  int8_t* xs = reinterpret_cast<int8_t*>(smem + static_cast<size_t>(warps) * kRing * sbytes);
  const int rank = warp * gridDim.x + blockIdx.x, stride = warps * gridDim.x;  // warp-major: SMs first
  const bool vec16 = (N & 15) == 0;
  // whole 32-row stages of one cluster and |dot| < 2^22: m16n8k32 and the magic-number product
  const bool whole = G % kStageK == 0 && G <= 256;

  // The load cursor walks this warp's stages in the order they are used:
  // units, their k-tiles, the tiles' 32-row stages.
  int lu = rank, ltile = 0, ltend = 0, lks = 0, lkend = 0, lcol = 0, issued = 0;
  auto seek = [&]() {  // the first stage of unit lu
    const int z = lu / items;
    lcol = (lu - z * items) * kCols;
    ltile = z * a.tps;
    ltend = min(nk, ltile + a.tps);
    lks = ltile * bk;
    lkend = min(K, lks + bk);
  };
  if (lu < units) seek();
  auto issue = [&]() {
    if (lu < units) {
      unsigned char* dst = ring + (issued & (kRing - 1)) * sbytes;
      const int ke = min(lks + kStageK, lkend), col = lcol + 16 * (lane & 7);
#pragma unroll
      for (int i = 0; i < 8; ++i) {  // copy i: rows 4i..4i+3, 128 bytes each (lanes 8r..8r+7 a row)
        const int row = 4 * i + (lane >> 3);
        unsigned char* d = dst + chunk_at(row, lane & 7);
        const int8_t* s = a.w + static_cast<size_t>(lks + row) * N + col;
        if (vec16) {
          const bool ok = lks + row < ke && col < N;
          cp16(d, ok ? s : a.w, ok);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool ok = lks + row < ke && col + 4 * j < N;
            cp4(d + 4 * j, ok ? s + 4 * j : a.w, ok);
          }
        }
      }
      // the scale rows of the clusters that close in [lks, ke), 8 lanes a row
      const int c0 = lks / G, nch = (ke / G - c0) * 8;
      for (int ch = lane; ch < nch; ch += 32) {
        unsigned char* d = dst + kStageK * kCols + 16 * ch;
        const int8_t* s = a.sm + static_cast<size_t>(c0 + (ch >> 3)) * N + col;
        if (vec16) {
          cp16(d, col < N ? s : a.sm, col < N);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) cp4(d + 4 * j, col + 4 * j < N ? s + 4 * j : a.sm, col + 4 * j < N);
        }
      }
      lks += kStageK;
      if (lks >= lkend) {
        if (++ltile < ltend) {
          lks = ltile * bk;
          lkend = min(K, lks + bk);
        } else {
          lu += stride;
          if (lu < units) seek();
        }
      }
    }
    commit();  // one group a stage, empty past the end, so the waits below count stages
    ++issued;
  };
#pragma unroll 1
  for (int i = 0; i < kRing - 1; ++i) issue();
  // Prologue, once a block: the rows' exponents over the full K (fmaxf
  // drops NaN, so a NaN is tracked on the side) or the static one, then the
  // mantissas into shared memory; packed: the int8 rows copied.
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
#pragma unroll 2
      for (int k0 = tid * kVec; k0 < K; k0 += nthreads * kVec) {
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < rows) {
            float v[kVec];
            load_vec(x + static_cast<size_t>(row0 + r) * K + k0, v);
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
      if (tid < rows) {
        float mx = 0.0f;
        int any_nan = 0;
        for (int w = 0; w < warps; ++w) mx = fmaxf(mx, red_m[w][tid]), any_nan |= red_nan[w][tid];
        e_sh[tid] = row_exponent(mx, any_nan, qmax);
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int k0 = tid * kVec; k0 < K; k0 += nthreads * kVec) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < rows) {
          const float sc = exp2i_f(-e_sh[r]);
          float v[kVec];
          load_vec(x + static_cast<size_t>(row0 + r) * K + k0, v);
          unsigned packed[kVec / 4];
#pragma unroll
          for (int j4 = 0; j4 < kVec / 4; ++j4) {
            packed[j4] = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              packed[j4] |= (static_cast<unsigned>(quantize_value(v[4 * j4 + j], sc, qmax)) & 0xFFu) << (8 * j);
          }
          if constexpr (kVec == 8) {
            *reinterpret_cast<uint2*>(xs + r * xstride + k0) = make_uint2(packed[0], packed[1]);
          } else {
            *reinterpret_cast<unsigned*>(xs + r * xstride + k0) = packed[0];
          }
        }
      }
    }
  } else {
    const int8_t* xq = static_cast<const int8_t*>(a.x);
    const int n16 = K / 16;  // the packed wrapper takes K % 16 == 0
    for (int i = tid; i < rows * n16; i += nthreads) {
      const int r = i / n16, k16 = (i - r * n16) * 16;
      *reinterpret_cast<uint4*>(xs + r * xstride + k16) =
          __ldg(reinterpret_cast<const uint4*>(xq + static_cast<size_t>(row0 + r) * K + k16));
    }
  }
  __syncthreads();

  const float se = kFused ? static_cast<float>(a.scale_e[0]) : 0.0f;
  const int8_t* xrow = xs + min(g, rows - 1) * xstride + 4 * t;  // this lane's B bytes at + k
  const size_t plane = static_cast<size_t>(a.rows) * kCols;
  const int c_init = whole ? kMagicBits : 0;  // a cluster's dot starts here
  auto store = [&](const float (&o)[8][4], int col0) {  // rows 2t, 2t + 1 x the lane's 16 columns
#pragma unroll
    for (int jp = 0; jp < 8; ++jp) {
      const int n = col0 + 16 * g + 2 * jp;
      if (n >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 2 * t + h;
        if (r < rows)
          *reinterpret_cast<float2*>(a.out + static_cast<size_t>(row0 + r) * N + n) =
              make_float2(finish<kFused>(a, o[jp][h], e_sh[r], n, se),
                          finish<kFused>(a, o[jp][2 + h], e_sh[r], n + 1, se));
      }
    }
  };
  int consumed = 0;
#pragma unroll 1
  for (int u = rank; u < units; u += stride) {
    const int z = u / items, item = u - z * items, col0 = item * kCols;
    const int tb = z * a.tps, te = min(nk, tb + a.tps);
    float out[8][4];
#pragma unroll
    for (int jp = 0; jp < 8; ++jp)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[jp][e] = 0.0f;
#pragma unroll 1
    for (int tl = tb; tl < te; ++tl) {
      const int kt0 = tl * bk, kt1 = min(K, kt0 + bk);
      float acc[8][4];
      int C[8][4];
#pragma unroll
      for (int jp = 0; jp < 8; ++jp)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jp][e] = 0.0f, C[jp][e] = c_init;
      int cl_end = kt0 + G;  // the open cluster is [cl_end - G, cl_end)
#pragma unroll 1
      for (int ks = kt0; ks < kt1; ks += kStageK) {
        // this stage's bytes are in (every lane's copies: the lanes read
        // each other's), then the copy into the slot the last stage used
        wait_group<kRing - 2>();
        __syncwarp();
        const unsigned char* slot = ring + (consumed & (kRing - 1)) * sbytes;
        ++consumed;
        issue();
        const unsigned char* srow = slot + kStageK * kCols + 16 * g;  // scale row j at + j * kCols
        if (whole) {
          // the stage lies in one cluster: m16n8k32 over its 32 rows; the
          // cluster closes at the stage's end: fma(1.5 * 2^23 + dot, sm,
          // -1.5 * 2^23 * sm) = RN(dot * sm) into the tile's sum
          uint32_t A0[8][2], A1[8][2];
          a_regs(slot, 0, g, t, A0);
          a_regs(slot, 1, g, t, A1);
          const uint32_t b0 = g < rows ? *reinterpret_cast<const uint32_t*>(xrow + ks) : 0u;
          const uint32_t b1 = g < rows ? *reinterpret_cast<const uint32_t*>(xrow + ks + 16) : 0u;
#pragma unroll
          for (int jp = 0; jp < 8; ++jp) {
            const uint32_t af[4] = {A0[jp][0], A0[jp][1], A1[jp][0], A1[jp][1]};
            mma_k32(C[jp], af, b0, b1);
          }
          if (ks + kStageK == cl_end) {
            const uint4 s4 = *reinterpret_cast<const uint4*>(srow);
            const unsigned sw[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
            for (int jp = 0; jp < 8; ++jp)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int c = 2 * jp + h;  // the column's byte of the lane's 16 scale bytes
                const float f = static_cast<float>(static_cast<int8_t>(sw[c >> 2] >> (8 * (c & 3))));
                const float nf = __fmul_rn(-kMagic, f);  // exact: f has at most 8 significant bits
#pragma unroll
                for (int r = 0; r < 2; ++r) {  // C element 2h + r: column 16g + 2jp + h, x row 2t + r
                  const int e = 2 * h + r;
                  acc[jp][e] = __fadd_rn(acc[jp][e], __fmaf_rn(__int_as_float(C[jp][e]), f, nf));
                  C[jp][e] = kMagicBits;
                }
              }
            cl_end += G;
          }
          continue;
        }
        // any other cluster: 16-k steps; the clusters that meet a step in
        // order, B zero outside each; RN(float(dot) * sm) at each close
        const int c0 = ks / G;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int kk = ks + 16 * s;
          if (kk >= kt1) break;
          uint32_t A[8][2];
          a_regs(slot, s, g, t, A);
          const uint32_t xw = g < rows ? *reinterpret_cast<const uint32_t*>(xrow + kk) : 0u;
          const int k_hi = min(kk + 16, kt1), ku = kk + 4 * t;
#pragma unroll 1
          for (;;) {
            const uint32_t b = ku >= cl_end - G && ku < min(cl_end, k_hi) ? xw : 0u;
#pragma unroll
            for (int jp = 0; jp < 8; ++jp) mma_k16(C[jp], A[jp][0], A[jp][1], b);
            if (cl_end > k_hi) break;  // the cluster goes on into the next step
            const uint4 s4 = *reinterpret_cast<const uint4*>(srow + (cl_end / G - 1 - c0) * kCols);
            const unsigned sw[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
            for (int jp = 0; jp < 8; ++jp)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int c = 2 * jp + (e >> 1);
                const float f = static_cast<float>(static_cast<int8_t>(sw[c >> 2] >> (8 * (c & 3))));
                acc[jp][e] = __fadd_rn(acc[jp][e], __fmul_rn(__int2float_rn(C[jp][e]), f));
                C[jp][e] = 0;
              }
            cl_end += G;
            if (cl_end - G >= k_hi) break;
          }
        }
      }
      if (a.splits == 1) {
#pragma unroll
        for (int jp = 0; jp < 8; ++jp)
#pragma unroll
          for (int e = 0; e < 4; ++e) out[jp][e] = __fadd_rn(out[jp][e], acc[jp][e]);
      } else {  // the tile's sum -> its scratch plane
        float* p = a.ws + ((static_cast<size_t>(blockIdx.y) * items + item) * nk + tl) * plane;
#pragma unroll
        for (int jp = 0; jp < 8; ++jp) {
          const int c = 16 * g + 2 * jp;
          if (col0 + c >= N) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (2 * t + h < rows)
              *reinterpret_cast<float2*>(p + (2 * t + h) * kCols + c) = make_float2(acc[jp][h], acc[jp][2 + h]);
        }
      }
    }
    if (a.splits == 1) {
      store(out, col0);
      continue;
    }
    // The warp that completes the item's tile count adds every tile sum in
    // tile order (through L2: other SMs wrote them) and resets the counter.
    __threadfence();
    __syncwarp();
    int* counter = a.counters + blockIdx.y * items + item;
    int last = 0;
    if (lane == 0) last = atomicAdd(counter, te - tb) + (te - tb) == nk;
    if (!__shfl_sync(0xffffffffu, last, 0)) continue;
    __threadfence();
    const float* p0 = a.ws + (static_cast<size_t>(blockIdx.y) * items + item) * nk * plane;
#pragma unroll 1
    for (int tl = 0; tl < nk; ++tl) {
#pragma unroll
      for (int jp = 0; jp < 8; ++jp) {
        const int c = 16 * g + 2 * jp;
        if (col0 + c >= N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (2 * t + h < rows) {
            const float2 v = __ldcg(reinterpret_cast<const float2*>(p0 + tl * plane + (2 * t + h) * kCols + c));
            out[jp][h] = __fadd_rn(out[jp][h], v.x);
            out[jp][2 + h] = __fadd_rn(out[jp][2 + h], v.y);
          }
      }
    }
    store(out, col0);
    if (lane == 0) *counter = 0;  // ready for the next call
  }
  wait_group<0>();
}

template <typename T>
cudaError_t launch(const Args& a, int warps, int grid_x, size_t smem, cudaStream_t stream) {
  // the wrapper's plan must be the kernel's (kernels/fused_qmm.py::int8_loop_plan)
  if (warps < 1 || warps > kMaxWarps || a.rows < 1 || a.rows > kMaxRows || a.splits < 1 || a.tps < 1 ||
      a.group % 4 || a.K % a.group || smem != smem_bytes(warps, a.rows, a.K, a.group))
    return cudaErrorInvalidValue;
  auto kernel = loop_kernel<T>;
  static bool configured = false;
  const cudaError_t err = raise_smem_cap(kernel, configured);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(grid_x, (a.M + a.rows - 1) / a.rows), warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gemv8
}  // namespace qmm
