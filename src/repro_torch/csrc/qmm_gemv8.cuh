// The int8 loop at decode M (M <= 8) for Hopper (sm_90a), shared by
// fused_qmm.cu and packed_qmm.cu.  It runs the int8 sites whose
// 128-column blocks alone fill the card (fused_qmm.py::uses_int8_loop);
// the rest run qmm_gemv.cuh, whose 32-column strips read int8 rows in
// 32-byte runs -- slower on lm_head's 623 MB than this loop's 128-byte
// rows (PERF.md, the int8 route).
//
// What bounds it: the int8 weight stream, one byte a weight.  A block owns
// kBn = 128 output columns (four a lane) and up to kRows rows, and the
// whole K reduction: its int8 rows sit in shared memory; warp w reduces the
// k-tiles w, w + 8, ...: 4-byte loads of four k-rows of the lane's four
// columns (128 contiguous bytes a warp and row), kChunk units in flight a
// lane, transposed in registers for __dp4a; per cluster an int32 dot, one
// multiply by the scale mantissa, the cluster sums added in order into the
// tile's sum (shared memory), the tile sums in tile order.  K is any
// multiple of the cluster: the last k-tile may be ragged (gemma3's lm_head,
// K = 3840 = 7 x 512 + 256) and holds the units that are left.  An MoE
// expert site at decode runs qmm_gemv_experts.cuh instead, every decode.
#pragma once

#include <type_traits>

#include "qmm_common.cuh"

namespace qmm {
namespace gemv8 {
// Internal linkage: fused_qmm.cu and packed_qmm.cu build into two libraries
// loaded into one process (see qmm_mma.cuh).
namespace {

constexpr int kRows = 8;    // rows a block, at most
constexpr int kCpt = 4;     // output columns a lane
constexpr int kBn = 32 * kCpt;
constexpr int kChunk = 8;   // 4-row units a lane keeps in flight

// Shared memory of one block: int8 rows [rows][K], exponents [kRows], tile
// sums [ntiles][rows][kBn], the block's scale mantissas [K/group][kBn].
struct Smem {
  int8_t* xq;
  float* e;
  float* part;
  int8_t* sm;
};

__host__ __device__ inline int n_tiles(int K, int bk) { return (K + bk - 1) / bk; }

__host__ __device__ inline size_t smem_bytes(int rows, int K, int group, int bk) {
  return static_cast<size_t>(rows) * K + 4 * kRows + static_cast<size_t>(n_tiles(K, bk)) * rows * kBn * 4 +
         static_cast<size_t>(K / group) * kBn;
}

__device__ __forceinline__ Smem carve(unsigned char* smem, int rows_alloc, int K, int bk) {
  Smem s;
  s.xq = reinterpret_cast<int8_t*>(smem);
  s.e = reinterpret_cast<float*>(smem + rows_alloc * K);
  s.part = s.e + kRows;
  s.sm = reinterpret_cast<int8_t*>(s.part + n_tiles(K, bk) * rows_alloc * kBn);
  return s;
}

// The k-tile loop: per-tile sums of (cluster dot x scale mantissa), clusters
// in order, into s.part.  A cluster closes every group / 4 units, whatever
// the chunk boundaries.
__device__ __forceinline__ void tile_sums(const Smem& s, const int8_t* __restrict__ w, int rows, int K, int N,
                                          int group, int bk, int col0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ntiles = n_tiles(K, bk), per_cluster = group / 4;
  for (int t = warp; t < ntiles; t += kWarps) {
    const int units = min(bk, K - t * bk) / 4;  // a ragged last tile: fewer
    float acc[kRows][kCpt];
    int dot[kRows][kCpt];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCpt; ++c) acc[r][c] = 0.0f, dot[r][c] = 0;
    const int col = col0 + lane * kCpt;
    if (col < N) {
      int g = t * bk / group;  // global cluster index
      int in_cluster = 0;
#pragma unroll 1
      for (int u0 = 0; u0 < units; u0 += kChunk) {
        int wv[kChunk][4];
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          if (u0 + i < units)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              wv[i][c] = __ldg(reinterpret_cast<const int*>(w + static_cast<size_t>(t * bk + (u0 + i) * 4 + c) * N + col));
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          const int u = u0 + i;
          if (u >= units) break;
          const int k0 = t * bk + u * 4;
          // 4 k-rows x 4 columns of bytes -> one 4-k word per column
          const unsigned rw[4] = {static_cast<unsigned>(wv[i][0]), static_cast<unsigned>(wv[i][1]),
                                  static_cast<unsigned>(wv[i][2]), static_cast<unsigned>(wv[i][3])};
          unsigned cw[4];
          transpose4(rw, cw);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r < rows) {
              const int xw = *reinterpret_cast<const int*>(s.xq + r * K + k0);
#pragma unroll
              for (int c = 0; c < kCpt; ++c) dot[r][c] = __dp4a(static_cast<int>(cw[c]), xw, dot[r][c]);
            }
          }
          if (++in_cluster == per_cluster) {  // one multiply per cluster
#pragma unroll
            for (int c = 0; c < kCpt; ++c) {
              const float sm = static_cast<float>(s.sm[g * kBn + lane * kCpt + c]);
#pragma unroll
              for (int r = 0; r < kRows; ++r) {
                acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(static_cast<float>(dot[r][c]), sm));
                dot[r][c] = 0;
              }
            }
            ++g;
            in_cluster = 0;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < rows)
#pragma unroll
        for (int c = 0; c < kCpt; ++c) s.part[(t * rows + r) * kBn + lane * kCpt + c] = acc[r][c];
  }
}

// T: float / bf16 x (the fused site) or int8_t (packed: x already quantized).
// Grid (ceil(N / kBn), ceil(M / rpb)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gemv8_kernel(const T* __restrict__ x, const int8_t* __restrict__ w, const int8_t* __restrict__ scale_m,
             const int* __restrict__ scale_e, const float* __restrict__ bias, float* __restrict__ out, int M, int K,
             int N, int group, int bk, int rpb, int act, int act_bits, int has_static, int static_e) {
  constexpr bool kFused = !std::is_same<T, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_m[kWarps][kRows];
  __shared__ int red_nan[kWarps][kRows];
  const int row0 = blockIdx.y * rpb, rows = min(rpb, M - row0), col0 = blockIdx.x * kBn;
  const Smem s = carve(smem, min(rpb, M), K, bk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the block's scale mantissas stream into shared memory behind the prologue
  for (int i = tid; i < (K / group) * (kBn / 4); i += kThreads) {
    const int g = i / (kBn / 4), c4 = (i % (kBn / 4)) * 4;
    const bool ok = col0 + c4 < N;
    cp4(s.sm + g * kBn + c4, ok ? scale_m + static_cast<size_t>(g) * N + col0 + c4 : scale_m, ok);
  }
  commit();

  if constexpr (kFused) {
    // 1. per-row exponents over the full row (or the static one); fmaxf drops
    // NaN, so a NaN is tracked on the side
    constexpr int kVec = 16 / sizeof(T);
    const float qmax = static_cast<float>((1 << (act_bits - 1)) - 1);
    if (has_static) {
      if (tid < kRows) s.e[tid] = static_cast<float>(static_e);
    } else {
      float m[kRows];
      int nan[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) m[r] = 0.0f, nan[r] = 0;
      for (int k0 = tid * kVec; k0 < K; k0 += kThreads * kVec) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < rows) {
            float v[kVec];
            load_vec(x + static_cast<size_t>(row0 + r) * K + k0, v);
#pragma unroll
            for (int j = 0; j < kVec; ++j) nan[r] |= isnan(v[j]), m[r] = fmaxf(m[r], fabsf(v[j]));
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
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
        for (int w8 = 0; w8 < kWarps; ++w8) mx = fmaxf(mx, red_m[w8][tid]), any_nan |= red_nan[w8][tid];
        s.e[tid] = row_exponent(mx, any_nan, qmax);
      }
    }
    __syncthreads();
    // 2. the rows quantized into shared memory, kVec elements a thread step
    for (int k0 = tid * kVec; k0 < K; k0 += kThreads * kVec) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          const float sc = exp2i_f(-s.e[r]);
          float v[kVec];
          load_vec(x + static_cast<size_t>(row0 + r) * K + k0, v);
          unsigned* dst = reinterpret_cast<unsigned*>(s.xq + r * K + k0);
#pragma unroll
          for (int j4 = 0; j4 < kVec / 4; ++j4) {
            unsigned packed = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              packed |= (static_cast<unsigned>(quantize_value(v[4 * j4 + j], sc, qmax)) & 0xFFu) << (8 * j);
            dst[j4] = packed;
          }
        }
      }
    }
  } else {
    for (int i = tid * 16; i < rows * K; i += kThreads * 16) {  // K % 16 == 0: a run never crosses a row
      const int r = i / K, k0 = i % K;
      *reinterpret_cast<uint4*>(s.xq + r * K + k0) =
          __ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(row0 + r) * K + k0));
    }
  }
  __syncthreads();
  wait_group<0>();
  __syncthreads();

  // 3. per-tile sums, clusters in order
  tile_sums(s, w, rows, K, N, group, bk, col0);
  __syncthreads();

  // 4. tile sums in tile order; fused: x 2**(scale_e + e), + bias, activation
  const float se = kFused ? static_cast<float>(scale_e[0]) : 0.0f;
  for (int i = tid; i < rows * kBn; i += kThreads) {
    const int r = i / kBn, c = i % kBn, col = col0 + c;
    if (col >= N) continue;
    float o = 0.0f;
    for (int t = 0; t < n_tiles(K, bk); ++t) o = __fadd_rn(o, s.part[(t * rows + r) * kBn + c]);
    if constexpr (kFused) {
      o = __fmul_rn(o, exp2i_f(__fadd_rn(se, s.e[r])));
      if (bias != nullptr) o = __fadd_rn(o, bias[col]);
      o = activate(o, act);
    }
    out[static_cast<size_t>(row0 + r) * N + col] = o;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* scale_m, const void* scale_e, const void* bias,
                   void* out, int M, int K, int N, int group, int bk, int rpb, int act, int act_bits, int has_static,
                   int static_e, cudaStream_t stream) {
  auto kernel = gemv8_kernel<T>;
  static bool configured = false;
  const cudaError_t err = raise_smem_cap(kernel, configured);
  if (err != cudaSuccess) return err;
  const int rows = M < rpb ? M : rpb;
  kernel<<<dim3((N + kBn - 1) / kBn, (M + rpb - 1) / rpb), kThreads, smem_bytes(rows, K, group, bk), stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w), static_cast<const int8_t*>(scale_m),
      static_cast<const int*>(scale_e), static_cast<const float*>(bias), static_cast<float*>(out), M, K, N, group,
      bk, rpb, act, act_bits, has_static, static_e);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gemv8
}  // namespace qmm
