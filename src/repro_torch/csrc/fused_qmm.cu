// Fused quantized dense site for Hopper (sm_90a).  Replaces the TPU kernel
// repro/kernels/_common.py::fused_qmm_call (_fused_kernel with decode2_tile,
// decode4_tile, decode_nf4_tile or the int8 identity decode).  The wrapper,
// the plain PyTorch version and the design notes are in
// src/repro_torch/kernels/fused_qmm.py; the decodes, the GEMV k-tile loop
// and the tensor-core tile are shared with packed_qmm.cu through
// qmm_common.cuh and qmm_mma.cuh.
//
// M > 8 (fused_qmm_tile_launch): two launches.  A pre-pass quantizes each
// row of x once (qmm::quantize_row, one block a row) into int8 scratch and
// float exponents; then the int8 tensor-core tile of qmm_mma.cuh with this
// site's epilogue.
//
// M <= 8 (fused_qmm_launch), one launch:
// grid (ceil(N / kBn), ceil(M / rpb)); 256 threads.  A block owns kBn output
// columns (2- and 4-bit: one per lane; int8: four per lane) and up to rpb
// rows (8, fewer where the wrapper finds K's rows too large for shared
// memory):
//   1. per-row exponent over the full K row (or the static one), all
//      threads reading x with 16-byte loads,
//   2. the rows quantized to int8 into shared memory,
//   3. the k-tile loop (qmm::tile_sums),
//   4. the tile sums added in tile order, then x 2**(scale_e + e), + bias,
//      activation.
#include "qmm_mma.cuh"

namespace {

using namespace qmm;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fused_qmm_kernel(const T* __restrict__ x, const void* __restrict__ w,
                 const int8_t* __restrict__ scale_m, const int* __restrict__ scale_e,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int M, int K, int N, int group, int bk, int rpb, int act, int act_bits,
                 int has_static, int static_e, uint4 lut) {
  constexpr int kBn = Layout<D>::kBn;
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.y * rpb;
  const int rows = min(rpb, M - row0);
  const int col0 = blockIdx.x * kBn;
  const Smem s = carve(smem, min(rpb, M), K, bk, kBn);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  start_weight_loads<D>(s, scale_m, w, K, N, group, bk, col0);
  const float qmax = static_cast<float>((1 << (act_bits - 1)) - 1);

  // 1. per-row exponents (float, as the reference kernel keeps them).  All
  // threads stride the rows with 16-byte loads; a row's max is reduced
  // across the block.  fmaxf drops NaN, so a NaN is tracked on the side.
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  __shared__ float red_m[kWarps][kRows];
  __shared__ int red_nan[kWarps][kRows];
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
          for (int j = 0; j < kVec; ++j) {
            nan[r] |= isnan(v[j]);
            m[r] = fmaxf(m[r], fabsf(v[j]));
          }
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
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w][tid]), any_nan |= red_nan[w][tid];
      s.e[tid] = row_exponent(mx, any_nan, qmax);
    }
  }
  __syncthreads();

  // 2. quantize the rows into shared memory, kVec elements per thread step
  for (int k0 = tid * kVec; k0 < K; k0 += kThreads * kVec) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        const float sc = exp2i_f(-s.e[r]);
        float v[kVec];
        load_vec(x + static_cast<size_t>(row0 + r) * K + k0, v);
        unsigned packed[kVec / 4];
#pragma unroll
        for (int j = 0; j < kVec / 4; ++j) packed[j] = 0;
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          packed[j / 4] |= (static_cast<unsigned>(quantize_value(v[j], sc, qmax)) & 0xFFu) << (8 * (j % 4));
        if constexpr (D == kTernary) {
#pragma unroll
          for (int j = 0; j < kVec; ++j)
            s.xq[r * K + x_byte<D>(k0 + j)] = static_cast<int8_t>((packed[j / 4] >> (8 * (j % 4))) & 0xFFu);
        } else {
          unsigned* dst = reinterpret_cast<unsigned*>(s.xq + r * K + k0);
#pragma unroll
          for (int j = 0; j < kVec / 4; ++j) dst[j] = packed[j];
        }
      }
    }
  }
  __syncthreads();
  cp_async_wait_all();
  __syncthreads();

  // 3. per-tile sums, clusters in order
  tile_sums<D>(s, w, lut, rows, K, N, group, bk, col0);
  __syncthreads();

  // 4. tile sums in order, then x 2**(scale_e + e), + bias, activation
  const float se = static_cast<float>(scale_e[0]);
  for (int i = tid; i < rows * kBn; i += kThreads) {
    const int r = i / kBn, c = i % kBn, col = col0 + c;
    if (col >= N) continue;
    const float o = sum_tiles(s, K / bk, rows, kBn, r, c);
    float y = __fmul_rn(o, exp2i_f(__fadd_rn(se, s.e[r])));
    if (bias != nullptr) y = __fadd_rn(y, bias[col]);
    out[static_cast<size_t>(row0 + r) * N + col] = activate(y, act);
  }
}

// The tile's pre-pass: row blockIdx.x of x -> int8 mantissas and its float exponent.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_pass_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ e, int K, int act_bits,
                     int has_static, int static_e) {
  const size_t row = blockIdx.x;
  const float qmax = static_cast<float>((1 << (act_bits - 1)) - 1);
  const float ex = quantize_row(x + row * K, q + row * K, K, qmax, has_static, static_cast<float>(static_e));
  if (threadIdx.x == 0) e[row] = ex;
}

template <typename T, int D>
cudaError_t launch(const void* x, const void* w, const void* scale_m, const void* scale_e,
                   const void* bias, void* out, int M, int K, int N, int group, int bk, int rpb,
                   int act, int act_bits, int has_static, int static_e, uint4 lut, cudaStream_t stream) {
  constexpr int kBn = Layout<D>::kBn;
  auto kernel = fused_qmm_kernel<T, D>;
  static bool configured = false;
  const cudaError_t err = raise_smem_cap(kernel, configured);
  if (err != cudaSuccess) return err;
  const int rows = M < rpb ? M : rpb;
  const dim3 grid((N + kBn - 1) / kBn, (M + rpb - 1) / rpb);
  kernel<<<grid, kThreads, smem_bytes(rows, K, group, bk, kBn), stream>>>(
      static_cast<const T*>(x), w, static_cast<const int8_t*>(scale_m),
      static_cast<const int*>(scale_e), static_cast<const float*>(bias), static_cast<float*>(out),
      M, K, N, group, bk, rpb, act, act_bits, has_static, static_e, lut);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_decode(int decode, const void* x, const void* w, const void* scale_m, const void* scale_e,
                          const void* bias, void* out, int M, int K, int N, int group, int bk, int rpb,
                          int act, int act_bits, int has_static, int static_e, uint4 lut, cudaStream_t s) {
  switch (decode) {
    case kTernary:
      return launch<T, kTernary>(x, w, scale_m, scale_e, bias, out, M, K, N, group, bk, rpb, act, act_bits, has_static, static_e, lut, s);
    case kInt8:
      return launch<T, kInt8>(x, w, scale_m, scale_e, bias, out, M, K, N, group, bk, rpb, act, act_bits, has_static, static_e, lut, s);
    case kLut4:
      return launch<T, kLut4>(x, w, scale_m, scale_e, bias, out, M, K, N, group, bk, rpb, act, act_bits, has_static, static_e, lut, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int fused_qmm_launch(int x_is_bf16, int decode, const void* x, const void* w,
                                const void* scale_m, const void* scale_e, const void* bias,
                                void* out, int M, int K, int N, int group, int bk, int rpb, int act,
                                int act_bits, int has_static, int static_e, unsigned lut0,
                                unsigned lut1, unsigned lut2, unsigned lut3, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4 lut = make_uint4(lut0, lut1, lut2, lut3);
  const cudaError_t err =
      x_is_bf16 ? launch_decode<__nv_bfloat16>(decode, x, w, scale_m, scale_e, bias, out, M, K, N, group, bk, rpb,
                                               act, act_bits, has_static, static_e, lut, s)
                : launch_decode<float>(decode, x, w, scale_m, scale_e, bias, out, M, K, N, group, bk, rpb, act,
                                       act_bits, has_static, static_e, lut, s);
  return static_cast<int>(err);
}

// M > 8: the pre-pass into xq (M, K) int8 and e (M) float scratch, then the
// tensor-core tile over `splits` k-splits of `tps` k-tiles each (ws,
// counters: the splits' scratch, unused when splits == 1; smem: the
// wrapper's shared-memory plan).
extern "C" int fused_qmm_tile_launch(int x_is_bf16, int decode, int group, const void* x, const void* w,
                                     const void* scale_m, const void* scale_e, const void* bias, void* out,
                                     void* xq, void* e, void* ws, void* counters, int M, int K, int N, int bk,
                                     int tps, int splits, int act, int act_bits, int has_static, int static_e,
                                     unsigned lut0, unsigned lut1, unsigned lut2, unsigned lut3, size_t smem,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    quantize_pass_kernel<__nv_bfloat16><<<M, qmm::kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                                static_cast<int8_t*>(xq), static_cast<float*>(e), K,
                                                                act_bits, has_static, static_e);
  else
    quantize_pass_kernel<float><<<M, qmm::kThreads, 0, s>>>(static_cast<const float*>(x), static_cast<int8_t*>(xq),
                                                        static_cast<float*>(e), K, act_bits, has_static, static_e);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const qmm::tile::Args a{static_cast<const int8_t*>(xq), w, static_cast<const int8_t*>(scale_m),
                     static_cast<const float*>(e), static_cast<const int*>(scale_e), static_cast<const float*>(bias),
                     static_cast<float*>(out), static_cast<float*>(ws), static_cast<int*>(counters),
                     M, K, N, bk, tps, splits, act, make_uint4(lut0, lut1, lut2, lut3)};
  return static_cast<int>(qmm::tile::launch_any(decode, group, a, smem, s));
}
