// Per-row dynamic DFP activation quantization for Hopper (sm_90a).
// Replaces the TPU kernel repro/kernels/quantize.py::quantize_rows (_kernel).
// The wrapper, the plain PyTorch version and the design notes are in
// src/repro_torch/kernels/quantize.py.
//
// Grid (M); 256 threads, one block per row: max |x| (and whether the row
// holds a NaN) with 16-byte loads, reduced across the block; the exponent
// by the fused kernel's own rules (qmm::row_exponent), stored as int32 the
// way XLA casts a float (+-inf -> the int32 extremes); then the row again (from
// L1/L2), each value rounded by qmm::quantize_value, kVec bytes a store.
#include <limits.h>

#include "qmm_common.cuh"

namespace {

using namespace qmm;

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q, int* __restrict__ e_out, int D,
                     int bits) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float red_m[kWarps];
  __shared__ int red_nan[kWarps];
  __shared__ float e_sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* xr = x + static_cast<size_t>(blockIdx.x) * D;
  int8_t* qr = q + static_cast<size_t>(blockIdx.x) * D;
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);

  float m = 0.0f;
  int nan = 0;
  for (int k0 = tid * kVec; k0 < D; k0 += kThreads * kVec) {
    float v[kVec];
    load_vec(xr + k0, v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) nan |= isnan(v[j]), m = fmaxf(m, fabsf(v[j]));
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    nan |= __shfl_xor_sync(0xffffffffu, nan, o);
  }
  if (lane == 0) red_m[warp] = m, red_nan[warp] = nan;
  __syncthreads();
  if (tid == 0) {
    float mx = 0.0f;
    int any_nan = 0;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w]), any_nan |= red_nan[w];
    const float e = row_exponent(mx, any_nan, qmax);
    e_sh = e;
    e_out[blockIdx.x] = isinf(e) ? (e > 0.0f ? INT_MAX : INT_MIN) : static_cast<int>(e);
  }
  __syncthreads();

  const float sc = exp2i_f(-e_sh);
  for (int k0 = tid * kVec; k0 < D; k0 += kThreads * kVec) {
    float v[kVec];
    load_vec(xr + k0, v);
    unsigned packed[kVec / 4];
#pragma unroll
    for (int j = 0; j < kVec / 4; ++j) packed[j] = 0;
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      packed[j / 4] |= (static_cast<unsigned>(quantize_value(v[j], sc, qmax)) & 0xFFu) << (8 * (j % 4));
    if constexpr (kVec == 8) {
      *reinterpret_cast<uint2*>(qr + k0) = make_uint2(packed[0], packed[1]);
    } else {
      *reinterpret_cast<unsigned*>(qr + k0) = packed[0];
    }
  }
}

}  // namespace

extern "C" int quantize_rows_launch(int x_is_bf16, const void* x, void* q, void* e, int M, int D, int bits,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    quantize_rows_kernel<__nv_bfloat16><<<M, qmm::kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q), static_cast<int*>(e), D, bits);
  } else {
    quantize_rows_kernel<float><<<M, qmm::kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q), static_cast<int*>(e), D, bits);
  }
  return static_cast<int>(cudaGetLastError());
}
