// The two-pass quantize_rows (one block a row, the row read twice) and an
// empty kernel, kept for tools/quantize_rows_times.py; no part of the package.
// Per-row dynamic DFP activation quantization for Hopper (sm_90a).
// Replaces the TPU kernel repro/kernels/quantize.py::quantize_rows (_kernel).
// The wrapper, the plain PyTorch version and the design notes are in
// src/repro_torch/kernels/quantize.py.
//
// Grid (M); 256 threads, one block per row (qmm::quantize_row, shared with
// the fused site's pre-pass): max |x| (and whether the row holds a NaN)
// with 16-byte loads, reduced across the block; the exponent by the fused
// kernel's own rules (qmm::row_exponent), stored as int32 the way XLA
// casts a float (+-inf -> the int32 extremes); then the row again (from
// L1/L2), each value rounded by qmm::quantize_value, kVec bytes a store.
#include <limits.h>

#include "../src/repro_torch/csrc/qmm_common.cuh"

namespace {

using namespace qmm;

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q, int* __restrict__ e_out, int D,
                     int bits) {
  const size_t row = blockIdx.x;
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  const float e = quantize_row(x + row * D, q + row * D, D, qmax, false, 0.0f);
  if (threadIdx.x == 0) e_out[row] = isinf(e) ? (e > 0.0f ? INT_MAX : INT_MIN) : static_cast<int>(e);
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

// The timer's floor: a kernel that does nothing.
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
