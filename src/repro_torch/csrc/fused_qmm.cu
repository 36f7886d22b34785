// Fused quantized dense site for Hopper (sm_90a).  Replaces the TPU kernel
// repro/kernels/_common.py::fused_qmm_call (_fused_kernel with decode2_tile,
// decode4_tile, decode_nf4_tile or the int8 identity decode).  The wrapper,
// the plain PyTorch version and the design notes are in
// src/repro_torch/kernels/fused_qmm.py; the decodes, the GEMV and the
// tensor-core tile are shared with packed_qmm.cu through qmm_common.cuh,
// qmm_gemv.cuh and qmm_mma.cuh.
//
// M > 8 (fused_qmm_tile_launch): two launches.  A pre-pass quantizes each
// row of x once (qmm::quantize_row, one block a row) into int8 scratch and
// float exponents; then the int8 tensor-core tile of qmm_mma.cuh with this
// site's epilogue.
//
// M <= 8: one launch of the GEMV -- qmm_gemv.cuh for the 2- and 4-bit
// decodes and the int8 sites the int8 loop does not take (fused_qmm_launch),
// the int8 loop qmm_gemv8.cuh (fused_qmm_int8_launch) -- with the rows'
// exponents and int8 mantissas in each block's prologue and this site's
// epilogue.
#include "qmm_gemv.cuh"
#include "qmm_gemv8.cuh"
#include "qmm_mma.cuh"

namespace {

using namespace qmm;

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

}  // namespace

// M <= 8: the GEMV over the wrapper's plan (fused_qmm.py::gemv_plan): grid
// (grid_x, splits), clusters of the splits, `smem` bytes (the kernel refuses
// another size).
extern "C" int fused_qmm_launch(int x_is_bf16, int decode, const void* x, const void* w, const void* scale_m,
                                const void* scale_e, const void* bias, void* out, int M,
                                int K, int N, int group, int bk, int act, int act_bits, int has_static, int static_e,
                                int tps, int splits, int wn, int cpp, int items, int grid_x, int tpc, int pull,
                                unsigned lut0, unsigned lut1, unsigned lut2, unsigned lut3, size_t smem,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const qmm::gemv::Args a{x, w, static_cast<const int8_t*>(scale_m), static_cast<const int*>(scale_e),
                          static_cast<const float*>(bias), static_cast<float*>(out), M, K, N, group, bk, act,
                          act_bits, has_static, static_e,
                          tps, splits, wn, cpp, items, tpc, pull, make_uint4(lut0, lut1, lut2, lut3)};
  return static_cast<int>(x_is_bf16 ? qmm::gemv::launch_any<__nv_bfloat16>(decode, a, grid_x, smem, s)
                                    : qmm::gemv::launch_any<float>(decode, a, grid_x, smem, s));
}

// M <= 8, the int8 loop over the wrapper's plan (fused_qmm.py::int8_loop_plan):
// grid (grid_x, ceil(M / rows)) of `warps` warps, `smem` bytes (the kernel
// refuses another size); ws, counters: the k-splits' scratch, unused when
// splits == 1.
extern "C" int fused_qmm_int8_launch(int x_is_bf16, const void* x, const void* w, const void* scale_m,
                                     const void* scale_e, const void* bias, void* out, void* ws, void* counters,
                                     int M, int K, int N, int group, int bk, int rows, int splits, int tps,
                                     int warps, int grid_x, int act, int act_bits, int has_static, int static_e,
                                     size_t smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const qmm::gemv8::Args a{x, static_cast<const int8_t*>(w), static_cast<const int8_t*>(scale_m),
                           static_cast<const int*>(scale_e), static_cast<const float*>(bias),
                           static_cast<float*>(out), static_cast<float*>(ws), static_cast<int*>(counters),
                           M, K, N, group, bk, act, act_bits, has_static, static_e, rows, splits, tps};
  return static_cast<int>(x_is_bf16 ? qmm::gemv8::launch<__nv_bfloat16>(a, warps, grid_x, smem, s)
                                    : qmm::gemv8::launch<float>(a, warps, grid_x, smem, s));
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
