// Unfused quantized matmul for Hopper (sm_90a): int8 activations (already
// quantized by quantize_rows.cu) x packed weights -> f32 cluster sums,
// without exponents.  Replaces the TPU kernel
// repro/kernels/_common.py::packed_qmm_call (_packed_kernel).  The wrapper,
// the plain PyTorch version and the design notes are in
// src/repro_torch/kernels/packed_qmm.py.
//
// M > 8 (packed_qmm_tile_launch): the int8 tensor-core tile of
// qmm_mma.cuh over x_q as given, writing the raw sums -- the fused site's
// tile, so its sums equal the fused kernel's bit for bit.
//
// M <= 8 (packed_qmm_launch, packed_qmm_int8_launch): the fused site's
// GEMV (qmm_gemv.cuh; the int8 loop: qmm_gemv8.cuh) over x_q as given, writing the
// raw sums -- the same plan, steps and float order, so the sums equal the
// fused kernel's bit for bit, and the caller's exponent, bias and
// activation reproduce the fused site.
//
// MoE expert sites: E sites of one shape stacked -- x_q (E, M, K), weights
// (E, ...), scale mantissas (E, K / G, N), out (E, M, N).  M > 8: the tile,
// the expert a grid axis (the reference's jax.vmap over its pallas_call).
// M <= 8 (packed_qmm_experts_launch): qmm_gemv_experts.cuh, a scan of x's
// rows and one persistent GEMV over the routed experts only, the skipped
// experts' out written as +0 -- each expert's sums bit for bit its own
// launch's, every decode.
#include "qmm_gemv.cuh"
#include "qmm_gemv8.cuh"
#include "qmm_gemv_experts.cuh"
#include "qmm_mma.cuh"

// M <= 8: the GEMV over the wrapper's plan (see fused_qmm.cu).
extern "C" int packed_qmm_launch(int decode, const void* xq, const void* w, const void* scale_m, void* out, int M,
                                 int K, int N, int group, int bk, int tps, int splits, int wn,
                                 int cpp, int items, int grid_x, int tpc, int pull, unsigned lut0, unsigned lut1,
                                 unsigned lut2, unsigned lut3, size_t smem, void* stream) {
  const qmm::gemv::Args a{xq, w, static_cast<const int8_t*>(scale_m), nullptr, nullptr, static_cast<float*>(out),
                          M, K, N, group, bk, 0, 8, 0, 0, tps, splits, wn, cpp, items, tpc, pull,
                          make_uint4(lut0, lut1, lut2, lut3)};
  return static_cast<int>(qmm::gemv::launch_any<int8_t>(decode, a, grid_x, smem, static_cast<cudaStream_t>(stream)));
}

// M <= 8, the int8 loop (see fused_qmm.cu).
extern "C" int packed_qmm_int8_launch(const void* xq, const void* w, const void* scale_m, void* out, void* ws,
                                      void* counters, int M, int K, int N, int group, int bk, int rows, int splits,
                                      int tps, int warps, int grid_x, size_t smem, void* stream) {
  const qmm::gemv8::Args a{xq, static_cast<const int8_t*>(w), static_cast<const int8_t*>(scale_m), nullptr,
                           nullptr, static_cast<float*>(out), static_cast<float*>(ws), static_cast<int*>(counters),
                           M, K, N, group, bk, 0, 8, 0, 0, rows, splits, tps};
  return static_cast<int>(
      qmm::gemv8::launch<int8_t>(a, warps, grid_x, smem, static_cast<cudaStream_t>(stream)));
}

// M <= 8 over E experts (flags: E x P ints of scratch; grid: the wrapper's
// persistent blocks; smem: its shared-memory plan).
extern "C" int packed_qmm_experts_launch(int decode, const void* xq, const void* w, const void* scale_m, void* flags,
                                         void* out, int E, int P, int M, int K, int N, int group, int bk,
                                         unsigned lut0, unsigned lut1, unsigned lut2, unsigned lut3, int grid,
                                         size_t smem, void* stream) {
  const qmm::gemv::ExpertArgs a{static_cast<const int8_t*>(xq), w, static_cast<const int8_t*>(scale_m),
                                static_cast<const int*>(flags), static_cast<float*>(out), E, P, M, K, N, group, bk,
                                make_uint4(lut0, lut1, lut2, lut3)};
  return static_cast<int>(qmm::gemv::launch_experts(decode, a, grid, smem, static_cast<cudaStream_t>(stream)));
}

// M > 8: the tensor-core tile over `splits` k-splits of `tps` k-tiles each
// (ws, counters: the splits' scratch, unused when splits == 1; smem: the
// wrapper's shared-memory plan; with experts, ws holds E scratches and
// counters E x the blocks).
extern "C" int packed_qmm_tile_launch(int decode, int group, const void* xq, const void* w, const void* scale_m,
                                      void* out, void* ws, void* counters, int M, int K, int N, int bk, int tps,
                                      int splits, unsigned lut0, unsigned lut1, unsigned lut2, unsigned lut3,
                                      size_t smem, int experts, void* stream) {
  const qmm::tile::Args a{static_cast<const int8_t*>(xq), w, static_cast<const int8_t*>(scale_m), nullptr,
                          nullptr, nullptr, static_cast<float*>(out), static_cast<float*>(ws),
                          static_cast<int*>(counters), M, K, N, bk, tps, splits, 0,
                          make_uint4(lut0, lut1, lut2, lut3)};
  return static_cast<int>(qmm::tile::launch_any(decode, group, a, smem, static_cast<cudaStream_t>(stream), experts));
}
