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
// M <= 8 (packed_qmm_launch): the fused kernel (fused_qmm.cu) without its
// prologue and epilogue: grid
// (ceil(N / kBn), ceil(M / rpb)), 256 threads, the block's int8 rows copied
// into shared memory (16 bytes a thread step; ternary rows interleaved as
// the 2-bit decode reads them), the same k-tile loop (qmm::tile_sums) and
// the tile sums in tile order -- so the sums equal the fused kernel's bit
// for bit, and the caller's exponent, bias and activation reproduce the
// fused site.
#include "qmm_mma.cuh"

namespace {

using namespace qmm;

template <int D>
__global__ void __launch_bounds__(kThreads)
packed_qmm_kernel(const int8_t* __restrict__ xq, const void* __restrict__ w,
                  const int8_t* __restrict__ scale_m, float* __restrict__ out,
                  int M, int K, int N, int group, int bk, int rpb, uint4 lut) {
  constexpr int kBn = Layout<D>::kBn;
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.y * rpb;
  const int rows = min(rpb, M - row0);
  const int col0 = blockIdx.x * kBn;
  const Smem s = carve(smem, min(rpb, M), K, bk, kBn);
  const int tid = threadIdx.x;

  start_weight_loads<D>(s, scale_m, w, K, N, group, bk, col0);
  for (int i = tid * 16; i < rows * K; i += kThreads * 16) {
    const int r = i / K, k0 = i % K;  // K % 16 == 0: a 16-byte run never crosses a row
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(xq + static_cast<size_t>(row0 + r) * K + k0));
    if constexpr (D == kTernary) {
      const unsigned b[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        s.xq[r * K + x_byte<D>(k0 + j)] = static_cast<int8_t>((b[j / 4] >> (8 * (j % 4))) & 0xFFu);
    } else {
      *reinterpret_cast<uint4*>(s.xq + r * K + k0) = v;
    }
  }
  __syncthreads();
  cp_async_wait_all();
  __syncthreads();

  tile_sums<D>(s, w, lut, rows, K, N, group, bk, col0);
  __syncthreads();

  for (int i = tid; i < rows * kBn; i += kThreads) {
    const int r = i / kBn, c = i % kBn, col = col0 + c;
    if (col < N) out[static_cast<size_t>(row0 + r) * N + col] = sum_tiles(s, K / bk, rows, kBn, r, c);
  }
}

template <int D>
cudaError_t launch(const void* xq, const void* w, const void* scale_m, void* out, int M, int K, int N,
                   int group, int bk, int rpb, uint4 lut, cudaStream_t stream) {
  constexpr int kBn = Layout<D>::kBn;
  auto kernel = packed_qmm_kernel<D>;
  static bool configured = false;
  const cudaError_t err = raise_smem_cap(kernel, configured);
  if (err != cudaSuccess) return err;
  const int rows = M < rpb ? M : rpb;
  const dim3 grid((N + kBn - 1) / kBn, (M + rpb - 1) / rpb);
  kernel<<<grid, kThreads, smem_bytes(rows, K, group, bk, kBn), stream>>>(
      static_cast<const int8_t*>(xq), w, static_cast<const int8_t*>(scale_m), static_cast<float*>(out),
      M, K, N, group, bk, rpb, lut);
  return cudaGetLastError();
}

}  // namespace

extern "C" int packed_qmm_launch(int decode, const void* xq, const void* w, const void* scale_m, void* out,
                                 int M, int K, int N, int group, int bk, int rpb, unsigned lut0, unsigned lut1,
                                 unsigned lut2, unsigned lut3, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4 lut = make_uint4(lut0, lut1, lut2, lut3);
  cudaError_t err;
  switch (decode) {
    case qmm::kTernary: err = launch<qmm::kTernary>(xq, w, scale_m, out, M, K, N, group, bk, rpb, lut, s); break;
    case qmm::kInt8: err = launch<qmm::kInt8>(xq, w, scale_m, out, M, K, N, group, bk, rpb, lut, s); break;
    case qmm::kLut4: err = launch<qmm::kLut4>(xq, w, scale_m, out, M, K, N, group, bk, rpb, lut, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// M > 8: the tensor-core tile over `splits` k-splits of `tps` k-tiles each
// (ws, counters: the splits' scratch, unused when splits == 1; smem: the
// wrapper's shared-memory plan).
extern "C" int packed_qmm_tile_launch(int decode, int group, const void* xq, const void* w, const void* scale_m,
                                      void* out, void* ws, void* counters, int M, int K, int N, int bk, int tps,
                                      int splits, unsigned lut0, unsigned lut1, unsigned lut2, unsigned lut3,
                                      size_t smem, void* stream) {
  const qmm::tile::Args a{static_cast<const int8_t*>(xq), w, static_cast<const int8_t*>(scale_m), nullptr,
                          nullptr, nullptr, static_cast<float*>(out), static_cast<float*>(ws),
                          static_cast<int*>(counters), M, K, N, bk, tps, splits, 0,
                          make_uint4(lut0, lut1, lut2, lut3)};
  return static_cast<int>(qmm::tile::launch_any(decode, group, a, smem, static_cast<cudaStream_t>(stream)));
}
