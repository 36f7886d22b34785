// Diagnostic build of the grid-z expert-batched packed GEMV (a copy of its
// qmm_gemv.cuh with a stage switch, ternary at group 64 only) and a plain
// read of the same bytes.  Driven by tools/gemv_stages/gemv_stages.py;
// no part of the package.
#include "qmm_gemv_grid_z.cuh"

// kStage 0: the weight stream into the ring alone; 1: + the decode;
// 2: + mma.sync; 3: + the per-cluster rescale and piece slots; 4: the
// whole kernel (the items' reductions and cluster barriers).
extern "C" int stage_launch(int stage, const void* xq, const void* w, const void* scale_m, void* out, int M, int K,
                            int N, int group, int bk, int tps, int splits, int wn, int cpp, int items, int grid_x,
                            int tpc, int pull, size_t smem, int experts, void* stream) {
  const qmm::gemv::Args a{xq, w, static_cast<const int8_t*>(scale_m), nullptr, nullptr, static_cast<float*>(out),
                          M, K, N, group, bk, 0, 8, 0, 0, tps, splits, wn, cpp, items, tpc, pull,
                          make_uint4(0, 0, 0, 0)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: return qmm::gemv::launch_stage<0>(a, grid_x, smem, s, experts);
    case 1: return qmm::gemv::launch_stage<1>(a, grid_x, smem, s, experts);
    case 2: return qmm::gemv::launch_stage<2>(a, grid_x, smem, s, experts);
    case 3: return qmm::gemv::launch_stage<3>(a, grid_x, smem, s, experts);
    case 4: return qmm::gemv::launch_stage<4>(a, grid_x, smem, s, experts);
    default: return 1;
  }
}

// 16-byte loads of n16 vectors, `unroll` in flight a thread, XOR-reduced.
__global__ void read_kernel(const uint4* __restrict__ p, long long n16, unsigned* sink) {
  unsigned acc = 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; i + 7 * stride < n16; i += 8 * stride) {
    uint4 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __ldg(p + i + j * stride);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc ^= v[j].x ^ v[j].y ^ v[j].z ^ v[j].w;
  }
  for (; i < n16; i += stride) {
    const uint4 v = __ldg(p + i);
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (acc == 0x9E3779B9u) *sink = acc;
}

extern "C" int read_launch(const void* p, long long n16, void* sink, int blocks, void* stream) {
  read_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const uint4*>(p), n16,
                                                                      static_cast<unsigned*>(sink));
  return static_cast<int>(cudaGetLastError());
}
