// Diagnostic build of the package's expert-batched GEMV (a copy of
// qmm_gemv_experts.cuh with a stage switch, ternary at group 64 only).
// Driven by tools/gemv_stages/gemv_stages.py; no part of the package.
#include "qmm_gemv_experts_stages.cuh"

// kStage 0: the stream into the ring alone; 1: + the decode and x's
// permutation; 2: + mma.sync; 3: the whole kernel.  mask: what the ring
// streams beside the weights (qmm_gemv_experts_stages.cuh).
extern "C" int expert_stage_launch(int stage, int mask, int depth, const void* xq, const void* w, const void* scale_m,
                                   void* flags, void* out, int E, int P, int M, int K, int N, int grid, size_t smem,
                                   void* stream) {
  const qmm::gemv::ExpertArgs a{static_cast<const int8_t*>(xq), w, static_cast<const int8_t*>(scale_m),
                                static_cast<const int*>(flags), static_cast<float*>(out), E, P, M, K, N, 64,
                                K < 512 ? K : 512, make_uint4(0, 0, 0, 0)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (depth * 100 + stage * 8 + mask) {
    case 1600: return qmm::gemv::launch_expert_stage<0, 0, 16>(a, grid, smem, s);
    case 3200: return qmm::gemv::launch_expert_stage<0, 0, 32>(a, grid, smem, s);
    case 1602: return qmm::gemv::launch_expert_stage<0, 2, 16>(a, grid, smem, s);
    case 1603: return qmm::gemv::launch_expert_stage<0, 3, 16>(a, grid, smem, s);
    case 0: return qmm::gemv::launch_expert_stage<0, 0>(a, grid, smem, s);
    case 1: return qmm::gemv::launch_expert_stage<0, 1>(a, grid, smem, s);
    case 2: return qmm::gemv::launch_expert_stage<0, 2>(a, grid, smem, s);
    case 3: return qmm::gemv::launch_expert_stage<0, 3>(a, grid, smem, s);
    case 7: return qmm::gemv::launch_expert_stage<0, 7>(a, grid, smem, s);
    case 8 + 3: return qmm::gemv::launch_expert_stage<1, 3>(a, grid, smem, s);
    case 16 + 3: return qmm::gemv::launch_expert_stage<2, 3>(a, grid, smem, s);
    case 24 + 3: return qmm::gemv::launch_expert_stage<3, 3>(a, grid, smem, s);
    case 24 + 7: return qmm::gemv::launch_expert_stage<3, 7>(a, grid, smem, s);
    default: return 1;
  }
}

// Register-load streams over the expert GEMV's units (every expert, a
// unit = (expert, strip of 32 columns) over the whole K, warp w of W taking
// units [w U / W, (w + 1) U / W)), XOR-reduced.  kWide 1: lane (g, t) loads
// the 16 bytes of word row 4 s + t, columns 4g..4g+3 -- the ring's lane map,
// 4 rows x 128 bytes a warp load; kWide 4: a unit is 4 strips and lane l
// loads word row s, columns 4l..4l+3 -- 512 contiguous bytes a warp load.
// kDepth loads in flight a lane.
template <int kDepth, int kWide>
__global__ void __launch_bounds__(256) strip_read_kernel(const uint4* __restrict__ w, int E, int K, int N,
                                                         unsigned* sink) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int strips = N / (32 * kWide), rows = K / 16;
  const long long U = static_cast<long long>(E) * strips, W = static_cast<long long>(gridDim.x) * 8;
  const long long wid = static_cast<long long>(blockIdx.x) * 8 + warp;
  const int u0 = static_cast<int>(wid * U / W), u1 = static_cast<int>((wid + 1) * U / W);
  const int n4 = N / 4;  // uint4 a row
  unsigned acc = 0;
  for (int u = u0; u < u1; ++u) {
    const int e = u / strips, s = u % strips;
    const uint4* base = w + static_cast<size_t>(e) * rows * n4;
    const int col4 = kWide == 1 ? s * 8 + g : s * 32 + lane;  // the lane's uint4 within a row
    const int per = kWide == 1 ? 4 : 1;                        // rows a warp load covers
    for (int r0 = 0; r0 < rows; r0 += per * kDepth) {
      uint4 v[kDepth];
#pragma unroll
      for (int j = 0; j < kDepth; ++j) {
        const int r = r0 + j * per + (kWide == 1 ? t : 0);
        v[j] = r < rows ? __ldg(base + static_cast<size_t>(r) * n4 + col4) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int j = 0; j < kDepth; ++j) acc ^= v[j].x ^ v[j].y ^ v[j].z ^ v[j].w;
    }
  }
  if (acc == 0x9E3779B9u) *sink = acc;
}

extern "C" int strip_read_launch(int depth, int wide, const void* w, int E, int K, int N, void* sink, int grid,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* p = static_cast<const uint4*>(w);
  unsigned* k = static_cast<unsigned*>(sink);
  switch (depth * 10 + wide) {
    case 81: strip_read_kernel<8, 1><<<grid, 256, 0, s>>>(p, E, K, N, k); break;
    case 161: strip_read_kernel<16, 1><<<grid, 256, 0, s>>>(p, E, K, N, k); break;
    case 84: strip_read_kernel<8, 4><<<grid, 256, 0, s>>>(p, E, K, N, k); break;
    case 164: strip_read_kernel<16, 4><<<grid, 256, 0, s>>>(p, E, K, N, k); break;
    default: return 1;
  }
  return static_cast<int>(cudaGetLastError());
}
