// Per-row dynamic DFP activation quantization for Hopper (sm_90a).
// Replaces the TPU kernel repro/kernels/quantize.py::quantize_rows (_kernel).
// The wrapper, the plain PyTorch version, the launch plan and the design
// notes are in src/repro_torch/kernels/quantize.py.
//
// What bounds it: the bytes, x read once and the mantissas written once;
// at the shapes of a decode tick (M = 4, 8 KB rows) the launch and one
// round trip to device memory.  The design:
//
// - Each row is read from device memory once.  A row is split over `cs`
//   blocks of one thread block cluster (cs = 1 for most rows); each thread
//   issues all of its NV 16-byte loads (at most 8) before the reduction and
//   keeps the 16-byte words in registers for the quantize pass.
// - max |x| and whether the row holds a NaN (fmaxf drops NaN, so it is
//   tracked on the side) reduce over the warp, then every thread takes the
//   block's (one block barrier), and with cs > 1 thread 0 the cluster's
//   blocks' through distributed shared memory; a max is order-free, so any
//   split gives the same exponent.  The exponent by the
//   fused kernel's rules (qmm::row_exponent), stored as int32 the way XLA
//   casts a float (+-inf -> the int32 extremes); each value rounded by
//   qmm::quantize_value from the registers, kVec bytes a store.
// - The plan (kernels/quantize.py::rows_plan) takes the fewest blocks a row
//   that hold it in registers, and spreads few long rows over more blocks
//   (a capacity buffer's (64, 32768) f32 rows: 4 blocks a row).  Rows
//   longer than 8 blocks x 256 threads x 8 loads (256 KB) take the
//   two-pass qmm::quantize_row, the fused tile's pre-pass, a block a row.
#include <cooperative_groups.h>
#include <limits.h>

#include "qmm_common.cuh"

namespace {

using namespace qmm;

__device__ __forceinline__ int exponent_i32(float e) {
  return isinf(e) ? (e > 0.0f ? INT_MAX : INT_MIN) : static_cast<int>(e);
}

// 16 bytes of x widened to float, as qmm::load_vec: 4 float32 or 8 bf16 values.
template <typename T>
__device__ __forceinline__ void widen(const uint4& r, float* v) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      v[i] = __uint_as_float(w[i]);
    } else {
      v[2 * i] = __uint_as_float(w[i] << 16), v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
}

// Grid (cs * M), clusters of cs blocks along x: block r of a row's
// cluster holds its vectors [r per, (r + 1) per) of 16 bytes.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q, int* __restrict__ e_out, int D, int bits,
                     int cs) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float red_m[kWarps];
  __shared__ int red_nan[kWarps];
  __shared__ float part_m;  // this block's max and NaN flag, read by the cluster
  __shared__ int part_nan;
  __shared__ float e_sh;  // the row's exponent, from thread 0 of a split row
  const int row = blockIdx.x / cs, rank = blockIdx.x % cs, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nvec = D / kVec, per = (nvec + cs - 1) / cs, v0 = rank * per, v1 = min(nvec, v0 + per);
  const T* xr = x + static_cast<size_t>(row) * D;
  uint4 raw[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {  // every load in flight before the reduction
    const int i = v0 + tid + j * kThreads;
    if (i < v1) raw[j] = __ldg(reinterpret_cast<const uint4*>(xr) + i);
  }
  float m = 0.0f;
  int nan = 0;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (v0 + tid + j * kThreads < v1) {
      float v[kVec];
      widen<T>(raw[j], v);
#pragma unroll
      for (int i = 0; i < kVec; ++i) nan |= isnan(v[i]), m = fmaxf(m, fabsf(v[i]));
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    nan |= __shfl_xor_sync(0xffffffffu, nan, o);
  }
  if (lane == 0) red_m[warp] = m, red_nan[warp] = nan;
  __syncthreads();
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  float mx = 0.0f;  // every thread takes the block's max (order-free) and, for a whole row, the exponent
  int any_nan = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w]), any_nan |= red_nan[w];
  float e;
  if (cs > 1) {
    cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
    if (tid == 0) part_m = mx, part_nan = any_nan;
    cluster.sync();  // every block's part is in its shared memory
    if (tid == 0) {
      for (int r = 0; r < cs; ++r)
        mx = fmaxf(mx, *cluster.map_shared_rank(&part_m, r)), any_nan |= *cluster.map_shared_rank(&part_nan, r);
      e_sh = row_exponent(mx, any_nan, qmax);
    }
    // read: no block leaves while another may still read its part
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    __syncthreads();
    e = e_sh;
  } else {
    e = row_exponent(mx, any_nan, qmax);
  }
  if (rank == 0 && tid == 0) e_out[row] = exponent_i32(e);
  const float sc = exp2i_f(-e);
  int8_t* qr = q + static_cast<size_t>(row) * D;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = v0 + tid + j * kThreads;
    if (i < v1) {
      float v[kVec];
      widen<T>(raw[j], v);
      unsigned packed[kVec / 4];
#pragma unroll
      for (int c = 0; c < kVec / 4; ++c) packed[c] = 0;
#pragma unroll
      for (int c = 0; c < kVec; ++c)
        packed[c / 4] |= (static_cast<unsigned>(quantize_value(v[c], sc, qmax)) & 0xFFu) << (8 * (c % 4));
      if constexpr (kVec == 8) {
        *reinterpret_cast<uint2*>(qr + static_cast<size_t>(i) * kVec) = make_uint2(packed[0], packed[1]);
      } else {
        *reinterpret_cast<unsigned*>(qr + static_cast<size_t>(i) * kVec) = packed[0];
      }
    }
  }
  if (cs > 1) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Rows past the registers of 8 blocks: the two-pass row of qmm_common.cuh, a block a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_long_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q, int* __restrict__ e_out, int D,
                          int bits) {
  const size_t row = blockIdx.x;
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  const float e = quantize_row(x + row * D, q + row * D, D, qmax, false, 0.0f);
  if (threadIdx.x == 0) e_out[row] = exponent_i32(e);
}

template <typename T, int NV>
cudaError_t launch_nv(const T* x, int8_t* q, int* e, int M, int D, int bits, int cs, cudaStream_t s) {
  if (cs == 1) {  // no cluster
    quantize_rows_kernel<T, NV><<<M, kThreads, 0, s>>>(x, q, e, D, bits, 1);
    return cudaGetLastError();
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = cs, cluster.val.clusterDim.y = 1, cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs * M);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, quantize_rows_kernel<T, NV>, x, q, e, D, bits, cs);
}

template <typename T>
cudaError_t launch(const T* x, int8_t* q, int* e, int M, int D, int bits, int cs, int nv, cudaStream_t s) {
  switch (nv) {
    case 0: quantize_long_rows_kernel<T><<<M, kThreads, 0, s>>>(x, q, e, D, bits); return cudaGetLastError();
    case 1: return launch_nv<T, 1>(x, q, e, M, D, bits, cs, s);
    case 2: return launch_nv<T, 2>(x, q, e, M, D, bits, cs, s);
    case 3: return launch_nv<T, 3>(x, q, e, M, D, bits, cs, s);
    case 4: return launch_nv<T, 4>(x, q, e, M, D, bits, cs, s);
    case 5: return launch_nv<T, 5>(x, q, e, M, D, bits, cs, s);
    case 6: return launch_nv<T, 6>(x, q, e, M, D, bits, cs, s);
    case 7: return launch_nv<T, 7>(x, q, e, M, D, bits, cs, s);
    case 8: return launch_nv<T, 8>(x, q, e, M, D, bits, cs, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// cs: blocks a row (one cluster, 1-8); nv: 16-byte loads a thread (1-8), 0
// for the two-pass kernel of long rows -- the wrapper's rows_plan.
extern "C" int quantize_rows_launch(int x_is_bf16, const void* x, void* q, void* e, int M, int D, int bits, int cs,
                                    int nv, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cs < 1 || cs > 8 || (nv == 0 && cs != 1)) return static_cast<int>(cudaErrorInvalidValue);
  int8_t* qq = static_cast<int8_t*>(q);
  int* ee = static_cast<int*>(e);
  return static_cast<int>(x_is_bf16 ? launch(static_cast<const __nv_bfloat16*>(x), qq, ee, M, D, bits, cs, nv, s)
                                    : launch(static_cast<const float*>(x), qq, ee, M, D, bits, cs, nv, s));
}
