// Fused quantized dense site for Hopper (sm_90a): one kernel per PTQ
// projection.  Replaces the TPU kernel repro/kernels/_common.py::fused_qmm_call
// (_fused_kernel with decode2_tile, or the int8 identity decode).  The
// wrapper, the plain PyTorch version and the design notes are in
// src/repro_torch/kernels/fused_qmm.py.
//
// Grid (ceil(N / BN), ceil(M / 8)); 256 threads.  A block owns BN output
// columns (ternary: one per lane; int8: four per lane) and up to 8 rows:
//   1. per-row exponent over the full K row (or the static one), all
//      threads reading x with 16-byte loads,
//   2. the rows quantized to int8 into shared memory (ternary: interleaved
//      within 16-element groups so a decoded word meets its x bytes),
//   3. warp w reduces the k-tiles w, w+8, ... (tile = bk elements): per
//      cluster an int32 __dp4a dot, one multiply by the scale mantissa, the
//      cluster sums added in order; each tile's sum goes to shared memory,
//   4. the tile sums are added in tile order, then the epilogue.
// Every float product and sum uses __fmul_rn / __fadd_rn so no fma changes
// a bit against the plain version (the file is also built with --fmad=false).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;
constexpr float kLn2 = 0.693147182464599609375f;  // float32(log(2))
constexpr float kTiny = 1.17549435082228750797e-38f;

enum { ACT_NONE = 0, ACT_SILU = 1, ACT_GELU = 2, ACT_RELU = 3 };

__device__ __forceinline__ float exp2i_f(float e) {
  // exact 2**e from the exponent bits; e integer-valued (or +-inf)
  e = fminf(fmaxf(e, -126.0f), 127.0f);
  return __int_as_float((static_cast<int>(e) + 127) << 23);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// one 16-byte load: 4 float32 or 8 bf16 values, widened to float
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ float activate(float y, int act) {
  if (act == ACT_SILU) {
    const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-y)));
    return __fmul_rn(y, s);
  }
  if (act == ACT_GELU) {
    const float c = 0.7978845834732055664f;  // float32(sqrt(2 / pi))
    const float cube = __fmul_rn(__fmul_rn(y, y), y);
    const float inner = __fmul_rn(c, __fadd_rn(y, __fmul_rn(0.044715f, cube)));
    const float cdf = __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner)));
    return __fmul_rn(y, cdf);
  }
  if (act == ACT_RELU) return isnan(y) ? y : fmaxf(y, 0.0f);
  return y;
}

template <typename T, bool kTernary>
__global__ void __launch_bounds__(kThreads)
fused_qmm_kernel(const T* __restrict__ x, const void* __restrict__ w,
                 const int8_t* __restrict__ scale_m, const int* __restrict__ scale_e,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int M, int K, int N, int group, int bk, int act, int act_bits,
                 int has_static, int static_e) {
  constexpr int kCpt = kTernary ? 1 : 4;  // output columns per lane
  constexpr int kBn = 32 * kCpt;          // output columns per block
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, M - row0);
  const int rows_alloc = min(kRows, M);
  const int col0 = blockIdx.x * kBn;
  const int ntiles = K / bk;
  int8_t* xq = reinterpret_cast<int8_t*>(smem);                        // [rows][K]
  float* e_sh = reinterpret_cast<float*>(smem + rows_alloc * K);       // [kRows]
  float* part = e_sh + kRows;                                          // [ntiles][rows][kBn]
  int8_t* sm_sh = reinterpret_cast<int8_t*>(part + ntiles * rows_alloc * kBn);  // [K/group][kBn]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 0. start the loads that do not depend on x, so their latency hides
  // behind the prologue: this block's scale mantissas stream into shared
  // memory (cp.async), and each warp's first k-tile of ternary words into L2
  const int n_groups = K / group;
  for (int i = tid; i < n_groups * (kBn / 4); i += kThreads) {
    const int g = i / (kBn / 4), c4 = (i % (kBn / 4)) * 4;
    if (col0 + c4 < N)
      cp_async4(sm_sh + g * kBn + c4, scale_m + static_cast<size_t>(g) * N + col0 + c4);
  }
  cp_async_commit();
  if constexpr (kTernary) {
    if (warp < ntiles && col0 + lane < N) {
      const int32_t* wp = static_cast<const int32_t*>(w) + static_cast<size_t>(warp) * (bk / 16) * N + col0 + lane;
      for (int u = 0; u < bk / 16; ++u) prefetch_l2(wp + static_cast<size_t>(u) * N);
    }
  }
  const float qmax = static_cast<float>((1 << (act_bits - 1)) - 1);

  // 1. per-row exponents (float, as the reference kernel keeps them).  All
  // threads stride the rows with 16-byte loads; a row's max is reduced
  // across the block.  fmaxf drops NaN, so a NaN is tracked on the side.
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  __shared__ float red_m[kWarps][kRows];
  __shared__ int red_nan[kWarps][kRows];
  if (has_static) {
    if (tid < kRows) e_sh[tid] = static_cast<float>(static_e);
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
      float e = 0.0f;  // max == 0 (or subnormal) or a NaN in the row -> e = 0
      if (!any_nan && mx >= kTiny) {
        float q = __fdiv_rn(fmaxf(mx, kTiny), qmax);
        if (q < kTiny) q = 0.0f;  // the reference flushes a subnormal quotient
        e = ceilf(__fdiv_rn(logf(q), kLn2));
      }
      e_sh[tid] = e;
    }
  }
  __syncthreads();

  // 2. quantize the rows into shared memory, kVec elements per thread step
  for (int k0 = tid * kVec; k0 < K; k0 += kThreads * kVec) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        const float sc = exp2i_f(-e_sh[r]);
        float v[kVec];
        load_vec(x + static_cast<size_t>(row0 + r) * K + k0, v);
        unsigned packed[kVec / 4];
#pragma unroll
        for (int j = 0; j < kVec / 4; ++j) packed[j] = 0;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float y = __fmul_rn(v[j], sc);
          const int q = isnan(y) ? 0 : static_cast<int>(fminf(fmaxf(rintf(y), -qmax), qmax));
          packed[j / 4] |= (static_cast<unsigned>(q) & 0xFFu) << (8 * (j % 4));
        }
        if constexpr (kTernary) {
          // ternary rows are stored interleaved within each 16-element group
          // (element 4q + j at byte 4j + q) to match the weight decode below
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            const int k = k0 + j;
            xq[r * K + (k & ~15) + ((k & 3) << 2) + ((k >> 2) & 3)] =
                static_cast<int8_t>((packed[j / 4] >> (8 * (j % 4))) & 0xFFu);
          }
        } else {
          unsigned* dst = reinterpret_cast<unsigned*>(xq + r * K + k0);
#pragma unroll
          for (int j = 0; j < kVec / 4; ++j) dst[j] = packed[j];
        }
      }
    }
  }
  __syncthreads();

  cp_async_wait_all();
  __syncthreads();

  // 3. per-tile sums, clusters in order.  Weights load in chunks of
  // kChunk units (a ternary word = 16 k, an int8 unit = 4 k-rows) so each
  // lane keeps several loads in flight; a cluster closes every
  // `per_cluster` units, whatever the chunk boundaries.
  constexpr int kChunk = 8;  // a full unroll of more units bloats the code (instruction cache)
  const int unit_k = kTernary ? 16 : 4;
  const int per_cluster = group / unit_k;
  const int units = bk / unit_k;
  for (int t = warp; t < ntiles; t += kWarps) {
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
        int wv[kChunk][kCpt];
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          const int u = u0 + i;
          if (u < units) {
            if constexpr (kTernary) {
              const int32_t* wp = static_cast<const int32_t*>(w);
              wv[i][0] = __ldg(wp + static_cast<size_t>(t * bk / 16 + u) * N + col);
            } else {
              const int8_t* wp = static_cast<const int8_t*>(w);
#pragma unroll
              for (int c = 0; c < 4; ++c)
                wv[i][c] = __ldg(reinterpret_cast<const int*>(
                    wp + static_cast<size_t>(t * bk + u * 4 + c) * N + col));
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          const int u = u0 + i;
          if (u >= units) break;
          const int k0 = t * bk + u * unit_k;
          if constexpr (kTernary) {
            // 16 codes -> 4 words of int8 lanes; word j holds codes
            // 4q + j (q = 0..3), each ((c + 1) & 3) - 1 by byte-wise SIMD
            const unsigned word = static_cast<unsigned>(wv[i][0]);
            int wl[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const unsigned c = (word >> (2 * j)) & 0x03030303u;
              wl[j] = static_cast<int>(__vsub4((c + 0x01010101u) & 0x03030303u, 0x01010101u));
            }
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              if (r < rows) {
                const int4 xw = *reinterpret_cast<const int4*>(xq + r * K + k0);
                dot[r][0] = __dp4a(wl[0], xw.x, dot[r][0]);
                dot[r][0] = __dp4a(wl[1], xw.y, dot[r][0]);
                dot[r][0] = __dp4a(wl[2], xw.z, dot[r][0]);
                dot[r][0] = __dp4a(wl[3], xw.w, dot[r][0]);
              }
            }
          } else {
            // 4 k-rows x 4 columns of bytes -> one 4-k word per column
            const unsigned t0 = __byte_perm(wv[i][0], wv[i][1], 0x5140);
            const unsigned t1 = __byte_perm(wv[i][2], wv[i][3], 0x5140);
            const unsigned t2 = __byte_perm(wv[i][0], wv[i][1], 0x7362);
            const unsigned t3 = __byte_perm(wv[i][2], wv[i][3], 0x7362);
            const int cw[4] = {
                static_cast<int>(__byte_perm(t0, t1, 0x5410)), static_cast<int>(__byte_perm(t0, t1, 0x7632)),
                static_cast<int>(__byte_perm(t2, t3, 0x5410)), static_cast<int>(__byte_perm(t2, t3, 0x7632))};
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              if (r < rows) {
                const int xw = *reinterpret_cast<const int*>(xq + r * K + k0);
#pragma unroll
                for (int c = 0; c < kCpt; ++c) dot[r][c] = __dp4a(cw[c], xw, dot[r][c]);
              }
            }
          }
          if (++in_cluster == per_cluster) {  // one multiply per cluster
#pragma unroll
            for (int c = 0; c < kCpt; ++c) {
              const float sm = static_cast<float>(sm_sh[g * kBn + lane * kCpt + c]);
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
        for (int c = 0; c < kCpt; ++c) part[(t * rows + r) * kBn + lane * kCpt + c] = acc[r][c];
  }
  __syncthreads();

  // 4. tile sums in order, then x 2**(scale_e + e), + bias, activation
  const float se = static_cast<float>(scale_e[0]);
  for (int i = tid; i < rows * kBn; i += kThreads) {
    const int r = i / kBn, c = i % kBn, col = col0 + c;
    if (col >= N) continue;
    float o = 0.0f;
    for (int t = 0; t < ntiles; ++t) o = __fadd_rn(o, part[(t * rows + r) * kBn + c]);
    float y = __fmul_rn(o, exp2i_f(__fadd_rn(se, e_sh[r])));
    if (bias != nullptr) y = __fadd_rn(y, bias[col]);
    out[static_cast<size_t>(row0 + r) * N + col] = activate(y, act);
  }
}

// Allow the largest dynamic shared memory a block can have next to the
// kernel's static shared memory (227 KB in all on Hopper).
template <typename Kernel>
cudaError_t raise_smem_cap(Kernel kernel) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              232448 - static_cast<int>(attr.sharedSizeBytes));
}

template <typename T, bool kTernary>
cudaError_t launch(const void* x, const void* w, const void* scale_m, const void* scale_e,
                   const void* bias, void* out, int M, int K, int N, int group, int bk,
                   int act, int act_bits, int has_static, int static_e, cudaStream_t stream) {
  constexpr int kBn = kTernary ? 32 : 128;
  auto kernel = fused_qmm_kernel<T, kTernary>;
  static bool configured = false;  // raise the dynamic shared-memory cap once
  if (!configured) {
    const cudaError_t err = raise_smem_cap(kernel);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int rows = M < kRows ? M : kRows;
  const size_t smem = static_cast<size_t>(rows) * K + 4 * kRows +
                      static_cast<size_t>(K / bk) * rows * kBn * 4 + static_cast<size_t>(K / group) * kBn;
  const dim3 grid((N + kBn - 1) / kBn, (M + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), w, static_cast<const int8_t*>(scale_m),
      static_cast<const int*>(scale_e), static_cast<const float*>(bias), static_cast<float*>(out),
      M, K, N, group, bk, act, act_bits, has_static, static_e);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_qmm_launch(int x_is_bf16, int ternary, const void* x, const void* w,
                                const void* scale_m, const void* scale_e, const void* bias,
                                void* out, int M, int K, int N, int group, int bk, int act,
                                int act_bits, int has_static, int static_e, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_is_bf16) {
    err = ternary ? launch<__nv_bfloat16, true>(x, w, scale_m, scale_e, bias, out, M, K, N, group, bk, act, act_bits, has_static, static_e, s)
                  : launch<__nv_bfloat16, false>(x, w, scale_m, scale_e, bias, out, M, K, N, group, bk, act, act_bits, has_static, static_e, s);
  } else {
    err = ternary ? launch<float, true>(x, w, scale_m, scale_e, bias, out, M, K, N, group, bk, act, act_bits, has_static, static_e, s)
                  : launch<float, false>(x, w, scale_m, scale_e, bias, out, M, K, N, group, bk, act, act_bits, has_static, static_e, s);
  }
  return static_cast<int>(err);
}
