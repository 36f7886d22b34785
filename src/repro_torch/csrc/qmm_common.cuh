// Device code shared by the quantized dense kernels for Hopper (sm_90a):
// fused_qmm.cu (the whole site), packed_qmm.cu (int8 activations already
// quantized) and quantize_rows.cu (the unfused prologue).  One copy of the
// DFP exponent and rounding rules, the row quantizer, the weight decodes,
// the epilogue's activations and the GEMV k-tile loop, so every path
// rounds and sums the same way.  At M > 8 both dense kernels run the
// tensor-core tile of qmm_mma.cuh instead of the GEMV loop below.
//
// The GEMV loop (M <= 8).  A block owns up to kRows rows and kBn output columns.  Its int8 rows sit
// in shared memory (ternary: interleaved within 16-element groups so a
// decoded word meets its x bytes); warp w reduces the k-tiles w, w+8, ...
// (tile = bk elements): per cluster an int32 __dp4a dot, one multiply by
// the scale mantissa, the cluster sums added in order; each tile's sum goes
// to shared memory, and the tile sums are added in tile order.  Every float
// product and sum uses __fmul_rn / __fadd_rn so no fma changes a bit (the
// files are also built with --fmad=false).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qmm {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;
constexpr float kLn2 = 0.693147182464599609375f;  // float32(log(2))
constexpr float kTiny = 1.17549435082228750797e-38f;

// Weight decodes: 16 2-bit ternary codes per int32 word; raw int8 (four
// columns per lane, four k-rows transposed in registers); or 8 4-bit fields
// per word mapped through a 16-entry int8 table (int4: c >= 8 -> c - 16;
// nf4: NF4_LUT_I8), passed by the wrapper as four 32-bit words.
enum Decode : int { kTernary = 0, kInt8 = 1, kLut4 = 2 };

template <int D>
struct Layout {
  static constexpr int kCpt = D == kInt8 ? 4 : 1;                        // output columns per lane
  static constexpr int kBn = 32 * kCpt;                                  // output columns per block
  static constexpr int kUnitK = D == kTernary ? 16 : (D == kInt8 ? 4 : 8);  // K elements per weight unit
};

__device__ __forceinline__ float exp2i_f(float e) {
  // exact 2**e from the exponent bits; e integer-valued (or +-inf)
  e = fminf(fmaxf(e, -126.0f), 127.0f);
  return __int_as_float((static_cast<int>(e) + 127) << 23);
}

// The DFP exponent of a row from its max |x| and whether it holds a NaN,
// as the reference computes it: ceil(log(max / qmax) / log(2)); a zero,
// subnormal or NaN-holding row gets 0, a subnormal quotient is flushed
// (-> -inf).
__device__ __forceinline__ float row_exponent(float mx, int any_nan, float qmax) {
  if (any_nan || !(mx >= kTiny)) return 0.0f;
  float q = __fdiv_rn(mx, qmax);
  if (q < kTiny) q = 0.0f;
  return ceilf(__fdiv_rn(logf(q), kLn2));
}

// One mantissa: round half to even, clip to +-qmax, NaN -> 0.
__device__ __forceinline__ int quantize_value(float v, float scale, float qmax) {
  const float y = __fmul_rn(v, scale);
  return isnan(y) ? 0 : static_cast<int>(fminf(fmaxf(rintf(y), -qmax), qmax));
}

enum { ACT_NONE = 0, ACT_SILU = 1, ACT_GELU = 2, ACT_RELU = 3 };

// The epilogue's activation, rounded as the plain version's torch ops.
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

// The byte of a shared-memory row that holds element k: ternary rows are
// interleaved within each 16-element group (element 4q + j at byte 4j + q)
// to match the 2-bit decode, the other decodes read rows in order.
template <int D>
__device__ __forceinline__ int x_byte(int k) {
  if constexpr (D == kTernary) return (k & ~15) + ((k & 3) << 2) + ((k >> 2) & 3);
  return k;
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

// One row of D values quantized by a whole block of kThreads threads: the
// exponent from max |x| and whether the row holds a NaN (fmaxf drops NaN,
// so it is tracked on the side) by row_exponent, or the static one; then
// every value rounded by quantize_value into qr, 16 bytes of x a load.
// Returns the float exponent in every thread.  quantize_rows.cu and
// fused_qmm.cu's pre-pass of the tensor-core tile share it.
template <typename T>
__device__ __forceinline__ float quantize_row(const T* __restrict__ xr, int8_t* __restrict__ qr, int D, float qmax,
                                              bool has_static, float static_e) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float red_m[kWarps];
  __shared__ int red_nan[kWarps];
  __shared__ float e_sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (has_static) {
    if (tid == 0) e_sh = static_e;
  } else {
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
      e_sh = row_exponent(mx, any_nan, qmax);
    }
  }
  __syncthreads();
  const float e = e_sh;
  const float sc = exp2i_f(-e);
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
  return e;
}

// Four 4-bit fields (the low 16 bits of w) -> four int8 table entries, in
// field order.  The table's 16 bytes are four registers: entries 0-7 in
// (lut.x, lut.y), 8-15 in (lut.z, lut.w); each half is looked up with the
// field's low 3 bits, then bit 3 picks the half byte by byte.
__device__ __forceinline__ int lut4(unsigned w, const uint4& lut) {
  const unsigned sel = w & 0x7777u;
  const unsigned lo = __byte_perm(lut.x, lut.y, sel);
  const unsigned hi = __byte_perm(lut.z, lut.w, sel);
  return static_cast<int>(__byte_perm(lo, hi, 0x3210u | ((w >> 1) & 0x4444u)));
}

// Shared memory of one block: int8 rows [rows][K], exponents [kRows], tile
// sums [ntiles][rows][kBn], the block's scale mantissas [K/group][kBn].
struct Smem {
  int8_t* xq;
  float* e;
  float* part;
  int8_t* sm;
};

__host__ __device__ inline size_t smem_bytes(int rows, int K, int group, int bk, int bn) {
  return static_cast<size_t>(rows) * K + 4 * kRows + static_cast<size_t>(K / bk) * rows * bn * 4 +
         static_cast<size_t>(K / group) * bn;
}

__device__ __forceinline__ Smem carve(unsigned char* smem, int rows_alloc, int K, int bk, int bn) {
  Smem s;
  s.xq = reinterpret_cast<int8_t*>(smem);
  s.e = reinterpret_cast<float*>(smem + rows_alloc * K);
  s.part = s.e + kRows;
  s.sm = reinterpret_cast<int8_t*>(s.part + (K / bk) * rows_alloc * bn);
  return s;
}

// Start the loads that do not depend on x, so their latency hides behind
// the block's own prologue: the scale mantissas stream into shared memory
// (cp.async), and each warp's first k-tile of 2- or 4-bit words into L2.
template <int D>
__device__ __forceinline__ void start_weight_loads(const Smem& s, const int8_t* __restrict__ scale_m,
                                                   const void* __restrict__ w, int K, int N, int group,
                                                   int bk, int col0) {
  constexpr int kBn = Layout<D>::kBn;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_groups = K / group;
  for (int i = tid; i < n_groups * (kBn / 4); i += kThreads) {
    const int g = i / (kBn / 4), c4 = (i % (kBn / 4)) * 4;
    if (col0 + c4 < N) cp_async4(s.sm + g * kBn + c4, scale_m + static_cast<size_t>(g) * N + col0 + c4);
  }
  cp_async_commit();
  if constexpr (D != kInt8) {
    const int units = bk / Layout<D>::kUnitK;
    if (warp < K / bk && col0 + lane < N) {
      const int32_t* wp = static_cast<const int32_t*>(w) + static_cast<size_t>(warp) * units * N + col0 + lane;
      for (int u = 0; u < units; ++u) prefetch_l2(wp + static_cast<size_t>(u) * N);
    }
  }
}

// The k-tile loop: per-tile sums of (cluster dot x scale mantissa), clusters
// in order, into s.part.  Weights load in chunks of kChunk units (a ternary
// word = 16 k, a 4-bit word = 8 k, an int8 unit = 4 k-rows) so each lane
// keeps several loads in flight; a cluster closes every `group / kUnitK`
// units, whatever the chunk boundaries.
template <int D>
__device__ __forceinline__ void tile_sums(const Smem& s, const void* __restrict__ w, const uint4& lut,
                                          int rows, int K, int N, int group, int bk, int col0) {
  using L = Layout<D>;
  constexpr int kCpt = L::kCpt, kBn = L::kBn, kUnitK = L::kUnitK;
  constexpr int kChunk = 8;  // a full unroll of more units bloats the code (instruction cache)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ntiles = K / bk;
  const int per_cluster = group / kUnitK;
  const int units = bk / kUnitK;
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
            if constexpr (D == kInt8) {
              const int8_t* wp = static_cast<const int8_t*>(w);
#pragma unroll
              for (int c = 0; c < 4; ++c)
                wv[i][c] = __ldg(reinterpret_cast<const int*>(wp + static_cast<size_t>(t * bk + u * 4 + c) * N + col));
            } else {
              const int32_t* wp = static_cast<const int32_t*>(w);
              wv[i][0] = __ldg(wp + static_cast<size_t>(t * units + u) * N + col);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          const int u = u0 + i;
          if (u >= units) break;
          const int k0 = t * bk + u * kUnitK;
          if constexpr (D == kTernary) {
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
                const int4 xw = *reinterpret_cast<const int4*>(s.xq + r * K + k0);
                dot[r][0] = __dp4a(wl[0], xw.x, dot[r][0]);
                dot[r][0] = __dp4a(wl[1], xw.y, dot[r][0]);
                dot[r][0] = __dp4a(wl[2], xw.z, dot[r][0]);
                dot[r][0] = __dp4a(wl[3], xw.w, dot[r][0]);
              }
            }
          } else if constexpr (D == kLut4) {
            // 8 fields -> elements 0-3 and 4-7 in order
            const unsigned word = static_cast<unsigned>(wv[i][0]);
            const int lo = lut4(word, lut), hi = lut4(word >> 16, lut);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              if (r < rows) {
                const int2 xw = *reinterpret_cast<const int2*>(s.xq + r * K + k0);
                dot[r][0] = __dp4a(lo, xw.x, dot[r][0]);
                dot[r][0] = __dp4a(hi, xw.y, dot[r][0]);
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
                const int xw = *reinterpret_cast<const int*>(s.xq + r * K + k0);
#pragma unroll
                for (int c = 0; c < kCpt; ++c) dot[r][c] = __dp4a(cw[c], xw, dot[r][c]);
              }
            }
          }
          if (++in_cluster == per_cluster) {  // one multiply per cluster
#pragma unroll
            for (int c = 0; c < kCpt; ++c) {
              const float sm = static_cast<float>(s.sm[g * kBn + lane * kCpt + c]);
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
        for (int c = 0; c < kCpt; ++c) s.part[(t * rows + r) * kBn + lane * kCpt + c] = acc[r][c];
  }
}

// Row r, block column c: the tile sums added in tile order.
__device__ __forceinline__ float sum_tiles(const Smem& s, int ntiles, int rows, int bn, int r, int c) {
  float o = 0.0f;
  for (int t = 0; t < ntiles; ++t) o = __fadd_rn(o, s.part[(t * rows + r) * bn + c]);
  return o;
}

// Allow the largest dynamic shared memory a block can have next to the
// kernel's static shared memory (227 KB in all on Hopper), once per kernel.
template <typename Kernel>
cudaError_t raise_smem_cap(Kernel kernel, bool& configured) {
  if (configured) return cudaSuccess;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             232448 - static_cast<int>(attr.sharedSizeBytes));
  if (err == cudaSuccess) configured = true;
  return err;
}

}  // namespace qmm
