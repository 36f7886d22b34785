// Device code shared by the quantized dense kernels for Hopper (sm_90a):
// fused_qmm.cu (the whole site), packed_qmm.cu (int8 activations already
// quantized) and quantize_rows.cu (the unfused prologue).  One copy of the
// DFP exponent and rounding rules, the row quantizer, the weight decodes,
// the epilogue's activations, and the cp.async / mma.sync helpers of the
// two int8 tensor-core kernels: the GEMV at M <= 8 (qmm_gemv.cuh) and the
// tile at M > 8 (qmm_mma.cuh).  Every float product and sum uses
// __fmul_rn / __fadd_rn (or one __fmaf_rn that is exact before its
// rounding) so no contraction changes a bit (the files are also built
// with --fmad=false).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qmm {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLn2 = 0.693147182464599609375f;  // float32(log(2))
constexpr float kTiny = 1.17549435082228750797e-38f;

// Weight decodes: 16 2-bit ternary codes per int32 word; raw int8 ((K, N)
// rows, transposed 4 x 4 bytes at a time); or 8 4-bit fields per word mapped
// through a 16-entry int8 table (int4: c >= 8 -> c - 16; nf4: NF4_LUT_I8),
// passed by the wrapper as four 32-bit words.  The GEMV reads int4 without
// the table (kInt4: each field as the high nibble of a byte, 16 x its value).
enum Decode : int { kTernary = 0, kInt8 = 1, kLut4 = 2, kInt4 = 3 };

template <int D>
struct Layout {
  static constexpr int kUnitK = D == kTernary ? 16 : (D == kInt8 ? 4 : 8);  // K elements per weight unit
};
constexpr unsigned kTernaryTable = 0xFF020100u;  // ternary code c -> int8 ((c + 1) & 3) - 1, byte c

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

// cp.async: 16 or 4 bytes global -> shared, zero-filled when !pred (src stays a valid address)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d = a.b + d on 16 x 8 x 32 int8 tiles, int32 sums
__device__ __forceinline__ void mma_k32(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// the same on 16 x 8 x 16 tiles
__device__ __forceinline__ void mma_k16(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// Four words of 4 bytes (rows) -> four words of 4 bytes (columns): c[q] byte j = r[j] byte q.
__device__ __forceinline__ void transpose4(const unsigned (&r)[4], unsigned (&c)[4]) {
  const unsigned t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[2], r[3], 0x5140);
  const unsigned t2 = __byte_perm(r[0], r[1], 0x7362), t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410), c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410), c[3] = __byte_perm(t2, t3, 0x7632);
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
