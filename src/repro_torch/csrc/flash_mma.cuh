// The tensor-core tile loop shared by flash_attend.cu (S > 1) and
// flash_attention.cu, for Hopper (sm_90a): PTX wrappers (cp.async,
// ldmatrix, mma.sync m16n8k16 bf16 with float32 sums), the split of a
// float32 into bf16 terms, and one warp's step over one key tile.
//
// The split.  A bf16 term holds 8 significant bits, a float32 24: x is
// taken as hi + mid + lo, each term the round-to-nearest of what the
// earlier ones left, and the three hold x exactly (unless the last
// underflows).  Every product of two bf16 terms is exact in float32, so a
// product of split operands differs from the float32 one only in the order
// of its sums and in the terms left out.  `tile_step` takes NA terms of the
// A operand and NB of the B operand and issues the term pairs (i, j) with
// i + j < max(NA, NB): for an exact bf16 B (a dequantized cache tile, a bf16
// input) that is every term of A; for two float32 operands in three terms
// each it is the six pairs down to 2^-16 of the leading product (the
// dropped ones are below 2^-24).  Both kernels pass q * scale and p in
// three terms: with p in two (2^-17 of p) flash_attention's bf16 output at
// hd 128, T = 1024 came out 5 bf16 ulps from the plain version's on
// near-zero elements (PERF.md).  tests/test_torch_flash_split.py emulates
// this arithmetic on the CPU.
//
// The sums.  The tensor cores add in float32 but truncate, so a long chain
// of mma into one accumulator drifts: the scores keep the hi-term products
// apart from the mid and lo ones (2^-8 of them and less) and add the two
// once, and each key tile's P.V is summed in a fresh accumulator and added
// to the output in float32.  That kept every error 3-8x under the plain
// versions' tolerances where one chain did not (PERF.md).
//
// One warp owns 16 query rows.  Per key tile of BK keys it computes the
// 16 x BK scores S = Q.K^T in mma C fragments, masks them with -1e30, folds
// them into its running (m, l) with the online softmax (max and sum across
// the quad of lanes that share a row, by __shfl_xor_sync), splits
// p = e^(s - m') in registers -- the C fragments of two n8 score tiles are
// the A fragment of one k16 step of P.V, so P never leaves the registers --
// and accumulates P.V into the float32 C fragments of its 16 x HD output.
// Q, K and V come from shared memory through ldmatrix (V transposed), as
// bf16 planes of [rows][HD + 8] (the 16-byte pad keeps the eight rows of an
// ldmatrix on distinct banks).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace flash {

constexpr float kNegInf = -1e30f;
constexpr int kWarpRows = 16;  // query rows of one warp (the mma M)

template <int HD>
struct Ld {
  static constexpr int value = HD + 8;  // bf16 elements per plane row
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !pred (src
// must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(n)
               : "memory");
}
// the same for 8 bytes (kv_mx rows of hd 240 are 120 bytes: 8-byte aligned only)
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool pred) {
  const int n = pred ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a.b on a 16 x 8 x 16 tile, bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

// N bf16 terms of x0 and x1, packed as bf16x2 (x0 in the low half).
template <int N>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t (&t)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    t[i] = as_u32(h);
    x0 = x0 - __low2float(h);
    x1 = x1 - __high2float(h);
  }
}

// N bf16 planes of 8 float32 values: plane i at dst + i * plane, 16 bytes each.
template <int N>
__device__ __forceinline__ void store_split8(__nv_bfloat16* dst, size_t plane, const float (&x)[8]) {
  uint32_t w[4][N];
#pragma unroll
  for (int j = 0; j < 4; ++j) split2<N>(x[2 * j], x[2 * j + 1], w[j]);
#pragma unroll
  for (int i = 0; i < N; ++i)
    *reinterpret_cast<uint4*>(dst + i * plane) = make_uint4(w[0][i], w[1][i], w[2][i], w[3][i]);
}

// 2**e for an integer e clamped to [-126, 127], from the exponent bits (as
// repro_torch/core/dfp.py::exp2i).
__device__ __forceinline__ float exp2i(int e) {
  e = min(max(e, -126), 127);
  return __int_as_float((e + 127) << 23);
}

// The running softmax of one warp's 16 rows: lane holds rows g = lane / 4
// (h = 0) and g + 8 (h = 1), output columns 8 j + 2 (lane % 4) + {0, 1}.
template <int HD>
struct RowState {
  float o[HD / 8][4];
  float m[2], l[2];  // l: this lane's share of the row sum (summed over the quad at the end)

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.0f;
  }

  // out(h, col, a / L, b / L) for columns col, col + 1 of row g + 8 h, with
  // L = max(l, 1e-30) as the plain versions divide.
  template <class Out>
  __device__ __forceinline__ void finish(Out out) {
    const int t4 = threadIdx.x & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l_row = l[h];
      l_row += __shfl_xor_sync(0xffffffffu, l_row, 1);
      l_row += __shfl_xor_sync(0xffffffffu, l_row, 2);
      const float den = fmaxf(l_row, 1e-30f);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) out(h, 8 * j + 2 * t4, o[j][2 * h] / den, o[j][2 * h + 1] / den);
    }
  }
};

// One warp, one key tile.  qp: the warp's first row of NQ Q planes (plane
// stride qplane elements); kp, vp: the tile's first key of NK K planes and
// NV V planes (plane stride kvplane); live(h, j): key j of the tile is live
// for row g + 8 h.  NP: bf16 terms of p.
template <int HD, int BK, int NQ, int NK, int NP, int NV, class Live>
__device__ __forceinline__ void tile_step(RowState<HD>& st, const __nv_bfloat16* qp, int qplane,
                                          const __nv_bfloat16* kp, const __nv_bfloat16* vp, int kvplane,
                                          Live live) {
  constexpr int kLd = Ld<HD>::value;
  constexpr int kQK = NQ > NK ? NQ : NK;
  constexpr int kPV = NP > NV ? NP : NV;
  const int lane = threadIdx.x & 31, t4 = lane & 3;
  // ldmatrix addresses: lane feeds row (lane & 7) of matrix lane / 8
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;  // A: rows, then k
  const int b_key = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;  // K: n8 pair, k halves
  const int v_key = (lane & 7) + ((lane >> 3) & 1) * 8, v_col = (lane >> 4) * 8;  // V^T: k halves, n8 pair

  // scores: the hi term of q into s, the mid and lo terms (2^-8 of it and
  // less) into s2, added once in float32 -- the tensor cores truncate their
  // sums, and a small accumulator keeps that far below an ulp of s
  float s[BK / 8][4], s2[BK / 8][4];
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = s2[n][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[NQ][4];
#pragma unroll
    for (int i = 0; i < NQ; ++i) ldsm_x4(a[i], qp + i * qplane + a_row * kLd + kk * 16 + a_col);
#pragma unroll
    for (int n = 0; n < BK / 8; n += 2) {
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        uint32_t b[4];
        ldsm_x4(b, kp + j * kvplane + (n * 8 + b_key) * kLd + kk * 16 + b_col);
#pragma unroll
        for (int i = 0; i < NQ; ++i)
          if (i + j == 0) {
            mma_bf16(s[n], a[i], b[0], b[1]);
            mma_bf16(s[n + 1], a[i], b[2], b[3]);
          } else if (i + j < kQK) {
            mma_bf16(s2[n], a[i], b[0], b[1]);
            mma_bf16(s2[n + 1], a[i], b[2], b[3]);
          }
      }
    }
  }
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] += s2[n][e];

  // mask, then the online-softmax update of rows g and g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kNegInf;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (!live(h, n * 8 + 2 * t4 + c)) s[n][2 * h + c] = kNegInf;
        mx = fmaxf(mx, s[n][2 * h + c]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(st.m[h], mx);
    const float corr = __expf(st.m[h] - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = __expf(s[n][2 * h + c] - m_new);
        s[n][2 * h + c] = p;
        sum += p;
      }
    st.l[h] = st.l[h] * corr + sum;
    st.m[h] = m_new;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      st.o[j][2 * h] *= corr;
      st.o[j][2 * h + 1] *= corr;
    }
  }

  // O += P.V: p split in registers (the C fragments of score tiles 2 kk and
  // 2 kk + 1 are the A fragment of key step kk); each pair of n8 output
  // tiles sums the tile's keys in a fresh accumulator, added to O in float32
  // (so the tensor cores' truncation does not pile up over the key tiles)
  uint32_t pa[BK / 16][NP][4];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t t0[NP], t1[NP], t2[NP], t3[NP];
    split2<NP>(s[2 * kk][0], s[2 * kk][1], t0);          // row g, keys 2 t4 + {0, 1}
    split2<NP>(s[2 * kk][2], s[2 * kk][3], t1);          // row g + 8
    split2<NP>(s[2 * kk + 1][0], s[2 * kk + 1][1], t2);  // row g, keys 8 + 2 t4 + {0, 1}
    split2<NP>(s[2 * kk + 1][2], s[2 * kk + 1][3], t3);  // row g + 8
#pragma unroll
    for (int i = 0; i < NP; ++i) pa[kk][i][0] = t0[i], pa[kk][i][1] = t1[i], pa[kk][i][2] = t2[i], pa[kk][i][3] = t3[i];
  }
#pragma unroll
  for (int n = 0; n < HD / 8; n += 2) {
    float u[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        uint32_t b[4];
        ldsm_x4_trans(b, vp + j * kvplane + (kk * 16 + v_key) * kLd + n * 8 + v_col);
#pragma unroll
        for (int i = 0; i < NP; ++i)
          if (i + j < kPV) {
            mma_bf16(u[0], pa[kk][i], b[0], b[1]);
            mma_bf16(u[1], pa[kk][i], b[2], b[3]);
          }
      }
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[n][e] += u[0][e], st.o[n + 1][e] += u[1][e];
  }
}

}  // namespace flash
