// Standalone flash attention over (BH, S, hd) queries and (BH, T, hd) keys
// and values, float32 or bf16, for Hopper (sm_90a).  Replaces the TPU kernel
// repro/kernels/flash_attention.py::flash_attention (_kernel).  The wrapper,
// the plain PyTorch version and the design notes are in
// src/repro_torch/kernels/flash_attention.py.
//
// Grid (BH, ceil(S / kBq)), 128 threads.  A block owns kBq = 32 query rows
// of one (batch, head); thread t holds rows 4 * (t / 16) .. + 3 and, per key
// tile, the keys (t % 16) + 16 c (c < 4) of its scores, then the head_dim
// lanes (t % 16) + 16 j of its accumulator -- scores, running (m, l) and the
// (4 rows x hd / 16) accumulator live in registers.  Per key tile of kBk = 64
// keys the block widens K and V to float32 in shared memory (16-byte loads),
// masks k <= q (causal, both counted from 0: top-left aligned) with -1e30 like
// the reference, and folds the tile in:
//   m' = max(m, max_j s), p = e^(s - m'), c = e^(m - m'),
//   l' = l c + sum_j p,   acc' = acc c + p.V,
// then writes acc / max(l, 1e-30) in the input's type.  Causal key tiles that
// lie wholly above the block's last row are skipped: tile 0 always holds key 0,
// live for every row, so m is finite after it and a fully masked tile would add
// e^(-1e30 - m) = 0 with a correction of 1.  Keys past T (a ragged last tile)
// mask the same way, with zeroed K and V rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBq = 32;    // query rows per block
constexpr int kBk = 64;    // keys per tile
constexpr int kRows = 4;   // query rows per thread
constexpr int kLanes = 16; // threads sharing a row group (a half warp)
constexpr int kKeys = kBk / kLanes;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16_rn(x); }

// Rows [r0, r0 + n) of a (rows, HD) slab into dst[n][HD + 1] as float32 times
// `scale` (1 for K and V: exact); rows past `rows` are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0, int n, int rows, float scale) {
  constexpr int kPer = 16 / sizeof(T);  // values per 16-byte load
  constexpr int kChunks = HD / kPer;
  constexpr int kLd = HD + 1;
  for (int c = threadIdx.x; c < n * kChunks; c += kThreads) {
    const int rr = c / kChunks, part = c % kChunks, r = r0 + rr;
    float* o = dst + rr * kLd + part * kPer;
    if (r >= rows) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) o[i] = 0.0f;
      continue;
    }
    const uint4 val = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * HD) + part);
    const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
    for (int i = 0; i < kPer; ++i) o[i] = widen(e[i]) * scale;
  }
}

// Sum or max over the 16 lanes of a row group; every lane gets the same bits
// (each butterfly step adds or compares the same two operands on both lanes).
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = kLanes / 2; off; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = kLanes / 2; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBq + 2 * kBk) * (HD + 1) + kBq * (kBk + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
                       int S, int Tk, int causal, float scale) {
  constexpr int kLd = HD + 1;
  constexpr int kDims = HD / kLanes;  // accumulator lanes per thread
  constexpr int kPld = kBk + 1;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;               // [kBq][kLd] scaled queries
  float* kt = qs + kBq * kLd;   // [kBk][kLd] keys of the tile
  float* vt = kt + kBk * kLd;   // [kBk][kLd] values of the tile
  float* ps = vt + kBk * kLd;   // [kBq][kPld] probabilities of the tile

  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kBq;
  const int lane = threadIdx.x % kLanes, r0 = (threadIdx.x / kLanes) * kRows;
  const T* kb = k + bh * Tk * HD;
  const T* vb = v + bh * Tk * HD;
  load_rows<T, HD>(qs, q + bh * S * HD, q0, kBq, S, scale);

  float m[kRows], l[kRows], acc[kRows][kDims];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf, l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < kDims; ++j) acc[r][j] = 0.0f;
  }

  const int k_end = causal ? min(Tk, q0 + kBq) : Tk;  // causal: later tiles mask every row
  for (int j0 = 0; j0 < k_end; j0 += kBk) {
    __syncthreads();  // the previous tile is done with kt, vt and ps
    load_rows<T, HD>(kt, kb, j0, kBk, Tk, 1.0f);
    load_rows<T, HD>(vt, vb, j0, kBk, Tk, 1.0f);
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kKeys; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qv[r] = qs[(r0 + r) * kLd + d];
#pragma unroll
      for (int c = 0; c < kKeys; ++c) kv[c] = kt[(lane + kLanes * c) * kLd + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kKeys; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + r0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const int kp = j0 + lane + kLanes * c;
        if (kp >= Tk || (causal && kp > qp)) s[r][c] = kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], group_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const float p = expf(s[r][c] - m_new);
        ps[(r0 + r) * kPld + lane + kLanes * c] = p;
        sum += p;
      }
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + group_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < kDims; ++j) acc[r][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int jj = 0; jj < kBk; ++jj) {
      float pv[kRows], vv[kDims];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pv[r] = ps[(r0 + r) * kPld + jj];
#pragma unroll
      for (int j = 0; j < kDims; ++j) vv[j] = vt[jj * kLd + lane + kLanes * j];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < kDims; ++j) acc[r][j] = fmaf(pv[r], vv[j], acc[r][j]);
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + r0 + r;
    if (row >= S) continue;
    T* out = o + (bh * S + row) * HD;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDims; ++j) narrow(out + lane + kLanes * j, acc[r][j] / den);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH, int S, int Tk, int causal,
                   float scale, cudaStream_t stream) {
  static bool configured = false;  // raise the dynamic shared-memory cap once
  constexpr size_t smem = smem_bytes<HD>();
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  flash_attention_kernel<T, HD><<<dim3(BH, (S + kBq - 1) / kBq), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), S, Tk,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v, void* o, int BH, int S, int Tk,
                      int causal, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, BH, S, Tk, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, BH, S, Tk, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, BH, S, Tk, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, BH, S, Tk, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype 0: float32, 1: bf16 (q, k, v and o alike).
extern "C" int flash_attention_launch(int dtype, int hd, const void* q, const void* k, const void* v, void* o,
                                      int BH, int S, int T, int causal, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_hd<float>(hd, q, k, v, o, BH, S, T, causal, scale, s);
  else if (dtype == 1)
    err = launch_hd<__nv_bfloat16>(hd, q, k, v, o, BH, S, T, causal, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
