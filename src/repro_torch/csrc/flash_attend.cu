// Flash attention over a packed KV cache (kv_bf16, kv_int8, kv_mx) for
// Hopper (sm_90a).  Replaces the TPU kernel
// repro/kernels/flash_prefill.py::flash_attend (_kernel, _dequant_tile),
// reached at S == 1 through repro/kernels/flash_decode.py::flash_decode.
// The wrapper, the plain PyTorch version and the design notes are in
// src/repro_torch/kernels/flash_prefill.py.
//
// One kernel, grid (B * Kh, S / bq, splits), 128 threads.  A block owns one
// (batch row, kv head, query block); the G query heads of the group ride as
// R = bq * G rows.  Per key tile of tk keys it loads the K and V rows with
// 16-byte loads and dequantizes them into float32 shared memory (kv_bf16:
// cast; kv_int8: q * 2**e per (token, head); kv_mx: sign-extended nibbles,
// low nibble = even channel, times 2**e per 32-token block -- all exact),
// masks k < valid[b], k <= q_pos, q_pos - k < win with -1e30 like the
// reference, and folds the tile into a running (m, l, acc) in shared memory:
//   m' = max(m, max_j s), p = e^(s - m'), c = e^(m - m'),
//   l' = l c + sum_j p,   acc' = acc c + p.V.
// Tiles that hold no live key for any row of the block are skipped (they
// would add exact zeros).
//   splits == 1 (prefill chunks, S > 1): the block walks every key tile and
//            writes acc / max(l, 1e-30).
//   splits  > 1 (decode, S == 1; flash decoding): block z takes key tile z
//            only and writes its (m, l, acc); a second launch combines:
//            out = sum_z e^(m_z - M) acc_z / max(sum_z e^(m_z - M) l_z, 1e-30).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRc = 8;  // query rows held in registers at a time
constexpr int kMxBlock = 32;
constexpr float kNegInf = -1e30f;
enum Fmt { kBf16 = 0, kInt8 = 1, kMx = 2 };

struct Shape {
  int S, T, Kh, G, hd, bq, tk, splits;
};

// 2**e for an integer e clamped to [-126, 127], from the exponent bits (as
// repro_torch/core/dfp.py::exp2i).
__device__ __forceinline__ float exp2i(int e) {
  e = min(max(e, -126), 127);
  return __int_as_float((e + 127) << 23);
}

// Keys [j0, j0 + tk) of (b, kh) dequantized into dst[tk][hd + 1] float32.
template <int FMT>
__device__ __forceinline__ void load_tile(float* dst, const void* src, const int8_t* ex, int b, int kh,
                                          int j0, const Shape& sh) {
  constexpr int kPer = FMT == kBf16 ? 8 : (FMT == kInt8 ? 16 : 32);  // values per 16 bytes
  const int hd = sh.hd, ld = hd + 1, chunks = hd / kPer;
  const size_t row_bytes = FMT == kBf16 ? 2 * hd : (FMT == kInt8 ? hd : hd / 2);
  const char* base = static_cast<const char*>(src);
  for (int c = threadIdx.x; c < sh.tk * chunks; c += kThreads) {
    const int jj = c / chunks, part = c % chunks, j = j0 + jj;
    const size_t row = (static_cast<size_t>(b) * sh.T + j) * sh.Kh + kh;
    const uint4 val = __ldg(reinterpret_cast<const uint4*>(base + row * row_bytes) + part);
    float* o = dst + jj * ld + part * kPer;
    if constexpr (FMT == kBf16) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&val);
#pragma unroll
      for (int i = 0; i < 4; ++i) o[2 * i] = __low2float(h[i]), o[2 * i + 1] = __high2float(h[i]);
    } else if constexpr (FMT == kInt8) {
      const float s = exp2i(ex[row]);
      const int8_t* q = reinterpret_cast<const int8_t*>(&val);
#pragma unroll
      for (int i = 0; i < 16; ++i) o[i] = static_cast<float>(q[i]) * s;
    } else {
      const size_t erow = (static_cast<size_t>(b) * (sh.T / kMxBlock) + j / kMxBlock) * sh.Kh + kh;
      const float s = exp2i(ex[erow]);
      const uint8_t* q = reinterpret_cast<const uint8_t*>(&val);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int lo = q[i] & 0xF, hi = q[i] >> 4;
        o[2 * i] = static_cast<float>(lo >= 8 ? lo - 16 : lo) * s;
        o[2 * i + 1] = static_cast<float>(hi >= 8 ? hi - 16 : hi) * s;
      }
    }
  }
}

template <int FMT>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const void* __restrict__ k, const void* __restrict__ v,
             const int8_t* __restrict__ ke, const int8_t* __restrict__ ve, const int* __restrict__ q_start,
             const int* __restrict__ valid, const int* __restrict__ window, float* __restrict__ part_ml,
             float* __restrict__ part_acc, float* __restrict__ o, Shape sh, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x / sh.Kh, kh = blockIdx.x % sh.Kh, qi = blockIdx.y, sp = blockIdx.z;
  const int R = sh.bq * sh.G, hd = sh.hd, tk = sh.tk, ld = hd + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = q_start[b] + qi * sh.bq, vl = valid[b], win = window[0];

  float* qs = sm;              // [R][hd] scaled queries
  float* acc = qs + R * hd;    // [R][hd] running unnormalized P.V
  float* sc = acc + R * hd;    // [R][tk] scores, then probabilities
  float* mrow = sc + R * tk;   // [R] running max
  float* lrow = mrow + R;      // [R] running sum
  float* crow = lrow + R;      // [R] this tile's correction e^(m - m')
  float* kt = crow + R;        // [tk][ld] dequantized keys
  float* vt = kt + tk * ld;    // [tk][ld] dequantized values

  for (int i = tid; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const int s = qi * sh.bq + r / sh.G, g = r % sh.G;
    qs[i] = q[((static_cast<size_t>(b) * sh.S + s) * sh.Kh + kh) * sh.G * hd + g * hd + d] * scale;
    acc[i] = 0.0f;
  }
  for (int r = tid; r < R; r += kThreads) mrow[r] = kNegInf, lrow[r] = 0.0f;

  // live keys of the block lie in [k_lo, k_hi): past the fill level, after
  // the last query, or outside the first query's window every row masks
  const int k_hi = min(vl, q0 + sh.bq);
  const int k_lo = q0 - win + 1;
  const int t_begin = sh.splits > 1 ? sp : 0, t_end = sh.splits > 1 ? sp + 1 : sh.T / tk;
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int j0 = tile * tk;
    if (j0 >= k_hi || j0 + tk <= k_lo) continue;  // uniform over the block
    __syncthreads();  // the previous tile is done with kt, vt and sc
    load_tile<FMT>(kt, k, ke, b, kh, j0, sh);
    load_tile<FMT>(vt, v, ve, b, kh, j0, sh);
    __syncthreads();

    // masked scores, a thread per (row, key)
    for (int i = tid; i < R * tk; i += kThreads) {
      const int r = i / tk, jj = i % tk;
      const int kp = j0 + jj, qpos = q0 + r / sh.G;
      float s = kNegInf;
      if (kp < vl && kp <= qpos && qpos - kp < win) {
        const float* kr = kt + jj * ld;
        const float* qr = qs + r * hd;
        float a = 0.0f;
        for (int d = 0; d < hd; ++d) a = fmaf(qr[d], kr[d], a);
        s = a;
      }
      sc[i] = s;
    }
    __syncthreads();

    // online-softmax update, a warp per row
    for (int r = warp; r < R; r += kWarps) {
      float mx = kNegInf;
      for (int jj = lane; jj < tk; jj += 32) mx = fmaxf(mx, sc[r * tk + jj]);
#pragma unroll
      for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = mrow[r], m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int jj = lane; jj < tk; jj += 32) {
        const float p = expf(sc[r * tk + jj] - m_new);
        sc[r * tk + jj] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        crow[r] = corr;
        lrow[r] = lrow[r] * corr + sum;
        mrow[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P.V, a thread per head_dim lane
    for (int d = tid; d < hd; d += kThreads) {
      for (int r0 = 0; r0 < R; r0 += kRc) {
        float pv[kRc];
#pragma unroll
        for (int rr = 0; rr < kRc; ++rr) pv[rr] = 0.0f;
#pragma unroll 8
        for (int jj = 0; jj < tk; ++jj) {
          const float vv = vt[jj * ld + d];
#pragma unroll
          for (int rr = 0; rr < kRc; ++rr)
            if (r0 + rr < R) pv[rr] = fmaf(sc[(r0 + rr) * tk + jj], vv, pv[rr]);
        }
#pragma unroll
        for (int rr = 0; rr < kRc; ++rr)
          if (r0 + rr < R) {
            float* a = acc + (r0 + rr) * hd + d;
            *a = *a * crow[r0 + rr] + pv[rr];
          }
      }
    }
  }
  __syncthreads();

  if (sh.splits > 1) {  // this key run's (m, l, acc) for the combine
    const size_t slot = (static_cast<size_t>(blockIdx.x) * gridDim.y + qi) * sh.splits + sp;
    float* ml = part_ml + slot * R * 2;
    float* pacc = part_acc + slot * R * hd;
    for (int r = tid; r < R; r += kThreads) ml[2 * r] = mrow[r], ml[2 * r + 1] = lrow[r];
    for (int i = tid; i < R * hd; i += kThreads) pacc[i] = acc[i];
    return;
  }
  for (int i = tid; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const int s = qi * sh.bq + r / sh.G, g = r % sh.G;
    o[((static_cast<size_t>(b) * sh.S + s) * sh.Kh + kh) * sh.G * hd + g * hd + d] = acc[i] / fmaxf(lrow[r], 1e-30f);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_combine_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                     float* __restrict__ o, Shape sh) {
  const int b = blockIdx.x / sh.Kh, kh = blockIdx.x % sh.Kh, qi = blockIdx.y;
  const int R = sh.bq * sh.G, hd = sh.hd;
  const size_t slot0 = (static_cast<size_t>(blockIdx.x) * gridDim.y + qi) * sh.splits;
  for (int i = threadIdx.x; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    float mx = kNegInf;
#pragma unroll 8
    for (int sp = 0; sp < sh.splits; ++sp) mx = fmaxf(mx, part_ml[((slot0 + sp) * R + r) * 2]);
    float l = 0.0f, a = 0.0f;
#pragma unroll 8
    for (int sp = 0; sp < sh.splits; ++sp) {
      const float w = expf(part_ml[((slot0 + sp) * R + r) * 2] - mx);
      l = fmaf(part_ml[((slot0 + sp) * R + r) * 2 + 1], w, l);
      a = fmaf(part_acc[((slot0 + sp) * R + r) * hd + d], w, a);
    }
    const int s = qi * sh.bq + r / sh.G, g = r % sh.G;
    o[((static_cast<size_t>(b) * sh.S + s) * sh.Kh + kh) * sh.G * hd + g * hd + d] = a / fmaxf(l, 1e-30f);
  }
}

template <int FMT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ke, const void* ve,
                   const void* q_start, const void* valid, const void* window, void* part_ml, void* part_acc,
                   void* o, int B, const Shape& sh, float scale, cudaStream_t stream) {
  static bool configured = false;  // raise the dynamic shared-memory cap once
  if (!configured) {
    cudaFuncAttributes attr;  // the 227 KB a block may have, less static shared memory
    cudaError_t err = cudaFuncGetAttributes(&attr, flash_kernel<FMT>);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_kernel<FMT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 232448 - static_cast<int>(attr.sharedSizeBytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const size_t R = static_cast<size_t>(sh.bq) * sh.G;
  const size_t smem = sizeof(float) * (2 * R * sh.hd + R * sh.tk + 3 * R + 2 * static_cast<size_t>(sh.tk) * (sh.hd + 1));
  flash_kernel<FMT><<<dim3(B * sh.Kh, sh.S / sh.bq, sh.splits), kThreads, smem, stream>>>(
      static_cast<const float*>(q), k, v, static_cast<const int8_t*>(ke), static_cast<const int8_t*>(ve),
      static_cast<const int*>(q_start), static_cast<const int*>(valid), static_cast<const int*>(window),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), static_cast<float*>(o), sh, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || sh.splits == 1) return err;
  flash_combine_kernel<<<dim3(B * sh.Kh, sh.S / sh.bq), kThreads, 0, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc), static_cast<float*>(o), sh);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attend_launch(int fmt, const void* q, const void* k, const void* v, const void* ke,
                                   const void* ve, const void* q_start, const void* valid, const void* window,
                                   void* part_ml, void* part_acc, void* o, int B, int S, int T, int Kh, int G,
                                   int hd, int bq, int tk, int splits, float scale, void* stream) {
  const Shape sh{S, T, Kh, G, hd, bq, tk, splits};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (fmt == kBf16)
    err = launch<kBf16>(q, k, v, ke, ve, q_start, valid, window, part_ml, part_acc, o, B, sh, scale, s);
  else if (fmt == kInt8)
    err = launch<kInt8>(q, k, v, ke, ve, q_start, valid, window, part_ml, part_acc, o, B, sh, scale, s);
  else if (fmt == kMx)
    err = launch<kMx>(q, k, v, ke, ve, q_start, valid, window, part_ml, part_acc, o, B, sh, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
