// Flash attention over a kv_bf16 cache for Hopper (sm_90a).  Replaces the
// TPU kernel repro/kernels/flash_prefill.py::flash_attend (_kernel), reached
// at S == 1 through repro/kernels/flash_decode.py::flash_decode.  The
// wrapper, the plain PyTorch version and the design notes are in
// src/repro_torch/kernels/flash_prefill.py.
//
// Split over the key axis (flash decoding), two launches:
//   partial: grid (B * Kh, S / bq, T / tk), 128 threads.  A block owns one
//            (batch row, kv head, query block) and tk keys; the G query
//            heads of the group ride as R = bq * G rows.  It loads its K
//            and V rows into shared memory with 16-byte loads all in
//            flight together (rows padded by one 32-bit word so a thread
//            per key reads without bank conflicts), masks k < valid[b],
//            k <= q_pos, q_pos - k < win with -1e30 like the reference,
//            and writes its softmax max m, sum l and unnormalized P.V.  A
//            block whose keys all lie at or past valid[b] writes
//            m = -1e30, l = 0, acc = 0 without reading the cache: its
//            weight in the combine, exp(-1e30 - M), is 0 either way.
//   combine: grid (B * Kh, S / bq); out = sum_s e^(m_s - M) acc_s /
//            max(sum_s e^(m_s - M) l_s, 1e-30).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRc = 8;  // query rows held in registers at a time
constexpr float kNegInf = -1e30f;

struct Shape {
  int S, T, Kh, G, hd, bq, tk, splits;
};

__global__ void __launch_bounds__(kThreads)
flash_partial_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_start,
                     const int* __restrict__ valid, const int* __restrict__ window,
                     float* __restrict__ part_ml, float* __restrict__ part_acc, Shape sh,
                     float scale) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x / sh.Kh, kh = blockIdx.x % sh.Kh, qi = blockIdx.y, sp = blockIdx.z;
  const int R = sh.bq * sh.G, hd = sh.hd, tk = sh.tk, ld = hd + 2;
  const int j0 = sp * tk;
  const size_t slot = (static_cast<size_t>(blockIdx.x) * gridDim.y + qi) * sh.splits + sp;
  float* ml = part_ml + slot * R * 2;     // [R][2] = (m, l)
  float* pacc = part_acc + slot * R * hd;  // [R][hd]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = q_start[b] + qi * sh.bq, vl = valid[b], win = window[0];

  if (j0 >= vl) {  // every key of this block is past the fill level
    for (int r = tid; r < R; r += kThreads) ml[2 * r] = kNegInf, ml[2 * r + 1] = 0.0f;
    for (int i = tid; i < R * hd; i += kThreads) pacc[i] = 0.0f;
    return;
  }

  float* qs = sm;                  // [R][hd] scaled queries
  float* sc = qs + R * hd;         // [R][tk] scores, then probabilities
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(sc + R * tk);  // [tk][ld]
  __nv_bfloat16* vt = kt + tk * ld;                                   // [tk][ld]

  const int chunks = hd / 8;  // 16-byte chunks per key row
#pragma unroll 8
  for (int c = tid; c < 2 * tk * chunks; c += kThreads) {
    const int which = c / (tk * chunks), jj = (c / chunks) % tk, part = c % chunks;
    const __nv_bfloat16* src = (which ? v : k) + ((static_cast<size_t>(b) * sh.T + j0 + jj) * sh.Kh + kh) * hd + part * 8;
    const uint4 val = __ldg(reinterpret_cast<const uint4*>(src));
    unsigned* dst = reinterpret_cast<unsigned*>((which ? vt : kt) + jj * ld + part * 8);
    dst[0] = val.x, dst[1] = val.y, dst[2] = val.z, dst[3] = val.w;
  }
  for (int i = tid; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const int s = qi * sh.bq + r / sh.G, g = r % sh.G;
    qs[i] = q[((static_cast<size_t>(b) * sh.S + s) * sh.Kh + kh) * sh.G * hd + g * hd + d] * scale;
  }
  __syncthreads();

  // masked scores, a thread per (row, key)
  for (int i = tid; i < R * tk; i += kThreads) {
    const int r = i / tk, jj = i % tk;
    const int kp = j0 + jj, qpos = q0 + r / sh.G;
    float s = kNegInf;
    if (kp < vl && kp <= qpos && qpos - kp < win) {
      const __nv_bfloat16* kr = kt + jj * ld;
      const float* qr = qs + r * hd;
      float acc = 0.0f;
      for (int d = 0; d < hd; d += 2) {
        const __nv_bfloat162 k2 = *reinterpret_cast<const __nv_bfloat162*>(kr + d);
        acc = fmaf(qr[d], __low2float(k2), acc);
        acc = fmaf(qr[d + 1], __high2float(k2), acc);
      }
      s = acc;
    }
    sc[i] = s;
  }
  __syncthreads();

  // softmax statistics of this block's keys, a warp per row
  for (int r = warp; r < R; r += kWarps) {
    float mx = kNegInf;
    for (int jj = lane; jj < tk; jj += 32) mx = fmaxf(mx, sc[r * tk + jj]);
#pragma unroll
    for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.0f;
    for (int jj = lane; jj < tk; jj += 32) {
      const float p = expf(sc[r * tk + jj] - mx);
      sc[r * tk + jj] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) ml[2 * r] = mx, ml[2 * r + 1] = sum;
  }
  __syncthreads();

  // unnormalized P.V, a thread per head_dim lane
  for (int d = tid; d < hd; d += kThreads) {
    for (int r0 = 0; r0 < R; r0 += kRc) {
      float pv[kRc];
#pragma unroll
      for (int rr = 0; rr < kRc; ++rr) pv[rr] = 0.0f;
#pragma unroll 8
      for (int jj = 0; jj < tk; ++jj) {
        const float vv = __bfloat162float(vt[jj * ld + d]);
#pragma unroll
        for (int rr = 0; rr < kRc; ++rr)
          if (r0 + rr < R) pv[rr] = fmaf(sc[(r0 + rr) * tk + jj], vv, pv[rr]);
      }
#pragma unroll
      for (int rr = 0; rr < kRc; ++rr)
        if (r0 + rr < R) pacc[(r0 + rr) * hd + d] = pv[rr];
    }
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

}  // namespace

extern "C" int flash_attend_bf16_launch(const void* q, const void* k, const void* v,
                                        const void* q_start, const void* valid, const void* window,
                                        void* part_ml, void* part_acc, void* o, int B, int S, int T,
                                        int Kh, int G, int hd, int bq, int tk, float scale,
                                        void* stream) {
  static bool configured = false;  // raise the dynamic shared-memory cap once
  if (!configured) {
    cudaFuncAttributes attr;  // the 227 KB a block may have, less static shared memory
    cudaError_t err = cudaFuncGetAttributes(&attr, flash_partial_kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 232448 - static_cast<int>(attr.sharedSizeBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const Shape sh{S, T, Kh, G, hd, bq, tk, T / tk};
  const int R = bq * G;
  const size_t smem = sizeof(float) * (static_cast<size_t>(R) * hd + static_cast<size_t>(R) * tk) +
                      sizeof(__nv_bfloat16) * 2 * static_cast<size_t>(tk) * (hd + 2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  flash_partial_kernel<<<dim3(B * Kh, S / bq, sh.splits), kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_start),
      static_cast<const int*>(valid), static_cast<const int*>(window),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), sh, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_combine_kernel<<<dim3(B * Kh, S / bq), kThreads, 0, s>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc), static_cast<float*>(o), sh);
  return static_cast<int>(cudaGetLastError());
}
