// Standalone flash attention over (BH, S, hd) queries and (BH, T, hd) keys
// and values, float32 or bf16, for Hopper (sm_90a).  Replaces the TPU kernel
// repro/kernels/flash_attention.py::flash_attention (_kernel).  The wrapper,
// the plain PyTorch version and the design notes are in
// src/repro_torch/kernels/flash_attention.py; the tile loop and the split
// arithmetic in flash_mma.cuh.
//
// Grid (BH, ceil(S / kRows)).  A block of kWarps warps owns kRows = 16 kWarps
// query rows of one (batch, head), each warp 16 of them.  q * scale (float32,
// as the plain version scales before the dot) goes into shared memory as
// three bf16 planes (hi + mid + lo: exact).  Key tiles of BK keys are
// double-buffered: cp.async brings tile i + 1 while the warps work on tile i.
//   bf16: K and V are exact bf16 and are copied straight into the planes the
//         tensor cores read; 8 warps (128 rows) over 64-key tiles.
//   float32: K and V are not exact in bf16; each tile lands as float32 and is
//         split into three planes (all term pairs down to 2^-16 of the
//         leading product); 4 warps over 32-key tiles, for room.
// At hd 240 (gemma3) those tiles would take 317,440 (bf16) and 313,344
// (float32) bytes of shared memory, over the 232,448 a block may have: bf16
// runs 4 warps over 64-key tiles (222,208 bytes), float32 4 warps over
// 16-key tiles (204,288).
// p goes in as three bf16 terms.
// Scores and the accumulator live in mma fragments; keys k <= q (causal, both
// counted from 0: top-left aligned) and k < T are live, others -1e30 as in
// the reference; the output is acc / max(l, 1e-30) in the input's type.
// Causal key tiles wholly above a warp's last row are skipped: tile 0 always
// holds key 0, live for every row, so m is finite after it and such a tile
// would add e^(-1e30 - m) = 0 with a correction of 1.  Keys past T (a ragged
// last tile) are zero-filled and masked.
#include "flash_mma.cuh"

namespace {

using flash::Ld;
using flash::RowState;
using flash::kWarpRows;

template <typename T, int HD, int WARPS, int BK>
struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kThreads = 32 * WARPS, kRows = kWarpRows * WARPS, kLd = Ld<HD>::value;
  static constexpr int kNkv = kF32 ? 3 : 1;  // bf16 planes of K and of V
  static constexpr int kQPlane = kRows * kLd, kKvPlane = BK * kLd;
  // shared memory, in bf16 elements: Q planes, then
  //   bf16:    [2 stages][K, V][BK][kLd] (the cp.async targets)
  //   float32: [3 K planes][3 V planes], then float32 [2 stages][K, V][BK][HD]
  static constexpr size_t kQElems = 3 * static_cast<size_t>(kQPlane);
  static constexpr size_t kKvElems = (kF32 ? 6 : 4) * static_cast<size_t>(kKvPlane);
  static constexpr size_t kRawBytes = kF32 ? 2 * 2 * static_cast<size_t>(BK) * HD * 4 : 0;
  static constexpr size_t kSmem = 2 * (kQElems + kKvElems) + kRawBytes;
};

template <typename T>
__device__ __forceinline__ void load8(float (&x)[8], const T* p);
template <>
__device__ __forceinline__ void load8<float>(float (&x)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(float (&x)[8], const __nv_bfloat16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) x[2 * i] = __low2float(h[i]), x[2 * i + 1] = __high2float(h[i]);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int HD, int WARPS, int BK>
__global__ void __launch_bounds__(Cfg<T, HD, WARPS, BK>::kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
                       int S, int Tk, int causal, float scale) {
  using C = Cfg<T, HD, WARPS, BK>;
  constexpr int kLd = C::kLd, kChunks = HD * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kvs = qs + C::kQElems;  // bf16: stages; float32: the six split planes
  float* raw = reinterpret_cast<float*>(kvs + C::kKvElems);

  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * C::kRows, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* kb = k + bh * Tk * HD;
  const T* vb = v + bh * Tk * HD;
  const int k_end = causal ? min(Tk, q0 + C::kRows) : Tk;  // causal: later keys mask every row
  const int n_tiles = (k_end + BK - 1) / BK;

  // tile `tile` of K and V -> stage `st` (keys past T zero-filled)
  auto issue = [&](int tile, int st) {
    const int j0 = tile * BK;
    for (int c = tid; c < 2 * BK * kChunks; c += C::kThreads) {
      const int which = c / (BK * kChunks), jj = (c / kChunks) % BK, part = c % kChunks, j = j0 + jj;
      const T* src = (which ? vb : kb) + static_cast<size_t>(min(j, Tk - 1)) * HD + part * (16 / sizeof(T));
      void* dst;
      if constexpr (C::kF32)
        dst = raw + ((st * 2 + which) * BK + jj) * HD + part * 4;
      else
        dst = kvs + ((st * 2 + which) * BK + jj) * kLd + part * 8;
      flash::cp_async16(dst, src, j < Tk);
    }
  };
  if (n_tiles > 0) issue(0, 0);
  flash::cp_async_commit();

  // q * scale -> three bf16 planes; rows past S are zero
  for (int c = tid; c < C::kRows * (HD / 8); c += C::kThreads) {
    const int r = c / (HD / 8), d = (c % (HD / 8)) * 8;
    float x[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (q0 + r < S) {
      load8(x, q + (bh * S + q0 + r) * HD + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = x[i] * scale;
    }
    flash::store_split8<3>(qs + r * kLd + d, C::kQPlane, x);
  }

  const int w0 = q0 + warp * kWarpRows;  // the warp's first row
  const int g = lane >> 2;
  const int w_end = causal ? min(k_end, w0 + kWarpRows) : k_end;  // the warp's live keys end here
  RowState<HD> st;
  st.init();
  for (int it = 0; it < n_tiles; ++it) {
    __syncthreads();  // every warp is done with the stage (and planes) about to be refilled
    if (it + 1 < n_tiles) issue(it + 1, (it + 1) & 1);
    flash::cp_async_commit();
    flash::cp_async_wait<1>();
    __syncthreads();  // tile `it` has landed for every thread
    const __nv_bfloat16* kp;
    const __nv_bfloat16* vp;
    if constexpr (C::kF32) {  // float32 tile -> three bf16 planes each of K and V
      const float* src = raw + (it & 1) * 2 * BK * HD;
      for (int c = tid; c < 2 * BK * (HD / 8); c += C::kThreads) {
        const int which = c / (BK * (HD / 8)), jj = (c / (HD / 8)) % BK, d = (c % (HD / 8)) * 8;
        float x[8];
        load8(x, src + (which * BK + jj) * HD + d);
        flash::store_split8<3>(kvs + which * 3 * C::kKvPlane + jj * kLd + d, C::kKvPlane, x);
      }
      __syncthreads();
      kp = kvs;
      vp = kvs + 3 * C::kKvPlane;
    } else {
      kp = kvs + (it & 1) * 2 * C::kKvPlane;
      vp = kp + C::kKvPlane;
    }
    const int j0 = it * BK;
    if (w0 < S && j0 < w_end) {  // warp-uniform
      auto live = [&](int h, int jj) {
        const int key = j0 + jj;
        return key < Tk && (!causal || key <= w0 + g + 8 * h);
      };
      flash::tile_step<HD, BK, 3, C::kNkv, 3, C::kNkv>(st, qs + warp * kWarpRows * kLd, C::kQPlane, kp, vp,
                                                           C::kKvPlane, live);
    }
  }
  flash::cp_async_wait<0>();

  if (w0 < S) {
    T* ob = o + bh * S * HD;
    st.finish([&](int h, int col, float a, float b) {
      const int row = w0 + g + 8 * h;
      if (row < S) store2(ob + static_cast<size_t>(row) * HD + col, a, b);
    });
  }
}

template <typename T, int HD, int WARPS, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH, int S, int Tk, int causal,
                   float scale, cudaStream_t stream) {
  using C = Cfg<T, HD, WARPS, BK>;
  static_assert(C::kSmem <= 232448, "shared memory over the 227 KB a block may have");
  static bool configured = false;  // raise the dynamic shared-memory cap once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD, WARPS, BK>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(C::kSmem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  flash_attention_kernel<T, HD, WARPS, BK><<<dim3(BH, (S + C::kRows - 1) / C::kRows), C::kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), S, Tk,
      causal, scale);
  return cudaGetLastError();
}

// bf16: 8 warps (128 rows) a block over 64-key tiles; float32 (three K and V
// planes and a float32 staging tile): 4 warps over 32-key tiles; hd 240:
// 4 warps, over 64-key (bf16) or 16-key (float32) tiles.
template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v, void* o, int BH, int S, int Tk,
                      int causal, float scale, cudaStream_t stream) {
  constexpr bool f32 = sizeof(T) == 4;
  constexpr int W = f32 ? 4 : 8, BK = f32 ? 32 : 64;
  switch (hd) {
    case 16: return launch<T, 16, W, BK>(q, k, v, o, BH, S, Tk, causal, scale, stream);
    case 32: return launch<T, 32, W, BK>(q, k, v, o, BH, S, Tk, causal, scale, stream);
    case 64: return launch<T, 64, W, BK>(q, k, v, o, BH, S, Tk, causal, scale, stream);
    case 128: return launch<T, 128, W, BK>(q, k, v, o, BH, S, Tk, causal, scale, stream);
    case 240: return launch<T, 240, 4, f32 ? 16 : 64>(q, k, v, o, BH, S, Tk, causal, scale, stream);
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

