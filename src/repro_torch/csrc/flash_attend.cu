// Flash attention over a packed KV cache (kv_bf16, kv_int8, kv_mx) for
// Hopper (sm_90a).  Replaces the TPU kernel
// repro/kernels/flash_prefill.py::flash_attend (_kernel, _dequant_tile),
// reached at S == 1 through repro/kernels/flash_decode.py::flash_decode.
// The wrapper, the plain PyTorch version and the design notes are in
// src/repro_torch/kernels/flash_prefill.py; the tensor-core tile loop and
// the split arithmetic in flash_mma.cuh.
//
// Rows.  The G query heads of a kv head ride as rows: row r of (batch row b,
// kv head kh) is query s = r / G, head g = r % G, at position q_start[b] + s.
// Key j is live for it iff j < valid[b], j <= pos and pos - j < window;
// masked scores are -1e30 like the reference's.  Cache values dequantize
// exactly (kv_bf16: as is; kv_int8: q * 2**e per (token, head); kv_mx:
// sign-extended nibbles, low nibble = even channel, times 2**e per 32-token
// block -- at most 8 significant bits, a normal number: exact in bf16).
//
// S > 1 (prefill chunks): grid (B * Kh, ceil(S * G / 64)), 4 warps.  A block
// owns 64 rows (a ragged last tile masks itself), each warp 16.  q * scale
// goes into shared memory as three bf16 planes (exact); key tiles of 64 are
// double-buffered with cp.async (kv_bf16 straight into the planes the tensor
// cores read; kv_int8 and kv_mx as packed bytes, dequantized into one bf16
// K and one V plane per tile), and flash::tile_step runs the tile on the
// tensor cores with p in three bf16 terms.  Tiles wholly outside the block's
// live keys (past valid[b], after its last query, before its first query's
// window) are skipped, and so are, per warp, tiles outside the warp's: they
// would add exact zeros.
//
// Head dims 16, 32, 64, 112 (zamba2), 128 and 240 (gemma3).  At 240 a K / V
// plane row is 248 bf16 (496 bytes: ldmatrix rows still on distinct banks),
// the mma steps are 15 (k16) and 30 (n8), and a kv_mx row is 120 bytes,
// copied in 8-byte pieces (kv_mx at hd 16 too); prefill takes 222,208
// bytes of shared memory (kv_bf16), 220,416 (kv_int8), 189,696 (kv_mx): one
// block an SM.  At 112 a plane row is 120 bf16 (240 bytes, 16-byte aligned,
// its 8 ldmatrix rows 60 words apart: distinct banks), the mma steps are 7
// (k16) and 14 (n8), rows are 224 bytes (kv_bf16), 112 (kv_int8) and 56
// (kv_mx, 8-byte pieces); prefill takes 107,520 / 105,728 / 91,392 bytes.
//
// S == 1 (decode): grid (B * Kh, splits), 4 warps, on the CUDA cores (G
// rows a pair are too few for an mma tile).  Split z covers keys
// [z * ks, (z + 1) * ks) of the live range; HD / 8 lanes share a key row
// (rounded up to a power of two: at hd 240, 30 lanes of a warp's 32 and a
// key a warp step, the last two lanes idle; at hd 112, 14 of 16 and two
// keys a warp step), each loading its 8 values
// straight into registers (16 bytes of kv_bf16, 8 of kv_int8, 4 of kv_mx)
// and dotting them with its 8 query values per row.
// The split writes its (m, l, acc) to the partials, then counts itself in on
// the pair's arrival counter; the last block of the pair to arrive combines
// the partials in split order (so the result does not depend on which block
// is last):  out = sum_z e^(m_z - M) acc_z / max(sum_z e^(m_z - M) l_z, 1e-30),
// and resets the counter for the next call.  One launch a decode call.
#include <type_traits>

#include "flash_mma.cuh"

namespace {

using flash::kNegInf;
using flash::kWarpRows;
using flash::Ld;
using flash::RowState;

constexpr int kThreads = 128, kWarps = kThreads / 32;
constexpr int kRows = kWarpRows * kWarps;  // prefill rows a block
constexpr int kTile = 64;                  // prefill keys a tile
constexpr int kMxBlock = 32;
constexpr int kMaxG = 8;  // decode rows held in registers at a time
enum Fmt { kBf16 = 0, kInt8 = 1, kMx = 2 };

struct Shape {
  int S, T, Kh, G, hd, splits, ks;
};

template <int FMT>
__host__ __device__ constexpr int row_bytes(int hd) {
  return FMT == kBf16 ? 2 * hd : (FMT == kInt8 ? hd : hd / 2);
}

// prefill shared memory, in bytes: three Q planes, then
//   kv_bf16: [2 stages][K, V][kTile][kLd] bf16 (the cp.async targets)
//   packed:  one K and one V plane, then [2 stages][K, V][kTile][row bytes],
//            then [2 stages][K, V][kTile] int8 exponents (kv_mx uses 2 a tile)
template <int FMT, int HD>
struct Prefill {
  static constexpr int kLd = Ld<HD>::value, kQPlane = kRows * kLd, kKvPlane = kTile * kLd;
  static constexpr int kRow = row_bytes<FMT>(HD);
  static constexpr size_t kQBytes = 2 * 3 * static_cast<size_t>(kQPlane);
  static constexpr size_t kPlaneBytes = 2 * (FMT == kBf16 ? 4 : 2) * static_cast<size_t>(kKvPlane);
  static constexpr size_t kRawBytes = FMT == kBf16 ? 0 : 2 * 2 * static_cast<size_t>(kTile) * kRow;
  static constexpr size_t kExpBytes = FMT == kBf16 ? 0 : 2 * 2 * kTile;
  static constexpr size_t kSmem = kQBytes + kPlaneBytes + kRawBytes + kExpBytes;
};

template <int FMT, int HD>
__global__ void __launch_bounds__(kThreads)
prefill_kernel(const float* __restrict__ q, const void* __restrict__ k, const void* __restrict__ v,
               const int8_t* __restrict__ ke, const int8_t* __restrict__ ve, const int* __restrict__ q_start,
               const int* __restrict__ valid, const int* __restrict__ window, float* __restrict__ o, Shape sh,
               float scale) {
  using P = Prefill<FMT, HD>;
  constexpr int kCB = P::kRow % 16 ? 8 : 16;  // bytes of a copy: 8 where a row is not whole 16-byte chunks
  constexpr int kLd = P::kLd, kChunks = P::kRow / kCB;  // copies of a cache row
  using Chunk = typename std::conditional<kCB == 16, uint4, uint2>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kvs = reinterpret_cast<__nv_bfloat16*>(smem + P::kQBytes);
  unsigned char* raw = smem + P::kQBytes + P::kPlaneBytes;
  int8_t* es = reinterpret_cast<int8_t*>(raw + P::kRawBytes);

  const int b = blockIdx.x / sh.Kh, kh = blockIdx.x % sh.Kh;
  const int R = sh.S * sh.G, r0 = blockIdx.y * kRows, r_last = min(r0 + kRows, R) - 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qs0 = q_start[b], vl = min(valid[b], sh.T), win = window[0];
  // live keys of the block: [k_lo, k_hi)
  const int k_lo = max(qs0 + r0 / sh.G - win + 1, 0);
  const int k_hi = min(vl, qs0 + r_last / sh.G + 1);
  const int t_begin = k_lo / kTile, t_end = k_hi > k_lo ? (k_hi + kTile - 1) / kTile : t_begin;
  const char* kc = static_cast<const char*>(k);
  const char* vc = static_cast<const char*>(v);

  // key tile `tile` -> stage `st`: packed rows by cp.async (keys past T
  // zero-filled), and for the packed formats the exponents, loaded into
  // registers now and stored at the top of the iteration that uses them
  auto cache_row = [&](int j) { return (static_cast<size_t>(b) * sh.T + j) * sh.Kh + kh; };
  auto issue = [&](int tile, int st) {
    const int j0 = tile * kTile;
    for (int c = tid; c < 2 * kTile * kChunks; c += kThreads) {
      const int which = c / (kTile * kChunks), jj = (c / kChunks) % kTile, part = c % kChunks, j = j0 + jj;
      const char* src = (which ? vc : kc) + cache_row(min(j, sh.T - 1)) * P::kRow + part * kCB;
      void* dst;
      if constexpr (FMT == kBf16)
        dst = kvs + ((st * 2 + which) * kTile + jj) * kLd + part * 8;
      else
        dst = raw + ((st * 2 + which) * kTile + jj) * P::kRow + part * kCB;
      if constexpr (kCB == 16)
        flash::cp_async16(dst, src, j < sh.T);
      else
        flash::cp_async8(dst, src, j < sh.T);
    }
  };
  auto load_exp = [&](int tile) -> int {  // thread tid < 2 kTile: exponent tid % kTile of K (tid < kTile) or V
    const int which = tid / kTile, jj = tid % kTile, j = tile * kTile + jj;
    const int8_t* e = which ? ve : ke;
    if (FMT == kBf16 || tid >= 2 * kTile) return 0;
    if constexpr (FMT == kInt8) {
      return j < sh.T ? e[cache_row(j)] : 0;
    } else {
      if (jj >= kTile / kMxBlock) return 0;
      const int blk = tile * (kTile / kMxBlock) + jj;
      return blk < sh.T / kMxBlock ? e[(static_cast<size_t>(b) * (sh.T / kMxBlock) + blk) * sh.Kh + kh] : 0;
    }
  };
  int e_next = 0;
  if (t_begin < t_end) {
    issue(t_begin, 0);
    e_next = load_exp(t_begin);
  }
  flash::cp_async_commit();

  // q * scale -> three bf16 planes; rows past S * G are zero
  for (int c = tid; c < kRows * (HD / 8); c += kThreads) {
    const int r = c / (HD / 8), d = (c % (HD / 8)) * 8, row = r0 + r;
    float x[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (row < R) {
      const int s = row / sh.G, g = row % sh.G;
      const float* src = q + ((static_cast<size_t>(b) * sh.S + s) * sh.Kh + kh) * sh.G * HD + g * HD + d;
      const float4 a = *reinterpret_cast<const float4*>(src), c4 = *reinterpret_cast<const float4*>(src + 4);
      x[0] = a.x * scale, x[1] = a.y * scale, x[2] = a.z * scale, x[3] = a.w * scale;
      x[4] = c4.x * scale, x[5] = c4.y * scale, x[6] = c4.z * scale, x[7] = c4.w * scale;
    }
    flash::store_split8<3>(qs + r * kLd + d, P::kQPlane, x);
  }

  // the warp's rows and live keys
  const int w0 = r0 + warp * kWarpRows, w_last = min(w0 + kWarpRows, R) - 1, g = lane >> 2;
  const int wk_lo = max(qs0 + w0 / sh.G - win + 1, 0);
  const int wk_hi = min(vl, qs0 + w_last / sh.G + 1);
  int pos[2];  // positions of rows g and g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) pos[h] = qs0 + (w0 + g + 8 * h) / sh.G;

  RowState<HD> st;
  st.init();
  for (int tile = t_begin, it = 0; tile < t_end; ++tile, ++it) {
    const int stage = it & 1;
    if constexpr (FMT != kBf16)
      if (tid < 2 * kTile) es[stage * 2 * kTile + tid] = static_cast<int8_t>(e_next);
    __syncthreads();  // every warp is done with the stage (and planes) about to be refilled
    if (tile + 1 < t_end) {
      issue(tile + 1, stage ^ 1);
      e_next = load_exp(tile + 1);
    }
    flash::cp_async_commit();
    flash::cp_async_wait<1>();
    __syncthreads();  // tile `tile` has landed for every thread
    const __nv_bfloat16* kp;
    if constexpr (FMT == kBf16) {
      kp = kvs + stage * 2 * P::kKvPlane;
    } else {  // packed rows -> one bf16 plane each of K and V
      constexpr int kPer = FMT == kInt8 ? kCB : 2 * kCB;  // values of a copy
      const unsigned char* src = raw + stage * 2 * kTile * P::kRow;
      const int8_t* ex = es + stage * 2 * kTile;
      for (int c = tid; c < 2 * kTile * kChunks; c += kThreads) {
        const int which = c / (kTile * kChunks), jj = (c / kChunks) % kTile, part = c % kChunks;
        const Chunk u = *reinterpret_cast<const Chunk*>(src + (which * kTile + jj) * P::kRow + part * kCB);
        __nv_bfloat16* dst = kvs + which * P::kKvPlane + jj * kLd + part * kPer;
        if constexpr (FMT == kInt8) {
          const float sc = flash::exp2i(ex[which * kTile + jj]);
          const int8_t* m = reinterpret_cast<const int8_t*>(&u);
          float x[8];
#pragma unroll
          for (int h = 0; h < kCB / 8; ++h) {
#pragma unroll
            for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(m[8 * h + i]) * sc;
            flash::store_split8<1>(dst + 8 * h, 0, x);
          }
        } else {
          const float sc = flash::exp2i(ex[which * kTile + jj / kMxBlock]);
          const uint8_t* m = reinterpret_cast<const uint8_t*>(&u);
          float x[8];
#pragma unroll
          for (int h = 0; h < kCB / 4; ++h) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int lo = m[4 * h + i] & 0xF, hi = m[4 * h + i] >> 4;
              x[2 * i] = static_cast<float>(lo >= 8 ? lo - 16 : lo) * sc;
              x[2 * i + 1] = static_cast<float>(hi >= 8 ? hi - 16 : hi) * sc;
            }
            flash::store_split8<1>(dst + 8 * h, 0, x);
          }
        }
      }
      __syncthreads();
      kp = kvs;
    }
    const int j0 = tile * kTile;
    if (w0 < R && j0 < wk_hi && j0 + kTile > wk_lo) {  // warp-uniform
      auto live = [&](int h, int jj) {
        const int key = j0 + jj;
        return key < vl && key <= pos[h] && pos[h] - key < win;
      };
      flash::tile_step<HD, kTile, 3, 1, 3, 1>(st, qs + warp * kWarpRows * kLd, P::kQPlane, kp, kp + P::kKvPlane, 0,
                                              live);
    }
  }
  flash::cp_async_wait<0>();

  if (w0 < R) {
    st.finish([&](int h, int col, float a, float c) {
      const int row = w0 + g + 8 * h;
      if (row >= R) return;
      const int s = row / sh.G, gg = row % sh.G;
      float* dst = o + ((static_cast<size_t>(b) * sh.S + s) * sh.Kh + kh) * sh.G * HD + gg * HD + col;
      *reinterpret_cast<float2*>(dst) = make_float2(a, c);
    });
  }
}

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------

// One lane's 8 values of a cache row: 16 bytes of kv_bf16, 8 of kv_int8,
// 4 of kv_mx, loaded as one word and dequantized in registers.
template <int FMT>
struct Raw8 {
  using T = uint4;
};
template <>
struct Raw8<kInt8> {
  using T = uint2;
};
template <>
struct Raw8<kMx> {
  using T = uint32_t;
};

template <int FMT, int HD>
__device__ __forceinline__ typename Raw8<FMT>::T load8(const void* c, size_t row, int part) {
  using T = typename Raw8<FMT>::T;
  return __ldg(reinterpret_cast<const T*>(static_cast<const char*>(c) + row * row_bytes<FMT>(HD)) + part);
}

template <int FMT>
__device__ __forceinline__ void dequant8(float (&x)[8], typename Raw8<FMT>::T u, float sc) {
  if constexpr (FMT == kBf16) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[2 * i] = __low2float(h[i]), x[2 * i + 1] = __high2float(h[i]);
  } else if constexpr (FMT == kInt8) {
    const int8_t* m = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(m[i]) * sc;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int byte = (u >> (8 * i)) & 0xFF, lo = byte & 0xF, hi = byte >> 4;
      x[2 * i] = static_cast<float>(lo >= 8 ? lo - 16 : lo) * sc;
      x[2 * i + 1] = static_cast<float>(hi >= 8 ? hi - 16 : hi) * sc;
    }
  }
}

// The cache rows a lane visits, kBatch at a time: all kBatch loads are
// issued before the first is used, so their latencies overlap.
constexpr int kBatch = 8;
template <int FMT, int HD>
struct RowBatch {
  typename Raw8<FMT>::T raw[kBatch];
  int8_t ex[kBatch];

  // keys first + i * stride (i < kBatch), clamped to [.., last]
  template <class Rows>
  __device__ __forceinline__ void load(const void* c, const int8_t* e, int first, int stride, int last, int part,
                                       Rows rows) {
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      size_t row, erow;
      rows(min(first + i * stride, last), row, erow);
      raw[i] = load8<FMT, HD>(c, row, part);
      if constexpr (FMT != kBf16) ex[i] = __ldg(e + erow);
    }
  }
  __device__ __forceinline__ void values(float (&x)[8], int i) const {
    dequant8<FMT>(x, raw[i], FMT == kBf16 ? 1.0f : flash::exp2i(ex[i]));
  }
};

// decode shared memory, in floats: scores [kMaxG][ks], per-warp partial
// accumulators [kWarps][kMaxG][HD], row (max, sum) [kMaxG][2]
__host__ __device__ constexpr size_t decode_smem(int hd, int ks) {
  return sizeof(float) * (static_cast<size_t>(kMaxG) * ks + static_cast<size_t>(kWarps) * kMaxG * hd + 2 * kMaxG);
}

template <int FMT, int HD>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const void* __restrict__ k, const void* __restrict__ v,
              const int8_t* __restrict__ ke, const int8_t* __restrict__ ve, const int* __restrict__ q_start,
              const int* __restrict__ valid, const int* __restrict__ window, float* __restrict__ part,
              int* __restrict__ counters, float* __restrict__ o, Shape sh, float scale) {
  constexpr int L = HD / 8;                                   // lanes holding a key row's values
  constexpr int LP = L <= 2 ? 2 : L <= 4 ? 4 : L <= 8 ? 8 : L <= 16 ? 16 : 32;  // lanes a key row
  constexpr int KW = 32 / LP;                                 // keys a warp step
  static_assert(L <= 32, "a key row is at most a warp");
  constexpr int kSlot = HD + 2;           // partial of one row: m, l, acc[HD]
  extern __shared__ __align__(16) float dsm[];
  float* sc = dsm;                             // [kMaxG][ks]
  float* red = sc + kMaxG * sh.ks;             // [kWarps][kMaxG][HD]
  float* ml = red + kWarps * kMaxG * HD;       // [kMaxG][2]
  __shared__ int is_last;

  const int pair = blockIdx.x, b = pair / sh.Kh, kh = pair % sh.Kh, z = blockIdx.y, nz = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, sub = lane / LP, pt = lane % LP;
  const bool idle = pt >= L;           // lanes past a row's values (hd 240: 2 of 32) ...
  const int part_of = min(pt, L - 1);  // ... load a valid part and add 0
  const int pos = q_start[b], win = window[0];
  const int lo = max(max(pos - win + 1, 0), z * sh.ks);
  const int hi = min(min(min(valid[b], pos + 1), sh.T), (z + 1) * sh.ks);
  auto rows = [&](int key, size_t& row, size_t& erow) {
    row = (static_cast<size_t>(b) * sh.T + key) * sh.Kh + kh;
    erow = FMT == kMx ? (static_cast<size_t>(b) * (sh.T / kMxBlock) + key / kMxBlock) * sh.Kh + kh : row;
  };

  for (int g0 = 0; g0 < sh.G; g0 += kMaxG) {
    const int ng = min(kMaxG, sh.G - g0);
    float* slot = part + ((static_cast<size_t>(pair) * nz + z) * sh.G + g0) * kSlot;
    if (hi <= lo) {  // no live key in this split
      for (int i = tid; i < ng * kSlot; i += kThreads) slot[i] = i % kSlot == 0 ? kNegInf : 0.0f;
      continue;
    }
    float qv[kMaxG][8];
#pragma unroll
    for (int gg = 0; gg < kMaxG; ++gg) {
      const float* src = q + ((static_cast<size_t>(b) * sh.Kh + kh) * sh.G + g0 + gg) * HD + part_of * 8;
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[gg][i] = gg < ng && !idle ? src[i] * scale : 0.0f;
    }
    // scores: the L lanes of a key row each dot 8 values, then sum across
    constexpr int kStep = kWarps * KW;  // keys of one step of the block
    for (int base = lo + warp * KW; base < hi; base += kBatch * kStep) {
      RowBatch<FMT, HD> rb;
      rb.load(k, ke, base + sub, kStep, hi - 1, part_of, rows);
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (base + i * kStep >= hi) break;  // warp-uniform
        const int key = base + i * kStep + sub;
        float x[8];
        rb.values(x, i);
        float d[kMaxG];
#pragma unroll
        for (int gg = 0; gg < kMaxG; ++gg) {
          float a = 0.0f;
#pragma unroll
          for (int j = 0; j < 8; ++j) a = fmaf(qv[gg][j], x[j], a);
          d[gg] = idle ? 0.0f : a;
        }
#pragma unroll
        for (int off = LP / 2; off; off >>= 1)
#pragma unroll
          for (int gg = 0; gg < kMaxG; ++gg) d[gg] += __shfl_xor_sync(0xffffffffu, d[gg], off);
        if (key < hi && pt == 0)
#pragma unroll
          for (int gg = 0; gg < kMaxG; ++gg)
            if (gg < ng) sc[gg * sh.ks + key - lo] = d[gg];
      }
    }
    __syncthreads();
    // max, p = e^(s - m) and sum of each row, a warp a row
    const int n = hi - lo;
    for (int gg = warp; gg < ng; gg += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sc[gg * sh.ks + j]);
#pragma unroll
      for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.0f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(sc[gg * sh.ks + j] - mx);
        sc[gg * sh.ks + j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) ml[2 * gg] = mx, ml[2 * gg + 1] = sum;
    }
    __syncthreads();
    // P.V: each lane its 8 columns, summed over the keys it visits
    float acc[kMaxG][8];
#pragma unroll
    for (int gg = 0; gg < kMaxG; ++gg)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[gg][i] = 0.0f;
    for (int base = lo + warp * KW; base < hi; base += kBatch * kStep) {
      RowBatch<FMT, HD> rb;
      rb.load(v, ve, base + sub, kStep, hi - 1, part_of, rows);
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int key = base + i * kStep + sub;
        if (key >= hi) continue;
        float x[8];
        rb.values(x, i);
#pragma unroll
        for (int gg = 0; gg < kMaxG; ++gg) {
          const float p = gg < ng ? sc[gg * sh.ks + key - lo] : 0.0f;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[gg][j] = fmaf(p, x[j], acc[gg][j]);
        }
      }
    }
#pragma unroll
    for (int off = LP; off < 32; off <<= 1)  // across the keys of a warp step
#pragma unroll
      for (int gg = 0; gg < kMaxG; ++gg)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[gg][i] += __shfl_xor_sync(0xffffffffu, acc[gg][i], off);
    if (sub == 0 && !idle)
#pragma unroll
      for (int gg = 0; gg < kMaxG; ++gg)
        if (gg < ng)
#pragma unroll
          for (int i = 0; i < 8; ++i) red[(warp * kMaxG + gg) * HD + pt * 8 + i] = acc[gg][i];
    __syncthreads();
    for (int i = tid; i < ng * HD; i += kThreads) {
      const int gg = i / HD, d = i % HD;
      float a = red[gg * HD + d];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) a += red[(w * kMaxG + gg) * HD + d];
      slot[gg * kSlot + 2 + d] = a;
    }
    for (int gg = tid; gg < ng; gg += kThreads) slot[gg * kSlot] = ml[2 * gg], slot[gg * kSlot + 1] = ml[2 * gg + 1];
    __syncthreads();  // sc, red and ml are free for the next row group
  }

  // the last block of the pair to arrive combines the partials in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + pair, 1) == nz - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* pp = part + static_cast<size_t>(pair) * nz * sh.G * kSlot;
  for (int i = tid; i < sh.G * HD; i += kThreads) {
    const int gg = i / HD, d = i % HD;
    float mx = kNegInf;
    for (int zz = 0; zz < nz; ++zz) mx = fmaxf(mx, __ldcg(pp + (zz * sh.G + gg) * kSlot));
    float l = 0.0f, a = 0.0f;
    for (int zz = 0; zz < nz; ++zz) {
      const float* s = pp + (zz * sh.G + gg) * kSlot;
      const float w = expf(__ldcg(s) - mx);
      l = fmaf(__ldcg(s + 1), w, l);
      a = fmaf(__ldcg(s + 2 + d), w, a);
    }
    o[((static_cast<size_t>(b) * sh.Kh + kh) * sh.G + gg) * HD + d] = a / fmaxf(l, 1e-30f);
  }
  if (tid == 0) counters[pair] = 0;  // ready for the next call
}

template <int FMT, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ke, const void* ve,
                   const void* q_start, const void* valid, const void* window, void* part, void* counters, void* o,
                   int B, const Shape& sh, float scale, size_t smem, cudaStream_t stream) {
  const int8_t* kex = static_cast<const int8_t*>(ke);
  const int8_t* vex = static_cast<const int8_t*>(ve);
  const int* qs = static_cast<const int*>(q_start);
  const int* vl = static_cast<const int*>(valid);
  const int* win = static_cast<const int*>(window);
  if (sh.S > 1) {
    using P = Prefill<FMT, HD>;
    static_assert(P::kSmem <= 232448, "shared memory over the 227 KB a block may have");
    if (smem != P::kSmem) return cudaErrorInvalidValue;  // the wrapper's sizing disagrees
    static bool configured = false;  // raise the dynamic shared-memory cap once
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(prefill_kernel<FMT, HD>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(P::kSmem));
      if (err != cudaSuccess) return err;
      configured = true;
    }
    prefill_kernel<FMT, HD><<<dim3(B * sh.Kh, (sh.S * sh.G + kRows - 1) / kRows), kThreads, P::kSmem, stream>>>(
        static_cast<const float*>(q), k, v, kex, vex, qs, vl, win, static_cast<float*>(o), sh, scale);
    return cudaGetLastError();
  }
  if (smem != decode_smem(HD, sh.ks) || smem > 48 * 1024) return cudaErrorInvalidValue;
  decode_kernel<FMT, HD><<<dim3(B * sh.Kh, sh.splits), kThreads, smem, stream>>>(
      static_cast<const float*>(q), k, v, kex, vex, qs, vl, win, static_cast<float*>(part),
      static_cast<int*>(counters), static_cast<float*>(o), sh, scale);
  return cudaGetLastError();
}

template <int FMT>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const void* ke, const void* ve,
                      const void* q_start, const void* valid, const void* window, void* part, void* counters,
                      void* o, int B, const Shape& sh, float scale, size_t smem, cudaStream_t s) {
  switch (sh.hd) {
    case 16: return launch<FMT, 16>(q, k, v, ke, ve, q_start, valid, window, part, counters, o, B, sh, scale, smem, s);
    case 32: return launch<FMT, 32>(q, k, v, ke, ve, q_start, valid, window, part, counters, o, B, sh, scale, smem, s);
    case 64: return launch<FMT, 64>(q, k, v, ke, ve, q_start, valid, window, part, counters, o, B, sh, scale, smem, s);
    case 112: return launch<FMT, 112>(q, k, v, ke, ve, q_start, valid, window, part, counters, o, B, sh, scale, smem,
                                      s);
    case 128: return launch<FMT, 128>(q, k, v, ke, ve, q_start, valid, window, part, counters, o, B, sh, scale, smem,
                                      s);
    case 240: return launch<FMT, 240>(q, k, v, ke, ve, q_start, valid, window, part, counters, o, B, sh, scale, smem,
                                      s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// smem: the wrapper's size of the dynamic shared memory (checked against
// the kernel's own); part, counters: decode scratch (S == 1), else unused.
extern "C" int flash_attend_launch(int fmt, const void* q, const void* k, const void* v, const void* ke,
                                   const void* ve, const void* q_start, const void* valid, const void* window,
                                   void* part, void* counters, void* o, int B, int S, int T, int Kh, int G, int hd,
                                   int splits, int ks, float scale, long long smem, void* stream) {
  const Shape sh{S, T, Kh, G, hd, splits, ks};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  cudaError_t err;
  if (fmt == kBf16)
    err = launch_hd<kBf16>(q, k, v, ke, ve, q_start, valid, window, part, counters, o, B, sh, scale, sm, s);
  else if (fmt == kInt8)
    err = launch_hd<kInt8>(q, k, v, ke, ve, q_start, valid, window, part, counters, o, B, sh, scale, sm, s);
  else if (fmt == kMx)
    err = launch_hd<kMx>(q, k, v, ke, ve, q_start, valid, window, part, counters, o, B, sh, scale, sm, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
