// The expert-batched GEMV of an MoE expert site at decode (packed_qmm over
// E experts at C <= 8 rows each, one call) for Hopper (sm_90a), built on the
// lane maps, decodes and float order of qmm_gemv.cuh;
// tests/test_torch_qmm_gemv.py emulates its work walk on the CPU.
//
// What bounds it: the packed weights of the experts a tick routes to (at a
// 4-slot decode tick, 8 token replicas reach ~5.5 of grok-1's 8 experts and
// at most 8 of arctic's 128), streamed once at 3.35 TB/s, then the
// instructions per weight.  The capacity buffer x (E, C, K) is zero in
// every row no token was routed to; an int8 row of zeros adds exactly +0
// to every cluster sum (fma(1.5 * 2^23 + 0, sm, -1.5 * 2^23 * sm) = +0, and
// +0 + +0 = +0, in the plain cluster_sums too), so an expert whose rows are
// all zero is skipped and its (C, N) out block written as +0, bit for bit.
// The design:
//
// - Two launches on the caller's stream, no host synchronisation.
//   expert_rows_kernel ORs each expert's int8 rows in P slices (grid
//   (P, E)) into flags (E, P).  expert_gemv_kernel: every block reads the
//   flags and builds the same list of routed experts (ascending) and of
//   skipped ones in shared memory.
// - The whole card for the routed experts.  The work is R x ceil(N / 32)
//   units, a unit one routed expert's strip of 32 output columns over the
//   WHOLE K.  The grid is persistent (kBlocksPerSm blocks an SM); warp w of
//   the W warps takes units [w U / W, (w + 1) U / W) -- adjacent strips of
//   one expert in one block, so its warps read the same x rows close in
//   time (L1) -- and the blocks' threads write the skipped experts' +0
//   out blocks, grid-strided.
// - No barrier after the list.  A warp owns its unit's outputs: it walks
//   the k-tiles in order, each tile's clusters in order into the tile sum
//   from 0, the tiles in order into the run from 0 (the reference's order:
//   cluster_sums), in registers, and stores the run.  There are no k-splits,
//   no slots, no cluster barriers, and x is never staged: each lane copies
//   its own x bytes of the next step (16 at a 64-k step; row g of the mma's
//   B operand) into the ring beside its weight bytes and scale word, so any
//   K runs (grok-1's down projection, K 32768, in one pass) and the x rows
//   come from L2 / L1, x being 0.4-7.3 MB an expert site.  The ternary and
//   int4 decodes take x in perm8 order: the lane permutes its raw bytes
//   with one __byte_perm a register.
// - The stream: a per-warp ring of kRing stages (qmm_gemv.cuh's Map),
//   kRing - 1 steps ahead across unit boundaries, so each of the 16
//   resident warps of an SM keeps ~4 KB of weights in flight.
#pragma once

#include "../../src/repro_torch/csrc/qmm_gemv.cuh"

namespace qmm {
namespace gemv {
namespace {

constexpr int kMaxExperts = 256;  // experts of a site the list holds (arctic: 128)

struct ExpertArgs {
  const int8_t* x;    // (E, M, K) int8 mantissas
  const void* w;      // (E, K / word k, N) packed weights
  const int8_t* sm;   // (E, K / G, N) scale mantissas
  const int* flags;   // (E, P): slice p of expert e's rows holds a non-zero byte
  float* out;         // (E, M, N)
  int E, P, M, K, N, group, bk;
  uint4 lut;
};

// flags[e * P + p] = whether slice p of expert e's M * K int8 bytes holds a
// non-zero byte.  Grid (P, E), kThreads threads, 16-byte loads.
__global__ void __launch_bounds__(kThreads) expert_rows_kernel(const int8_t* __restrict__ x, int* __restrict__ flags,
                                                               int per_expert16, int P) {
  const int e = blockIdx.y, p = blockIdx.x, per = (per_expert16 + P - 1) / P;
  const uint4* v = reinterpret_cast<const uint4*>(x) + static_cast<size_t>(e) * per_expert16;
  unsigned any = 0;
  for (int i = p * per + threadIdx.x; i < min(per_expert16, (p + 1) * per); i += kThreads) {
    const uint4 w = __ldg(v + i);
    any |= w.x | w.y | w.z | w.w;
  }
  any = __syncthreads_or(any != 0);
  if (threadIdx.x == 0) flags[e * P + p] = static_cast<int>(any);
}

// x bytes a lane copies a step: its B registers' k, and for ternary and
// int4 at one register (16-k steps) the 8 raw bytes its perm8 half lies in.
template <int V>
struct XLane {
  static constexpr int kBytes = Map<V>::kPerm && Map<V>::kRegs == 1 ? 8 : 4 * Map<V>::kRegs;
  __device__ static int offset(int t) { return kBytes == 4 * Map<V>::kRegs ? kBytes * t : 8 * (t >> 1); }
};

// cp.async of N = 4, 8 or 16 bytes through L1 (.ca: the warps of a block
// read the same x rows), zero-filled when !pred.
template <int N>
__device__ __forceinline__ void cp_ca(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)), "l"(src), "n"(N),
               "r"(pred ? N : 0)
               : "memory");
}

// A lane's kXB raw x bytes out of its ring slot.
template <int kXB>
__device__ __forceinline__ void load_raw(const unsigned char* p, uint32_t (&raw)[kXB / 4]) {
  if constexpr (kXB == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    raw[0] = v.x, raw[1] = v.y, raw[2] = v.z, raw[3] = v.w;
  } else if constexpr (kXB == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    raw[0] = v.x, raw[1] = v.y;
  } else {
    raw[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// The lane's raw x bytes of a step -> its B registers (perm8 order where the
// decode takes it: positions 0-3 of each 8 hold k 0, 2, 4, 6, positions 4-7
// k 1, 3, 5, 7, as qmm_gemv.cuh's store8).
template <int V>
__device__ __forceinline__ void x_regs(const uint32_t* raw, int t, uint32_t (&X)[Map<V>::kRegs]) {
  using P = Map<V>;
  if constexpr (!P::kPerm) {
#pragma unroll
    for (int j = 0; j < P::kRegs; ++j) X[j] = raw[j];
  } else if constexpr (P::kRegs == 1) {
    X[0] = __byte_perm(raw[0], raw[1], (t & 1) ? 0x7531 : 0x6420);
  } else {
#pragma unroll
    for (int j = 0; j < P::kRegs; j += 2)
      X[j] = __byte_perm(raw[j], raw[j + 1], 0x6420), X[j + 1] = __byte_perm(raw[j], raw[j + 1], 0x7531);
  }
}

// Dynamic shared memory of a block: each warp's ring of weight bytes, x
// bytes and scale words.
template <int V>
__host__ __device__ constexpr size_t expert_smem_bytes() {
  return static_cast<size_t>(kWarps) * Map<V>::kRing * 32 * (Map<V>::kLaneBytes + XLane<V>::kBytes + 4);
}

// kMask: bit 0 copies x into the ring, bit 1 the scale words, bit 2 has
// only lane t = 0 of a group copy the scales (the others take them by a
// shuffle).  The package's kernel is mask 3.
// kDepth: ring stages (0: the package's Map<V>::kRing); the ring holds only
// what the mask streams.
template <int V, int kStage, int kMask, int kDepth>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) expert_gemv_kernel(const ExpertArgs a) {
  unsigned sink = 0;  // stages < 3: what the dropped stages would read
  using P = Map<V>;
  constexpr int kRing = kDepth ? kDepth : P::kRing, kSK = P::kSK, kRegs = P::kRegs, kXB = XLane<V>::kBytes;
  constexpr int kXL = (kMask & 1) ? kXB : 0;  // x bytes a lane's ring slot holds
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int routed[kMaxExperts], skipped[kMaxExperts];
  __shared__ int n_routed;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int M = a.M, K = a.K, N = a.N, G = a.group, bk = a.bk, E = a.E;
  unsigned char* ring_w = smem + warp * (kRing * 32 * P::kLaneBytes);
  unsigned char* ring_x = smem + kWarps * kRing * 32 * P::kLaneBytes + warp * (kRing * 32 * kXL);
  int* ring_s = reinterpret_cast<int*>(smem + kWarps * kRing * 32 * (P::kLaneBytes + kXL)) + warp * kRing * 32;

  // The lists, the same in every block: routed and skipped experts, ascending.
  if (warp == 0) {
    int nr = 0, ns = 0;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + lane;
      int f = 0;
      if (e < E)
        for (int p = 0; p < a.P; ++p) f |= a.flags[e * a.P + p];
      const unsigned on = __ballot_sync(0xffffffffu, e < E && f), off = __ballot_sync(0xffffffffu, e < E && !f);
      const unsigned below = (1u << lane) - 1u;
      if (e < E && f) routed[nr + __popc(on & below)] = e;
      if (e < E && !f) skipped[ns + __popc(off & below)] = e;
      nr += __popc(on), ns += __popc(off);
    }
    if (lane == 0) n_routed = nr;
  }
  __syncthreads();
  const int R = n_routed, strips = (N + kStrip - 1) / kStrip;
  const long long U = static_cast<long long>(R) * strips, W = static_cast<long long>(gridDim.x) * kWarps;
  const long long wid = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const int u0 = static_cast<int>(wid * U / W), u1 = static_cast<int>((wid + 1) * U / W);

  // The load cursor walks this warp's steps in the order they are used:
  // units, clusters, steps.
  constexpr int kElem = P::kDec == kInt8 ? 1 : 4;  // bytes of a packed element
  const int spc = G / kSK, clusters = K / G;
  const size_t row_bytes = static_cast<size_t>(N) * kElem, step_bytes = (kSK / P::kWordK) * row_bytes;
  const size_t w_expert = static_cast<size_t>(K / P::kWordK) * row_bytes;
  int lu = u0, lc = 0, ls = 0, issued = 0;
  bool lok = false;
  const unsigned char* lw = nullptr;  // the lane's first weight row of the next step
  const int8_t* lx = nullptr;         // its x bytes of the next step
  const int8_t* lsm = nullptr;
  auto seek = [&]() {  // the first step of unit lu
    const size_t e = routed[lu / strips];
    const int col = (lu % strips) * kStrip + 4 * g;
    lok = col < N;
    const int row = P::kDec == kInt8 ? (kSK / 4) * t : t / P::kShare;
    lw = static_cast<const unsigned char*>(a.w) + e * w_expert + row * row_bytes + static_cast<size_t>(col) * kElem;
    lx = a.x + (e * M + min(g, M - 1)) * K + XLane<V>::offset(t);
    lsm = a.sm + e * clusters * N + col;
  };
  if (lu < u1) seek();
  auto issue = [&]() {
    const int slot = issued & (kRing - 1);
    if (lu < u1) {
      unsigned char* dst = ring_w + (slot * 32 + lane) * P::kLaneBytes;
      if constexpr (P::kDec == kInt8) {  // 4 bytes (the lane's 4 columns) of each of its kSK / 4 k-rows
#pragma unroll
        for (int i = 0; i < kSK / 4; ++i) cp4(dst + 4 * i, lok ? lw + i * row_bytes : a.w, lok);
      } else {
        cp16(dst, lok ? lw : a.w, lok);  // the lane's 4 columns' words
      }
      if constexpr ((kMask & 1) != 0) cp_ca<kXB>(ring_x + (slot * 32 + lane) * kXL, g < M ? lx : a.x, g < M);
      if constexpr ((kMask & 2) != 0)
        if (ls == 0 && ((kMask & 4) == 0 || t == 0)) cp4(ring_s + slot * 32 + lane, lok ? lsm : a.sm, lok);
      lw += step_bytes;
      lx += kSK;
      if (++ls == spc) {
        ls = 0;
        lsm += N;
        if (++lc == clusters) {
          lc = 0;
          if (++lu < u1) seek();
        }
      }
    }
    commit();  // one group a step, empty past the end, so the waits below count steps
    ++issued;
  };
#pragma unroll 1
  for (int i = 0; i < kRing - 1; ++i) issue();

  // The skipped experts' out blocks: +0, grid-strided in 16-byte stores.
  const long long per4 = static_cast<long long>(M) * N / 4, zeros = (E - R) * per4;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + tid; i < zeros;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long e = skipped[i / per4];
    reinterpret_cast<float4*>(a.out + e * M * N)[i % per4] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  int consumed = 0;
  for (int u = u0; u < u1; ++u) {
    float run[2][4];
#pragma unroll
    for (int jp = 0; jp < 2; ++jp)
#pragma unroll
      for (int e = 0; e < 4; ++e) run[jp][e] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += bk) {  // the k-tiles in order; a ragged last one has fewer clusters
      const int ncl = min(bk, K - k0) / G;
      float acc[2][4];
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jp][e] = 0.0f;
      for (int cl = 0; cl < ncl; ++cl) {
        int c[2][4];
#pragma unroll
        for (int jp = 0; jp < 2; ++jp)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[jp][e] = kMagicBits;
        unsigned smc = 0;
        for (int st = 0; st < spc; ++st) {
          wait_group<kRing - 2>();
          const int slot = consumed & (kRing - 1);
          if (st == 0) {
            smc = static_cast<unsigned>(ring_s[slot * 32 + lane]);
            if constexpr ((kMask & 4) != 0) smc = __shfl_sync(0xffffffffu, smc, lane & ~3);
          }
          uint4 w4[P::kLaneBytes / 16];
#pragma unroll
          for (int j = 0; j < P::kLaneBytes / 16; ++j)
            w4[j] = reinterpret_cast<const uint4*>(ring_w + (slot * 32 + lane) * P::kLaneBytes)[j];
          uint32_t raw[kXB / 4];
          if constexpr ((kMask & 1) != 0) {
            load_raw<kXB>(ring_x + (slot * 32 + lane) * kXL, raw);
          } else {
            raw[0] = 0;
          }
          ++consumed;
          issue();  // into the slot used one step ago
          if constexpr (kStage == 0) {
            sink ^= w4[0].x ^ w4[0].y ^ w4[0].z ^ w4[0].w ^ raw[0] ^ smc;
            continue;
          }
          uint32_t X[kRegs];
          x_regs<V>(raw, t, X);
          uint32_t A[4][kRegs];
          decode<V>(w4, t, a.lut, A);
          if constexpr (kStage == 1) {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
#pragma unroll
              for (int j = 0; j < kRegs; ++j) sink ^= A[cc][j] ^ X[j];
            sink ^= smc;
            continue;
          }
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {  // mma rows g, g + 8: columns 4g + 2jp, 4g + 2jp + 1
            if constexpr (kSK == 16) {
              mma_k16(c[jp], A[2 * jp][0], A[2 * jp + 1][0], X[0]);
            } else {
#pragma unroll
              for (int s = 0; s < kRegs / 2; ++s) {
                const uint32_t af[4] = {A[2 * jp][2 * s], A[2 * jp + 1][2 * s], A[2 * jp][2 * s + 1],
                                        A[2 * jp + 1][2 * s + 1]};
                mma_k32(c[jp], af, X[2 * s], X[2 * s + 1]);
              }
            }
          }
        }
        if constexpr (kStage == 2) {
#pragma unroll
          for (int jp = 0; jp < 2; ++jp)
#pragma unroll
            for (int e = 0; e < 4; ++e) sink ^= c[jp][e] ^ smc;
          continue;
        }
        // the cluster closes: RN(dot * sm) from the magic-number fragment, into the tile sum
        float f[4], nf[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          f[q] = static_cast<float>(static_cast<int8_t>(smc >> (8 * q)));
          if constexpr (P::kDec == kInt4) f[q] = __fmul_rn(f[q], 0.0625f);  // the dot is 16 x the fields
          nf[q] = __fmul_rn(-kMagic, f[q]);  // exact: f has at most 8 significant bits
        }
#pragma unroll
        for (int jp = 0; jp < 2; ++jp)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = 2 * jp + (e >> 1);
            acc[jp][e] = __fadd_rn(acc[jp][e], __fmaf_rn(__int_as_float(c[jp][e]), f[q], nf[q]));
          }
      }
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
#pragma unroll
        for (int e = 0; e < 4; ++e) run[jp][e] = __fadd_rn(run[jp][e], acc[jp][e]);
    }
    // C element e of lane (g, t) is column 4g + 2jp + (e >> 1), row 2t + (e & 1)
    const size_t ex = routed[u / strips];
    const int col = (u % strips) * kStrip + 4 * g;
    if (col < N) {
      float* o = a.out + ex * M * N + col;
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        if (2 * t < M) *reinterpret_cast<float2*>(o + (2 * t) * N + 2 * jp) = make_float2(run[jp][0], run[jp][2]);
        if (2 * t + 1 < M)
          *reinterpret_cast<float2*>(o + (2 * t + 1) * N + 2 * jp) = make_float2(run[jp][1], run[jp][3]);
      }
    }
  }
  wait_group<0>();
  if (sink == 0x9E3779B9u) a.out[0] = 1.0f;
}

template <int kStage, int kMask, int kDepth = 0>
cudaError_t launch_expert_stage(const ExpertArgs& a, int grid, size_t smem, cudaStream_t stream) {
  auto kernel = expert_gemv_kernel<kT64, kStage, kMask, kDepth>;
  static bool configured = false;
  const cudaError_t err = raise_smem_cap(kernel, configured);
  if (err != cudaSuccess) return err;
  expert_rows_kernel<<<dim3(a.P, a.E), kThreads, 0, stream>>>(a.x, const_cast<int*>(a.flags), a.M * a.K / 16, a.P);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gemv
}  // namespace qmm
