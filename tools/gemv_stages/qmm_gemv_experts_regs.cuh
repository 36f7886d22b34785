// A version of qmm_gemv_experts.cuh that streams through a pipeline of
// registers instead of a cp.async ring (slower at every depth tried; kept
// for tools/gemv_stages/pipe_variants.py --regs, no part of the package).
//
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
// The design (PERF.md has the stage timings behind it):
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
//   no slots, no cluster barriers (the grid-z design's per-item reductions
//   and cluster barriers took half its time at grok's gate), and x is never staged in
//   shared memory (the grid-z design staged grok's down projection a k-tile at a time):
//   each lane loads its own x bytes of a step (16 at a 64-k step; row g of
//   the mma's B operand) from L2 / L1, so any K runs in one pass.  The
//   ternary and int4 decodes take x in perm8 order: the lane permutes its
//   raw bytes with one __byte_perm a register.
// - The stream: a pipeline of registers.  Each lane holds the next
//   Pipe::kDepth steps of its weights (8 x 16 bytes; int8 4 x 32) and
//   scale words and the next 2 steps of x; the loop is unrolled by kDepth,
//   so a step reads its registers and loads the step kDepth ahead into
//   them.  A cp.async ring in shared memory on the same lane map streamed
//   at 53-55% of the byte bound whatever its depth (8, 16, 32 stages);
//   plain loads of the same strips 8 deep, at 87-91%.
#pragma once

#include "qmm_gemv.cuh"

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

// x bytes a lane loads a step: its B registers' k, and for ternary and
// int4 at one register (16-k steps) the 8 raw bytes its perm8 half lies in.
template <int V>
struct XLane {
  static constexpr int kBytes = Map<V>::kPerm && Map<V>::kRegs == 1 ? 8 : 4 * Map<V>::kRegs;
  __device__ static int offset(int t) { return kBytes == 4 * Map<V>::kRegs ? kBytes * t : 8 * (t >> 1); }
};

// The register pipeline: steps of weights (and scale words) a lane keeps
// in flight -- 8 of 16 bytes, 4 of int8's 32 -- and of x, which comes from
// L2 / L1.
template <int V>
struct Pipe {
  static constexpr int kDepth = Map<V>::kLaneBytes == 32 ? 4 : 8;
  static constexpr int kXDepth = 2;
};

// The lane's raw x bytes of a step -> its B registers (perm8 order where the
// decode takes it: positions 0-3 of each 8 hold k 0, 2, 4, 6, positions 4-7
// k 1, 3, 5, 7, as qmm_gemv.cuh's store8).
template <int V>
__device__ __forceinline__ void x_regs(const uint32_t (&raw)[XLane<V>::kBytes / 4], int t,
                                       uint32_t (&X)[Map<V>::kRegs]) {
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

// kXB raw x bytes at p (rows M..7: zero).
template <int kXB>
__device__ __forceinline__ void load_x(const int8_t* p, bool ok, uint32_t (&raw)[kXB / 4]) {
  if constexpr (kXB == 16) {
    const uint4 v = ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
    raw[0] = v.x, raw[1] = v.y, raw[2] = v.z, raw[3] = v.w;
  } else if constexpr (kXB == 8) {
    const uint2 v = ok ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0, 0);
    raw[0] = v.x, raw[1] = v.y;
  } else {
    raw[0] = ok ? __ldg(reinterpret_cast<const unsigned*>(p)) : 0u;
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) expert_gemv_kernel(const ExpertArgs a) {
  using P = Map<V>;
  constexpr int kSK = P::kSK, kRegs = P::kRegs, kXB = XLane<V>::kBytes, kNW = P::kLaneBytes / 16;
  constexpr int kDepth = Pipe<V>::kDepth, kXDepth = Pipe<V>::kXDepth;
  __shared__ int routed[kMaxExperts], skipped[kMaxExperts];
  __shared__ int n_routed;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int M = a.M, K = a.K, N = a.N, G = a.group, bk = a.bk, E = a.E;

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

  // Two load cursors walk this warp's steps in the order they are used
  // (units, clusters, steps): the weights' and scales' kDepth steps ahead of
  // the products, x's kXDepth.
  constexpr int kElem = P::kDec == kInt8 ? 1 : 4;  // bytes of a packed element
  const int spc = G / kSK, clusters = K / G, spu = K / kSK;  // steps a cluster, clusters and steps a unit
  const size_t row_bytes = static_cast<size_t>(N) * kElem, step_bytes = (kSK / P::kWordK) * row_bytes;
  const size_t w_expert = static_cast<size_t>(K / P::kWordK) * row_bytes;
  int lu = u0, lc = 0, ls = 0;  // the weights' cursor: unit, cluster, step in the cluster
  bool lok = false;
  const unsigned char* lw = nullptr;  // the lane's first weight row of the next step
  const int8_t* lsm = nullptr;
  auto seek_w = [&]() {
    const size_t e = routed[lu / strips];
    const int col = (lu % strips) * kStrip + 4 * g;
    lok = col < N;
    const int row = P::kDec == kInt8 ? (kSK / 4) * t : t / P::kShare;
    lw = static_cast<const unsigned char*>(a.w) + e * w_expert + row * row_bytes + static_cast<size_t>(col) * kElem;
    lsm = a.sm + e * clusters * N + col;
  };
  auto next_w = [&](uint4 (&w)[kNW], unsigned& sc) {  // the next step's weights (and, at a cluster's first, scales)
    if (lu >= u1) return;
    if constexpr (P::kDec == kInt8) {  // 4 bytes (the lane's 4 columns) of each of its kSK / 4 k-rows
      unsigned r[kSK / 4];
#pragma unroll
      for (int i = 0; i < kSK / 4; ++i) r[i] = lok ? __ldg(reinterpret_cast<const unsigned*>(lw + i * row_bytes)) : 0u;
#pragma unroll
      for (int j = 0; j < kNW; ++j) w[j] = make_uint4(r[4 * j], r[4 * j + 1], r[4 * j + 2], r[4 * j + 3]);
    } else {
      w[0] = lok ? __ldg(reinterpret_cast<const uint4*>(lw)) : make_uint4(0, 0, 0, 0);  // the lane's 4 columns' words
    }
    if (ls == 0) sc = lok ? __ldg(reinterpret_cast<const unsigned*>(lsm)) : 0u;
    lw += step_bytes;
    if (++ls == spc) {
      ls = 0;
      lsm += N;
      if (++lc == clusters) {
        lc = 0;
        if (++lu < u1) seek_w();
      }
    }
  };
  int xu = u0, xs = 0;  // x's cursor: unit, step in the unit
  const int8_t* lx = nullptr;
  auto seek_x = [&]() { lx = a.x + (static_cast<size_t>(routed[xu / strips]) * M + min(g, M - 1)) * K + XLane<V>::offset(t); };
  auto next_x = [&](uint32_t (&raw)[kXB / 4]) {
    if (xu >= u1) return;
    load_x<kXB>(lx, g < M, raw);
    lx += kSK;
    if (++xs == spu) {
      xs = 0;
      if (++xu < u1) seek_x();
    }
  };
  uint4 wb[kDepth][kNW];
  unsigned sb[kDepth];
  uint32_t xb[kXDepth][kXB / 4];
  if (u0 < u1) seek_w(), seek_x();
#pragma unroll
  for (int j = 0; j < kDepth; ++j) next_w(wb[j], sb[j]);
#pragma unroll
  for (int j = 0; j < kXDepth; ++j) next_x(xb[j]);

  // The skipped experts' out blocks: +0, grid-strided in 16-byte stores.
  const long long per4 = static_cast<long long>(M) * N / 4, zeros = (E - R) * per4;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + tid; i < zeros;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long e = skipped[i / per4];
    reinterpret_cast<float4*>(a.out + e * M * N)[i % per4] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  // The products, step by step: per cluster an int32 dot from the magic
  // number, closed into the k-tile's sum from 0; the tiles in order into the
  // run from 0; a unit's run stored at its end.
  const int total = (u1 - u0) * spu;
  int u = u0, st = 0, cl = 0, k0 = 0, ncl = min(bk, K) / G;
  int c[2][4];
  float acc[2][4], run[2][4];
  unsigned smc = 0;
#pragma unroll
  for (int jp = 0; jp < 2; ++jp)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jp][e] = 0.0f, run[jp][e] = 0.0f;
  for (int q0 = 0; q0 < total; q0 += kDepth) {
#pragma unroll
    for (int j = 0; j < kDepth; ++j) {
      if (q0 + j >= total) break;
      uint4 w4[kNW];
#pragma unroll
      for (int i = 0; i < kNW; ++i) w4[i] = wb[j][i];
      uint32_t raw[kXB / 4];
#pragma unroll
      for (int i = 0; i < kXB / 4; ++i) raw[i] = xb[j % kXDepth][i];
      if (st == 0) {
        smc = sb[j];
#pragma unroll
        for (int jp = 0; jp < 2; ++jp)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[jp][e] = kMagicBits;
      }
      next_w(wb[j], sb[j]);  // step q + kDepth into the registers just read
      next_x(xb[j % kXDepth]);
      uint32_t X[kRegs];
      x_regs<V>(raw, t, X);
      uint32_t A[4][kRegs];
      decode<V>(w4, t, a.lut, A);
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
      if (++st < spc) continue;
      // the cluster closes: RN(dot * sm) from the magic-number fragment, into the tile sum
      st = 0;
      float f[4], nf[4];
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        f[qq] = static_cast<float>(static_cast<int8_t>(smc >> (8 * qq)));
        if constexpr (P::kDec == kInt4) f[qq] = __fmul_rn(f[qq], 0.0625f);  // the dot is 16 x the fields
        nf[qq] = __fmul_rn(-kMagic, f[qq]);  // exact: f has at most 8 significant bits
      }
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qq = 2 * jp + (e >> 1);
          acc[jp][e] = __fadd_rn(acc[jp][e], __fmaf_rn(__int_as_float(c[jp][e]), f[qq], nf[qq]));
        }
      if (++cl < ncl) continue;
      // the k-tile closes (a ragged last one holds fewer clusters): into the run
      cl = 0;
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
#pragma unroll
        for (int e = 0; e < 4; ++e) run[jp][e] = __fadd_rn(run[jp][e], acc[jp][e]), acc[jp][e] = 0.0f;
      k0 += bk;
      if (k0 < K) {
        ncl = min(bk, K - k0) / G;
        continue;
      }
      // the unit closes: C element e of lane (g, t) is column 4g + 2jp + (e >> 1), row 2t + (e & 1)
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
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
#pragma unroll
        for (int e = 0; e < 4; ++e) run[jp][e] = 0.0f;
      ++u, k0 = 0, ncl = min(bk, K) / G;
    }
  }
}

template <int V>
cudaError_t launch_experts_v(const ExpertArgs& a, int grid, cudaStream_t stream) {
  expert_rows_kernel<<<dim3(a.P, a.E), kThreads, 0, stream>>>(a.x, const_cast<int*>(a.flags), a.M * a.K / 16, a.P);
  expert_gemv_kernel<V><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// The expert-batched GEMV: the scan of x's rows, then the GEMV over the
// routed experts, on `grid` persistent blocks.
inline cudaError_t launch_experts(int decode, const ExpertArgs& a, int grid, cudaStream_t s) {
  if (a.E > kMaxExperts || a.M > kMaxRows || a.P < 1) return cudaErrorInvalidValue;
  switch (variant(decode, a.group)) {
    case kT64: return launch_experts_v<kT64>(a, grid, s);
    case kT32: return launch_experts_v<kT32>(a, grid, s);
    case kT16: return launch_experts_v<kT16>(a, grid, s);
    case kI4_32: return launch_experts_v<kI4_32>(a, grid, s);
    case kI4_16: return launch_experts_v<kI4_16>(a, grid, s);
    case kN4_32: return launch_experts_v<kN4_32>(a, grid, s);
    case kN4_16: return launch_experts_v<kN4_16>(a, grid, s);
    case kI8_32: return launch_experts_v<kI8_32>(a, grid, s);
    case kI8_16: return launch_experts_v<kI8_16>(a, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace gemv
}  // namespace qmm
