// Hand-written Hopper (sm_90a) backward of causal / sliding-window GQA flash
// attention. Plain C interface, loaded with ctypes
// (kernels/flash_attention.py: flash_attention_bwd); built by
// kernels/_build.py with nvcc, without fast-math or flush-to-zero.
//
// repro_flash_attention_bwd_{f32,bf16} replace the backward of the Pallas
//   kernel repro/kernels/flash_attention.py: flash_attention, which the
//   reference differentiates at repro/kernels/ops.py: _fa_bwd by recompute:
//   jax.vjp of the plain attention over q, k, v. Here, as there, nothing of
//   the forward but its output is kept: P is recomputed tile by tile from q,
//   k and the forward's per-row log-sum-exp (lse, flash_attention.cu), and
//   the (Sq, Skv) matrix never exists.
//   Inputs q (B, Sq, H, hd), k/v (B, Skv, K, hd), o and dO (B, Sq, H, hd),
//   all fp32 or all bf16, lse (B, H, Sq) fp32; outputs dq, dk, dv in the
//   operands' dtype. Query head h reads kv head h * K / H; query row i sits
//   at q_pos = q_off + i, key j at j; the forward's masks (kv_pos < Skv,
//   causal kv_pos <= q_pos, window q_pos - kv_pos < window) and its scale
//   1/sqrt(hd). With s = q.k * scale:
//     P = exp(s - lse),  D = rowsum(dO o O),
//     dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),
//     dQ = dS K * scale,  dK = dS^T Q * scale,
//   dK and dV summed over the H / K query heads of each kv head. Every sum
//   in fp32, the results rounded once to the operands' dtype.
//
//   Launches on the caller's stream:
//     1. delta: D (B, H, Sq) fp32 into the caller's workspace, a warp a row;
//     2. dK/dV: a CTA per (block of keys, kv head, batch; bf16: and split
//        of the GQA group), the first blocks (under causality the ones that
//        see the most rows) first;
//     3. (bf16, splits > 1) the sum of the splits' dK, dV;
//     4. dQ: a CTA per (block of q rows, head, batch), the last (the
//        heaviest under causality) first.
//   Blocks are 128 rows in bf16, 64 in fp32.
//   Blocks wholly past the causal frontier or outside the window are
//   skipped, as in the forward.
//
//   bf16 (the training path), Hopper's warpgroup products (wgmma, sm_90a):
//   - Split and sum order. The wrapper cuts each GQA group of G = H / K
//     query heads into `splits` parts (kernels/flash_attention.py:
//     bwd_splits: as few as give 2 CTAs per SM of 132, at most G; 1 for
//     MHA). Part i takes heads [i G / n, (i + 1) G / n); its CTA walks them
//     and, for each, the q rows that see its keys, in order, dK and dV in
//     fp32 registers. One part writes bf16 dK, dV; several write their fp32
//     sums to the caller's workspace (2 x splits x (B, Skv, K, hd)), and
//     fa_bwd_dkv_reduce adds them in part order and rounds once. No float
//     atomics: the result is the same bits from run to run.
//   - CTA shape. 384 threads: warpgroup 2 loads, warpgroups 0 and 1
//     compute (setmaxnreg: 40 and 232 registers a thread; ptxas compiles
//     the kernels at the launch bound's 168). Each computing warpgroup owns
//     64 keys (dK/dV) or 64 q rows (dQ); the CTA's K and V (or Q and dO) are
//     loaded once, 128-byte swizzled as wgmma reads them.
//   - Stages. One thread of the loading warpgroup streams each step's tiles
//     (dK/dV: 64 q rows of Q and dO; dQ: 64 keys of K and V) with TMA, a
//     64-column box a panel, into a ring of 4 stages under mbarriers (its
//     other threads copy the dK/dV step's lse and D with cp.async): a stage
//     is full once its bytes have landed, empty once the 8 computing warps
//     are done with it. The computing warpgroups share no barrier after the
//     start, so one's softmax runs beside the other's products. Operands
//     that TMA cannot address (hd % 8 != 0, not 16-byte aligned) are
//     stored element by element instead.
//   - wgmma tiles (m64 n k16, fp32 accumulators), per warpgroup and step:
//     dK/dV: S^T = K Q^T and dP^T = V dO^T, m64n64 with both operands from
//     shared memory (K, V K-major A; Q, dO K-major B); then dV += P^T dO and
//     dK += dS^T Q, m64n(hd)k16 with A from registers (P^T and dS^T rounded
//     to bf16, FlashAttention-2's choice: their accumulator layout is the A
//     layout) and dO, Q read as MN-major B through the other descriptor of
//     the same tiles. dQ: S = Q K^T and dP = dO V^T, m64n64 from shared
//     memory (Q, dO K-major A; K, V K-major B); then dQ += dS K, m64n(hd)
//     with dS from registers and K MN-major. hd <= 64 runs as 64, hd <= 128
//     as 128, zero-padded in shared memory. exp by ex2.approx, as the
//     forward.
//   - What bounds it now: the chain inside a warpgroup's step. Each step
//     waits for its first products (S, dP), computes P and dS, and waits for
//     its second ones before the next step's first; only the other
//     warpgroup fills those waits. At chatglm3-6b's training layer (B=4,
//     S=4096, H=32, K=2, hd=128, causal) dK/dV takes 1.73 ms and dQ 1.38
//     (~640 and ~600 TFLOP/s of the products each computes); with only
//     their first products they took 1.11 and 0.57 ms, with only the
//     second ones and the softmax 1.22 and 0.94 (development runs recorded
//     in PERF.md). Queueing a step's first products before the previous step's
//     softmax needs a second set of accumulators (dK/dV has no registers
//     left for one) and made ptxas serialize the wgmma of dQ. The card's
//     bound for the work is operations: 2.5x the forward's products, 1.37
//     TFLOP, 1.39 ms at 989 TFLOP/s; this design computes 7 products where
//     that bound counts 5 (S and dP in both passes), so that dQ needs no
//     atomics.
//   - Earlier designs: a CTA per kv block walking the whole group on
//     mma.sync with unpipelined loads, 10.05 ms a call at those operands;
//     the split and warpgroups with cp.async loads, 4.10 ms (the loads cost
//     0.3-0.5 ms a pass); on FMAs, 111.0 ms (chip_smoke.py phase 20 and
//     development runs on an NVIDIA H100 80GB HBM3, 700.00 W).
//
//   fp32 (the parity checks): FMAs from shared memory, 256 threads as 16 x
//   16, each thread a 4 x 4 block of a 64 x 64 score tile (S and dP in one
//   pass over hd) and a 4 x hd/16 block of its 64 x hd accumulators; tiles
//   padded by one float a row, so that the reads of one warp fall on
//   distinct banks or are broadcasts. TF32 could not meet fp32's tolerance.
//
// Allocates nothing, does not synchronize, and returns the first CUDA error
// of its launches for the wrapper to raise on.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "flash_mma.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kB = 64;         // q rows of a q block, keys of a kv block
constexpr int kLdP = kB + 1;   // padded row of the 64 x 64 P and dS tiles
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// shared-memory floats of one CTA of either pass (HDP = hd padded to 16 * NJ)
constexpr size_t smem_floats(int hdp) {
  return static_cast<size_t>(4 * kB) * (hdp + 1)  // Q, dO, K, V
         + static_cast<size_t>(2 * kB) * kLdP      // P, dS
         + 2 * kB;                                 // lse, D of the q rows
}

// rows [row0, row0 + 64) of one head (positions step apart, hd wide) into a
// (64, HDP + 1) fp32 tile; zeros past S and past hd
template <int HDP>
__device__ __forceinline__ void load_rows(float* tile, const float* base, int row0, int S,
                                          long long step, int hd) {
  for (int e = threadIdx.x; e < kB * HDP; e += kThreads) {
    const int r = e / HDP;
    const int d = e - r * HDP;
    const int s = row0 + r;
    tile[r * (HDP + 1) + d] = (s < S && d < hd) ? base[s * step + d] : 0.f;
  }
}

// the q rows' lse and D: +inf and 0 past Sq (P = 0 there)
__device__ __forceinline__ void load_stats(float* lse_s, float* d_s, const float* lse,
                                           const float* delta, int q_lo, int Sq) {
  for (int r = threadIdx.x; r < kB; r += kThreads) {
    const bool in = q_lo + r < Sq;
    lse_s[r] = in ? lse[q_lo + r] : INFINITY;
    d_s[r] = in ? delta[q_lo + r] : 0.f;
  }
}

// S = Q K^T and dP = dO V^T for this thread's rows ty*4 + i and columns
// tx + 16 jj of the 64 x 64 tile, then P = exp(S * scale - lse) over the
// unmasked (q, key) pairs and dS = P (dP - D); P and dS land in shared
// memory, row-major
template <int HDP>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs, const float* Ks,
                                       const float* Vs, const float* lse_s, const float* d_s,
                                       float* Ps, float* dSs, int hd, float scale, int q_lo,
                                       int kv_lo, int Sq, int Skv, int q_off, int causal,
                                       int has_window, int window) {
  constexpr int LD = HDP + 1;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
  for (int d = 0; d < hd; ++d) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(ty * 4 + i) * LD + d];
      gv[i] = dOs[(ty * 4 + i) * LD + d];
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      kv[jj] = Ks[(tx + 16 * jj) * LD + d];
      vv[jj] = Vs[(tx + 16 * jj) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
        dp[i][jj] = fmaf(gv[i], vv[jj], dp[i][jj]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qp = q_lo + r;
    const int pos = q_off + qp;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = tx + 16 * jj;
      const int kp = kv_lo + c;
      bool ok = qp < Sq && kp < Skv;
      if (causal) ok = ok && kp <= pos;
      if (has_window) ok = ok && pos - kp < window;
      const float p = ok ? expf(s[i][jj] * scale - lse_s[r]) : 0.f;
      Ps[r * kLdP + c] = p;
      dSs[r * kLdP + c] = p * (dp[i][jj] - d_s[r]);
    }
  }
}

// 1. D = rowsum(dO o O): a warp per (b, i, h) row, written at (b, h, i)
template <typename T>
__global__ void __launch_bounds__(kThreads)
fa_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ delta, long long rows, int Sq, int H, int hd) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const T* ob = o + row * hd;
  const T* gb = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(to_f(ob[d]), to_f(gb[d]), acc);
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFullMask, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const long long bi = row / H;  // b * Sq + i
    const long long b = bi / Sq;
    const int i = static_cast<int>(bi - b * Sq);
    delta[(b * H + h) * Sq + i] = acc;
  }
}

// 2. dK, dV of one (kv block, kv head, batch), fp32
template <int NJ>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv,
                  int Sq, int Skv, int H, int K, int hd, float scale, int causal,
                  int has_window, int window, int q_off) {
  constexpr int HDP = 16 * NJ;
  constexpr int LD = HDP + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * LD;
  float* Ks = dOs + kB * LD;
  float* Vs = Ks + kB * LD;
  float* Ps = Vs + kB * LD;
  float* dSs = Ps + kB * kLdP;
  float* lse_s = dSs + kB * kLdP;
  float* d_s = lse_s + kB;

  const int jb = blockIdx.x;  // the kv block; under causality the first ones see most rows
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int kv_lo = jb * kB;
  const int kv_hi = min(kv_lo + kB, Skv) - 1;
  const long long q_step = static_cast<long long>(H) * hd;
  const long long kv_step = static_cast<long long>(K) * hd;
  const long long kv_base = (static_cast<long long>(b) * Skv * K + kh) * hd;

  load_rows<HDP>(Ks, k + kv_base, kv_lo, Skv, kv_step, hd);
  load_rows<HDP>(Vs, v + kv_base, kv_lo, Skv, kv_step, hd);

  // the q blocks whose rows can see a key of this block
  const int nq = (Sq + kB - 1) / kB;
  int iq_begin = 0, iq_end = nq;
  if (causal) {  // some row with q_off + i >= kv_lo
    const long long need = static_cast<long long>(kv_lo) - q_off - (kB - 1);
    if (need > 0)
      iq_begin = static_cast<int>(min((need + kB - 1) / kB, static_cast<long long>(nq)));
  }
  if (has_window) {  // some row with q_off + i - kv_hi < window
    const long long last = static_cast<long long>(window) + kv_hi - 1 - q_off;
    iq_end = last < 0 ? 0 : static_cast<int>(min(last / kB + 1, static_cast<long long>(nq)));
  }

  float dkacc[4][NJ], dvacc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dkacc[i][jj] = dvacc[i][jj] = 0.f;

  for (int hg = 0; hg < G; ++hg) {
    const int h = kh * G + hg;
    const long long q_base = (static_cast<long long>(b) * Sq * H + h) * hd;
    const float* lse_h = lse + (static_cast<long long>(b) * H + h) * Sq;
    const float* d_h = delta + (static_cast<long long>(b) * H + h) * Sq;
    for (int iq = iq_begin; iq < iq_end; ++iq) {
      const int q_lo = iq * kB;
      __syncthreads();  // the previous tile's readers of Qs, dOs, Ps, dSs are done
      load_rows<HDP>(Qs, q + q_base, q_lo, Sq, q_step, hd);
      load_rows<HDP>(dOs, dout + q_base, q_lo, Sq, q_step, hd);
      load_stats(lse_s, d_s, lse_h, d_h, q_lo, Sq);
      __syncthreads();
      scores<HDP>(Qs, dOs, Ks, Vs, lse_s, d_s, Ps, dSs, hd, scale, q_lo, kv_lo, Sq, Skv,
                  q_off, causal, has_window, window);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q over the tile's 64 q rows, in order
      for (int r = 0; r < kB; ++r) {
        float pv[4], sv[4], gv[NJ], qv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[r * kLdP + ty * 4 + i];
          sv[i] = dSs[r * kLdP + ty * 4 + i];
        }
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          gv[jj] = dOs[r * LD + tx + 16 * jj];
          qv[jj] = Qs[r * LD + tx + 16 * jj];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
            dvacc[i][jj] = fmaf(pv[i], gv[jj], dvacc[i][jj]);
            dkacc[i][jj] = fmaf(sv[i], qv[jj], dkacc[i][jj]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = kv_lo + ty * 4 + i;
    if (key >= Skv) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < hd) {
        const long long at = kv_base + key * kv_step + d;
        dk[at] = dkacc[i][jj] * scale;
        dv[at] = dvacc[i][jj];
      }
    }
  }
}

// 3. dQ of one (q block, head, batch), fp32
template <int NJ>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, int Sq, int Skv, int H,
                 int K, int hd, float scale, int causal, int has_window, int window,
                 int q_off) {
  constexpr int HDP = 16 * NJ;
  constexpr int LD = HDP + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * LD;
  float* Ks = dOs + kB * LD;
  float* Vs = Ks + kB * LD;
  float* Ps = Vs + kB * LD;
  float* dSs = Ps + kB * kLdP;
  float* lse_s = dSs + kB * kLdP;
  float* d_s = lse_s + kB;

  const int nq = (Sq + kB - 1) / kB;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x);  // last (heaviest) first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = static_cast<int>(static_cast<long long>(h) * K / H);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q_lo = iq * kB;
  const int q_hi = min(q_lo + kB, Sq) - 1;
  const long long q_step = static_cast<long long>(H) * hd;
  const long long kv_step = static_cast<long long>(K) * hd;
  const long long q_base = (static_cast<long long>(b) * Sq * H + h) * hd;
  const long long kv_base = (static_cast<long long>(b) * Skv * K + kh) * hd;
  const long long stat_base = (static_cast<long long>(b) * H + h) * Sq;

  load_rows<HDP>(Qs, q + q_base, q_lo, Sq, q_step, hd);
  load_rows<HDP>(dOs, dout + q_base, q_lo, Sq, q_step, hd);
  load_stats(lse_s, d_s, lse + stat_base, delta + stat_base, q_lo, Sq);

  const int n_kv = (Skv + kB - 1) / kB;
  const int j_end = causal ? min(n_kv, (q_off + q_hi) / kB + 1) : n_kv;
  int j_begin = 0;
  if (has_window) {
    const long long first = static_cast<long long>(q_off) + q_lo - window + 1;
    if (first > 0) j_begin = static_cast<int>(min(first / kB, static_cast<long long>(n_kv)));
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;

  for (int j = j_begin; j < j_end; ++j) {
    const int kv_lo = j * kB;
    __syncthreads();  // the previous block's readers of Ks, Vs, dSs are done
    load_rows<HDP>(Ks, k + kv_base, kv_lo, Skv, kv_step, hd);
    load_rows<HDP>(Vs, v + kv_base, kv_lo, Skv, kv_step, hd);
    __syncthreads();
    scores<HDP>(Qs, dOs, Ks, Vs, lse_s, d_s, Ps, dSs, hd, scale, q_lo, kv_lo, Sq, Skv, q_off,
                causal, has_window, window);
    __syncthreads();
    // dQ += dS K over the block's 64 keys, in order
    for (int c = 0; c < kB; ++c) {
      float sv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty * 4 + i) * kLdP + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) kv[jj] = Ks[c * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = fmaf(sv[i], kv[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q_lo + ty * 4 + i;
    if (qp >= Sq) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < hd) dq[q_base + qp * q_step + d] = acc[i][jj] * scale;
    }
  }
}

// ------------------------------------------------------------------------- //
// bf16: Hopper warpgroup products (wgmma, fp32 accumulators)
// ------------------------------------------------------------------------- //
namespace tc {

constexpr int kConsumers = 2;             // warpgroups that run the products, 64 rows each
constexpr int kLoader = 128;              // the threads of the warpgroup that loads
constexpr int kThreads = 128 * kConsumers + kLoader;
constexpr int kRows = 64 * kConsumers;    // the keys of a dK/dV CTA, the q rows of a dQ CTA
constexpr int kStep = 64;                 // q rows a dK/dV step takes, keys a dQ step takes
constexpr int kStages = 4;                // the ring of step tiles in shared memory
constexpr int kLoaderRegs = 40;           // registers of a loading thread (setmaxnreg) ...
constexpr int kConsumerRegs = 232;        // ... and of a computing one: 2 x 128 x 232 +
                                          // 128 x 40 <= the SM's 65,536
constexpr float kLog2e = 1.4426950408889634f;

// A tile of ROWS rows by HD (64 or 128) bf16 columns as wgmma reads it: HD /
// 64 panels of ROWS rows of 128 bytes, each 1024-byte aligned and swizzled
// (sw128_desc). The byte offset of the 8 columns from 8 c of row r:
template <int ROWS>
__device__ __forceinline__ uint32_t sw_offset(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// a K-major operand: rows [r0, r0 + 64) (m) or the tile's rows (n) by
// columns [16 kk, 16 kk + 16) (k)
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int kk) {
  return sw128_desc(tile + (kk >> 2) * (ROWS * 128) + r0 * 128 + (kk & 3) * 32, 16, 1024);
}

// an MN-major operand: rows [16 kk, 16 kk + 16) (k) by every column (n)
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 16 * 128, ROWS * 128, 1024);
}

// rows [row0, row0 + ROWS) of one head (positions step apart) into a tile,
// zeros past S and past hd, by threads tid = 0 .. NT - 1. VEC: 16-byte
// cp.async (hd % 8 == 0, 16-byte aligned operands); else element stores.
template <int HD, int ROWS, bool VEC, int NT>
__device__ __forceinline__ void load_tile(unsigned char* tile, const __nv_bfloat16* base,
                                          int row0, int S, long long step, int hd, int tid) {
  if (VEC) {
    constexpr int kChunks = HD / 8;
    const uint32_t dst = smem_addr(tile);
    for (int e = tid; e < ROWS * kChunks; e += NT) {
      const int r = e / kChunks;
      const int c = e - r * kChunks;
      const int s = row0 + r;
      const bool ok = s < S && c * 8 < hd;
      cp_async16(dst + sw_offset<ROWS>(r, c), ok ? base + s * step + c * 8 : base, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < ROWS * HD; e += NT) {
      const int r = e / HD;
      const int d = e - r * HD;
      const int s = row0 + r;
      *reinterpret_cast<__nv_bfloat16*>(tile + sw_offset<ROWS>(r, d >> 3) + (d & 7) * 2) =
          (s < S && d < hd) ? base[s * step + d] : __float2bfloat16(0.f);
    }
  }
}

// lse and D of the kStep q rows from q_lo of one head, by the loading
// threads (zeros past Sq: those rows are masked)
template <bool VEC>
__device__ __forceinline__ void load_stats(float* dst, const float* lse, const float* delta,
                                           int q_lo, int Sq, int tid) {
  const int r = tid % kStep;
  const float* src = tid < kStep ? lse : delta;
  const bool ok = q_lo + r < Sq;
  if (VEC)
    cp_async4(smem_addr(dst + tid), ok ? src + q_lo + r : src, ok ? 4 : 0);
  else
    dst[tid] = ok ? src[q_lo + r] : 0.f;
}

__device__ __forceinline__ bool visible(int qp, int key, int Sq, int Skv, int q_off,
                                        int causal, int has_window, int window) {
  const int pos = q_off + qp;
  bool ok = qp < Sq && key < Skv;
  if (causal) ok = ok && key <= pos;
  if (has_window) ok = ok && pos - key < window;
  return ok;
}

// of the 64 q rows from q_lo and the 64 keys from k_lo: does some pair see
// each other (any), does every pair (no mask needed)
struct TileSight {
  bool any, all;
};

__device__ __forceinline__ TileSight tile_sight(int q_lo, int k_lo, int Sq, int Skv, int q_off,
                                                int causal, int has_window, int window) {
  if (q_lo >= Sq || k_lo >= Skv) return {false, false};
  const int q_hi = min(q_lo + 63, Sq - 1);
  const int k_hi = min(k_lo + 63, Skv - 1);
  bool any = true;
  if (causal) any = any && k_lo <= q_off + q_hi;
  if (has_window) any = any && q_off + q_lo - k_hi < window;
  bool all = q_lo + 63 < Sq && k_lo + 63 < Skv;
  if (causal) all = all && k_lo + 63 <= q_off + q_lo;
  if (has_window) all = all && q_off + q_lo + 63 - k_lo < window;
  return {any, any && all};
}

// this thread's warpgroup, read from lane 0 so that the compiler knows it
// to be the same across the warp: a branch on it is then not divergent, and
// the wgmma inside one is not serialized
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

// the A fragments of P or dS (64 x 64 accumulators, columns the next
// product's k) rounded to bf16 (FlashAttention-2's choice)
__device__ __forceinline__ void pack_a(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// d (64 x HD) += a (64 x 16, registers) . b (16 x HD, MN-major)
template <int HD>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[HD / 2], const uint32_t (&a)[4],
                                           uint64_t b) {
  if constexpr (HD == 128)
    wgmma_m64n128k16_rs_t(d, a, b);
  else
    wgmma_m64n64k16_rs_t(d, a, b);
}

// The ring of step tiles: stage i % kStages holds step i. full[s] completes
// once the stage's tiles have landed: with TMA, on the bytes of the stage's
// tile loads (one arrival sets them) and, in the dK/dV kernel, on the
// kLoader threads' copies of lse and D (cp.async, one arrival each); on the
// element path, on the kLoader threads' arrivals after their stores.
// empty[s] completes once the 8 computing warps are done with the stage.
// The phase parity of step i's use of a stage is (i / kStages) & 1. A
// computing warp waits for every step's stage, even one it skips, before it
// releases it: so none releases step i + kStages (the same stage) before
// every warp has released step i.
struct Ring {
  uint64_t full[kStages], empty[kStages];
};

__device__ __forceinline__ void ring_init(Ring* ring, int full_count) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&ring->full[s], full_count);
      mbar_init(&ring->empty[s], 4 * kConsumers);
    }
    fence_mbarrier_init();
  }
}

// the loading warpgroup: step i's tiles into stage i % kStages
// (load_step(i, stage, thread), which also arrives on full), once every
// computing warp is done with the step kStages before it
template <typename Load>
__device__ __forceinline__ void ring_fill(Ring* ring, int n_steps, Load load_step) {
  const int tid = threadIdx.x - 128 * kConsumers;
  for (int i = 0; i < n_steps; ++i) {
    const int st = i % kStages;
    if (i >= kStages) mbar_wait(&ring->empty[st], ((i / kStages) & 1) ^ 1);
    load_step(i, st, tid);
  }
  cp_async_wait<0>();  // no copy outlives its thread
}

// a computing warp is done with a step's stage
__device__ __forceinline__ void ring_release(Ring* ring, int st) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(&ring->empty[st]);
}

// the box of a step tile: 64 rows of one head by 64 columns (one panel of
// the 128-byte swizzle, as sw_offset lays it out)
template <int HD>
__device__ __forceinline__ void tma_tile(unsigned char* tile, const CUtensorMap* map, int head,
                                         int row0, int b, uint64_t* bar) {
#pragma unroll
  for (int p = 0; p < HD / 64; ++p)
    tma_load_4d(smem_addr(tile + p * kStep * 128), map, 64 * p, head, row0, b, bar);
}

// shared memory of the dK/dV kernel: K and V (kRows rows), then kStages
// stages of Q and dO (kStep rows), then the stages' lse and D, the ring's
// barriers, and the slack that aligns the tiles to 1024 bytes
template <int HD>
constexpr int dkv_smem() {
  return 1024 + 2 * kRows * HD * 2 + kStages * 2 * kStep * HD * 2 + kStages * 2 * kStep * 4 +
         static_cast<int>(sizeof(Ring));
}

// of the dQ kernel: Q and dO (kRows rows), then kStages stages of K and V
template <int HD>
constexpr int dq_smem() {
  return 1024 + 2 * kRows * HD * 2 + kStages * 2 * kStep * HD * 2 + static_cast<int>(sizeof(Ring));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// dK, dV of one (block of kRows keys, kv head, batch, split of the GQA
// group). Warp-specialized: warpgroup kConsumers loads each step's Q and dO
// tiles (and lse, D) into the ring; warpgroup w < kConsumers owns keys [64
// w, 64 w + 64) of the block and walks the split's query heads and, for
// each, the q steps that see the block, in order, dK and dV in registers. A
// step: S^T = K Q^T and dP^T = V dO^T (wgmma, K and V the A operands, Q and
// dO K-major B), P^T = exp(S^T - lse) and dS^T = P^T (dP^T - D) in
// registers, then dV += P^T dO and dK += dS^T Q (P^T and dS^T the register
// A operand, dO and Q MN-major B: the same tiles through the other
// descriptor). The two computing warpgroups share no barrier after the
// start, so one's softmax runs beside the other's products. One split
// writes bf16 dK (scaled) and dV; several write their fp32 sums into the
// workspace for fa_bwd_dkv_reduce.
template <int HD, bool TMA>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkv_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                 float* __restrict__ ws, int splits, int B, int Sq, int Skv, int H, int K, int hd,
                 float scale, int causal, int has_window, int window, int q_off,
                 const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kTile = kRows * HD * 2;      // bytes of K or V
  constexpr int kStepTile = kStep * HD * 2;  // bytes of a step's Q or dO
  unsigned char* sK = align1024(smem_raw);
  unsigned char* sV = sK + kTile;
  unsigned char* sSteps = sV + kTile;  // stage i: Q at 2 i kStepTile, dO after it
  float* sStats = reinterpret_cast<float*>(sSteps + kStages * 2 * kStepTile);  // lse, D
  Ring* ring = reinterpret_cast<Ring*>(sStats + kStages * 2 * kStep);

  // the block index: key block slowest, so that under causality the blocks
  // that see the most rows start first
  const int per_block = splits * K * B;
  const int jb = static_cast<int>(blockIdx.x) / per_block;
  int rest = static_cast<int>(blockIdx.x) - jb * per_block;
  const int split = rest % splits;
  rest /= splits;
  const int kh = rest % K;
  const int b = rest / K;
  const int G = H / K;
  const int h_begin = kh * G + split * G / splits;
  const int n_heads = kh * G + (split + 1) * G / splits - h_begin;

  const int kv_lo = jb * kRows;
  const long long q_step = static_cast<long long>(H) * hd;
  const long long kv_step = static_cast<long long>(K) * hd;
  const long long kv_base = (static_cast<long long>(b) * Skv * K + kh) * hd;

  // the q steps whose rows can see a key of this block
  const int kv_hi = min(kv_lo + kRows, Skv) - 1;
  const int nq = (Sq + kStep - 1) / kStep;
  int iq_begin = 0, iq_end = nq;
  if (causal) {  // some row with q_off + i >= kv_lo
    const long long need = static_cast<long long>(kv_lo) - q_off - (kStep - 1);
    if (need > 0)
      iq_begin = static_cast<int>(min((need + kStep - 1) / kStep, static_cast<long long>(nq)));
  }
  if (has_window) {  // some row with q_off + i - kv_hi < window
    const long long last = static_cast<long long>(window) + kv_hi - 1 - q_off;
    iq_end = last < 0 ? 0 : static_cast<int>(min(last / kStep + 1, static_cast<long long>(nq)));
  }
  const int n_iq = max(iq_end - iq_begin, 0);
  const int n_steps = n_heads * n_iq;

  ring_init(ring, TMA ? 1 + kLoader : kLoader);
  load_tile<HD, kRows, TMA, kThreads>(sK, k + kv_base, kv_lo, Skv, kv_step, hd, threadIdx.x);
  load_tile<HD, kRows, TMA, kThreads>(sV, v + kv_base, kv_lo, Skv, kv_step, hd, threadIdx.x);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();  // K, V and the ring's barriers are ready; the last CTA-wide barrier

  const int wg = warpgroup();
  if (wg == kConsumers) {
    regs_lower<kLoaderRegs>();
    ring_fill(ring, n_steps, [&](int i, int st, int tid) {
      const int h = h_begin + i / n_iq;
      const int q_lo = (iq_begin + i % n_iq) * kStep;
      const long long q_base = (static_cast<long long>(b) * Sq * H + h) * hd;
      const long long stat = (static_cast<long long>(b) * H + h) * Sq;
      unsigned char* tiles = sSteps + st * 2 * kStepTile;
      if (TMA) {
        if (tid == 0) {
          mbar_arrive_expect_tx(&ring->full[st], 2 * kStepTile);
          tma_tile<HD>(tiles, &tm_q, h, q_lo, b, &ring->full[st]);
          tma_tile<HD>(tiles + kStepTile, &tm_g, h, q_lo, b, &ring->full[st]);
        }
        load_stats<true>(sStats + st * 2 * kStep, lse + stat, delta + stat, q_lo, Sq, tid);
        cp_async_mbar_arrive(&ring->full[st]);
      } else {
        load_tile<HD, kStep, false, kLoader>(tiles, q + q_base, q_lo, Sq, q_step, hd, tid);
        load_tile<HD, kStep, false, kLoader>(tiles + kStepTile, dout + q_base, q_lo, Sq, q_step,
                                             hd, tid);
        load_stats<false>(sStats + st * 2 * kStep, lse + stat, delta + stat, q_lo, Sq, tid);
        fence_proxy_async();
        mbar_arrive(&ring->full[st]);
      }
    });
    return;
  }
  regs_raise<kConsumerRegs>();

  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int k_lo = kv_lo + 64 * wg;          // this warpgroup's keys
  const int key0 = k_lo + 16 * warp + g;     // this lane's: key0 and key0 + 8
  const float scale_log2 = scale * kLog2e;
  const uint32_t aK = smem_addr(sK), aV = smem_addr(sV);

  float dkacc[HD / 2], dvacc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dkacc[i] = dvacc[i] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    const int st = i % kStages;
    const int q_lo = (iq_begin + i % n_iq) * kStep;
    const TileSight sight = tile_sight(q_lo, k_lo, Sq, Skv, q_off, causal, has_window, window);
    mbar_wait(&ring->full[st], (i / kStages) & 1);  // also when skipping: see Ring
    if (sight.any) {
      fence_proxy_async();
      const uint32_t aQ = smem_addr(sSteps + st * 2 * kStepTile);
      const uint32_t aG = aQ + kStepTile;
      const float* sL = sStats + st * 2 * kStep;
      const float* sD = sL + kStep;

      // S^T = K Q^T, then dP^T = V dO^T
      float s[32], dp[32];  // set by the first product of each sum
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_m64n64k16_ss(s, desc_k<kRows>(aK, 64 * wg, kk), desc_k<kStep>(aQ, 0, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_m64n64k16_ss(dp, desc_k<kRows>(aV, 64 * wg, kk), desc_k<kStep>(aG, 0, kk), kk);
      wgmma_commit();

      // P^T = exp(S^T scale - lse) on the visible pairs while dP^T runs
      wgmma_wait<1>();
      wgmma_hold(s);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 l = *reinterpret_cast<const float2*>(sL + nt * 8 + 2 * t);
        const float l2[2] = {l.x * kLog2e, l.y * kLog2e};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * nt + e] = exp2_approx(fmaf(s[4 * nt + e], scale_log2, -l2[e & 1]));
      }
      if (!sight.all) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!visible(q_lo + nt * 8 + 2 * t + (e & 1), key0 + (e / 2) * 8, Sq, Skv, q_off,
                         causal, has_window, window))
              s[4 * nt + e] = 0.f;
      }
      // dS^T = P^T (dP^T - D)
      wgmma_wait<0>();
      wgmma_hold(dp);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 d = *reinterpret_cast<const float2*>(sD + nt * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * nt + e] = s[4 * nt + e] * (dp[4 * nt + e] - ((e & 1) ? d.y : d.x));
      }
      uint32_t pa[4][4], da[4][4];
      pack_a(s, pa);
      pack_a(dp, da);

      // dV += P^T dO and dK += dS^T Q over the step's 64 q rows
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk)
        wgmma_rs_t<HD>(dvacc, pa[kk], desc_mn<kStep>(aG, kk));
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk)
        wgmma_rs_t<HD>(dkacc, da[kk], desc_mn<kStep>(aQ, kk));
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_hold(dvacc);
      wgmma_hold(dkacc);
      wgmma_hold(pa);
      wgmma_hold(da);
    }
    ring_release(ring, st);
  }

  const long long n = static_cast<long long>(B) * Skv * K * hd;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int key = key0 + (e / 2) * 8;
      const int c = i * 8 + 2 * t;
      if (key >= Skv || c >= hd) continue;
      const long long at = kv_base + key * kv_step + c;
      const bool pair = c + 1 < hd;
      if (splits == 1) {
        dk[at] = __float2bfloat16(dkacc[4 * i + e] * scale);
        dv[at] = __float2bfloat16(dvacc[4 * i + e]);
        if (pair) {
          dk[at + 1] = __float2bfloat16(dkacc[4 * i + e + 1] * scale);
          dv[at + 1] = __float2bfloat16(dvacc[4 * i + e + 1]);
        }
      } else {
        float* wk = ws + split * n + at;
        float* wv = ws + (splits + split) * n + at;
        wk[0] = dkacc[4 * i + e];
        wv[0] = dvacc[4 * i + e];
        if (pair) {
          wk[1] = dkacc[4 * i + e + 1];
          wv[1] = dvacc[4 * i + e + 1];
        }
      }
    }
}

// dK = (sum over the splits, in split order) x scale, dV = the sum; each
// rounded once to bf16. ws: 2 x splits x n fp32, the dK sums then dV's
__global__ void __launch_bounds__(256)
fa_bwd_dkv_reduce(const float* __restrict__ ws, __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, long long n, int splits, float scale) {
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float a = ws[e], c = ws[splits * n + e];
    for (int s = 1; s < splits; ++s) {
      a += ws[s * n + e];
      c += ws[(splits + s) * n + e];
    }
    dk[e] = __float2bfloat16(a * scale);
    dv[e] = __float2bfloat16(c);
  }
}

// dQ of one (block of kRows q rows, head, batch), warp-specialized as the
// dK/dV kernel: warpgroup kConsumers loads each step's K and V tiles;
// warpgroup w < kConsumers owns rows [64 w, 64 w + 64) and walks the keys
// they see, kStep a step, dQ in registers: S = Q K^T and dP = dO V^T (Q and
// dO the A operands, K and V K-major B), P and dS in registers, then dQ +=
// dS K (K MN-major).
template <int HD, bool TMA>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, int B, int Sq, int Skv, int H, int K, int hd,
                float scale, int causal, int has_window, int window, int q_off,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kTile = kRows * HD * 2;      // bytes of Q or dO
  constexpr int kStepTile = kStep * HD * 2;  // bytes of a step's K or V
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sG = sQ + kTile;
  unsigned char* sSteps = sG + kTile;  // stage i: K at 2 i kStepTile, V after it
  Ring* ring = reinterpret_cast<Ring*>(sSteps + kStages * 2 * kStepTile);

  const int nq = (Sq + kRows - 1) / kRows;
  const int per_block = H * B;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x) / per_block;  // last (heaviest) first
  const int rest = static_cast<int>(blockIdx.x) % per_block;
  const int h = rest % H;
  const int b = rest / H;
  const int kh = h / (H / K);
  const int q_lo = iq * kRows;
  const long long q_step = static_cast<long long>(H) * hd;
  const long long kv_step = static_cast<long long>(K) * hd;
  const long long q_base = (static_cast<long long>(b) * Sq * H + h) * hd;
  const long long kv_base = (static_cast<long long>(b) * Skv * K + kh) * hd;
  const long long stat = (static_cast<long long>(b) * H + h) * Sq;

  // the key steps its rows see
  const int q_hi = min(q_lo + kRows, Sq) - 1;
  const int n_kv = (Skv + kStep - 1) / kStep;
  const int j_end = causal ? min(n_kv, (q_off + q_hi) / kStep + 1) : n_kv;
  int j_begin = 0;
  if (has_window) {
    const long long first = static_cast<long long>(q_off) + q_lo - window + 1;
    if (first > 0) j_begin = static_cast<int>(min(first / kStep, static_cast<long long>(n_kv)));
  }
  const int n_steps = max(j_end - j_begin, 0);

  ring_init(ring, TMA ? 1 : kLoader);
  load_tile<HD, kRows, TMA, kThreads>(sQ, q + q_base, q_lo, Sq, q_step, hd, threadIdx.x);
  load_tile<HD, kRows, TMA, kThreads>(sG, dout + q_base, q_lo, Sq, q_step, hd, threadIdx.x);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  const int wg = warpgroup();
  if (wg == kConsumers) {
    regs_lower<kLoaderRegs>();
    ring_fill(ring, n_steps, [&](int i, int st, int tid) {
      const int kv_lo = (j_begin + i) * kStep;
      unsigned char* tiles = sSteps + st * 2 * kStepTile;
      if (TMA) {
        if (tid == 0) {
          mbar_arrive_expect_tx(&ring->full[st], 2 * kStepTile);
          tma_tile<HD>(tiles, &tm_k, kh, kv_lo, b, &ring->full[st]);
          tma_tile<HD>(tiles + kStepTile, &tm_v, kh, kv_lo, b, &ring->full[st]);
        }
      } else {
        load_tile<HD, kStep, false, kLoader>(tiles, k + kv_base, kv_lo, Skv, kv_step, hd, tid);
        load_tile<HD, kStep, false, kLoader>(tiles + kStepTile, v + kv_base, kv_lo, Skv, kv_step,
                                             hd, tid);
        fence_proxy_async();
        mbar_arrive(&ring->full[st]);
      }
    });
    return;
  }
  regs_raise<kConsumerRegs>();

  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int w_lo = q_lo + 64 * wg;          // this warpgroup's rows
  const int row0 = w_lo + 16 * warp + g;    // this lane's: row0 and row0 + 8
  float l2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    l2[r] = row < Sq ? lse[stat + row] * kLog2e : INFINITY;
    dd[r] = row < Sq ? delta[stat + row] : 0.f;
  }
  const float scale_log2 = scale * kLog2e;
  const uint32_t aQ = smem_addr(sQ), aG = smem_addr(sG);

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    const int st = i % kStages;
    const int kv_lo = (j_begin + i) * kStep;
    const TileSight sight = tile_sight(w_lo, kv_lo, Sq, Skv, q_off, causal, has_window, window);
    mbar_wait(&ring->full[st], (i / kStages) & 1);  // also when skipping: see Ring
    if (sight.any) {
      fence_proxy_async();
      const uint32_t aK = smem_addr(sSteps + st * 2 * kStepTile);
      const uint32_t aV = aK + kStepTile;

      float s[32], dp[32];  // set by the first product of each sum
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_m64n64k16_ss(s, desc_k<kRows>(aQ, 64 * wg, kk), desc_k<kStep>(aK, 0, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_m64n64k16_ss(dp, desc_k<kRows>(aG, 64 * wg, kk), desc_k<kStep>(aV, 0, kk), kk);
      wgmma_commit();

      wgmma_wait<1>();
      wgmma_hold(s);
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = exp2_approx(fmaf(s[j], scale_log2, -l2[(j / 2) & 1]));
      if (!sight.all) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!visible(row0 + 8 * (e / 2), kv_lo + nt * 8 + 2 * t + (e & 1), Sq, Skv, q_off,
                         causal, has_window, window))
              s[4 * nt + e] = 0.f;
      }
      wgmma_wait<0>();
      wgmma_hold(dp);
#pragma unroll
      for (int j = 0; j < 32; ++j) dp[j] = s[j] * (dp[j] - dd[(j / 2) & 1]);
      uint32_t da[4][4];
      pack_a(dp, da);

      // dQ += dS K over the step's 64 keys
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk) wgmma_rs_t<HD>(acc, da[kk], desc_mn<kStep>(aK, kk));
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_hold(acc);
      wgmma_hold(da);
    }
    ring_release(ring, st);
  }

#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + (e / 2) * 8;
      const int c = i * 8 + 2 * t + (e & 1);
      if (row < Sq && c < hd)
        dq[q_base + row * q_step + c] = __float2bfloat16(acc[4 * i + e] * scale);
    }
}

// cuTensorMapEncodeTiled, fetched through the runtime's entry-point query
// (the library links no libcuda); null where it is missing
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// the tensor map of a (B, S, heads, hd) bf16 operand whose box is a step
// tile's panel: 64 columns of hd by 1 head by kStep positions by 1 batch,
// 128-byte swizzled, zeros past its ends
bool step_tile_map(CUtensorMap* map, const __nv_bfloat16* base, int B, int S, int heads,
                   int hd) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * hd, 2ull * hd * heads, 2ull * hd * heads * S};
  const cuuint32_t box[4] = {64, 1, kStep, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<__nv_bfloat16*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool TMA>
int launch_hd(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
              const float* lse, const __nv_bfloat16* dout, __nv_bfloat16* dq,
              __nv_bfloat16* dk, __nv_bfloat16* dv, const float* delta, float* ws, int splits,
              int B, int Sq, int Skv, int H, int K, int hd, float scale, int causal,
              int has_window, int window, int q_off, const CUtensorMap* maps,
              cudaStream_t st) {
  constexpr int smem_kv = dkv_smem<HD>();
  constexpr int smem_q = dq_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(fa_bwd_dkv_wgmma<HD, TMA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fa_bwd_dq_wgmma<HD, TMA>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid_kv = static_cast<long long>((Skv + kRows - 1) / kRows) * splits * K * B;
  const long long grid_q = static_cast<long long>((Sq + kRows - 1) / kRows) * H * B;
  if (grid_kv > 0x7fffffffLL || grid_q > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  fa_bwd_dkv_wgmma<HD, TMA><<<static_cast<unsigned>(grid_kv), kThreads, smem_kv, st>>>(
      q, k, v, dout, lse, delta, dk, dv, ws, splits, B, Sq, Skv, H, K, hd, scale, causal,
      has_window, window, q_off, maps[0], maps[1]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const long long n = static_cast<long long>(B) * Skv * K * hd;
    const long long blocks = (n + 255) / 256 < 132 * 16 ? (n + 255) / 256 : 132 * 16;
    fa_bwd_dkv_reduce<<<static_cast<unsigned>(blocks), 256, 0, st>>>(ws, dk, dv, n, splits,
                                                                      scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fa_bwd_dq_wgmma<HD, TMA><<<static_cast<unsigned>(grid_q), kThreads, smem_q, st>>>(
      q, k, v, dout, lse, delta, dq, B, Sq, Skv, H, K, hd, scale, causal, has_window, window,
      q_off, maps[2], maps[3]);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0; }

template <bool TMA>
int launch_tma(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
               const float* lse, const __nv_bfloat16* dout, __nv_bfloat16* dq,
               __nv_bfloat16* dk, __nv_bfloat16* dv, const float* delta, float* ws, int splits,
               int B, int Sq, int Skv, int H, int K, int hd, float scale, int causal,
               int has_window, int window, int q_off, const CUtensorMap* maps,
               cudaStream_t st) {
  if (hd <= 64)
    return launch_hd<64, TMA>(q, k, v, lse, dout, dq, dk, dv, delta, ws, splits, B, Sq, Skv, H,
                              K, hd, scale, causal, has_window, window, q_off, maps, st);
  return launch_hd<128, TMA>(q, k, v, lse, dout, dq, dk, dv, delta, ws, splits, B, Sq, Skv, H,
                             K, hd, scale, causal, has_window, window, q_off, maps, st);
}

// TMA for operands it can address (hd % 8 == 0, 16-byte aligned: the maps'
// strides and bases), else element stores
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           const float* lse, const __nv_bfloat16* dout, __nv_bfloat16* dq, __nv_bfloat16* dk,
           __nv_bfloat16* dv, const float* delta, float* ws, int splits, int B, int Sq, int Skv,
           int H, int K, int hd, float scale, int causal, int has_window, int window, int q_off,
           cudaStream_t st) {
  CUtensorMap maps[4] = {};  // Q, dO (the dK/dV kernel's), K, V (the dQ kernel's)
  const bool tma = hd % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(dout) && step_tile_map(&maps[0], q, B, Sq, H, hd) &&
                   step_tile_map(&maps[1], dout, B, Sq, H, hd) &&
                   step_tile_map(&maps[2], k, B, Skv, K, hd) &&
                   step_tile_map(&maps[3], v, B, Skv, K, hd);
  if (tma)
    return launch_tma<true>(q, k, v, lse, dout, dq, dk, dv, delta, ws, splits, B, Sq, Skv, H, K,
                            hd, scale, causal, has_window, window, q_off, maps, st);
  return launch_tma<false>(q, k, v, lse, dout, dq, dk, dv, delta, ws, splits, B, Sq, Skv, H, K,
                           hd, scale, causal, has_window, window, q_off, maps, st);
}

}  // namespace tc

template <typename T>
int launch_delta(const T* o, const T* dout, float* delta, int B, int Sq, int H, int hd,
                 cudaStream_t st) {
  const long long rows = static_cast<long long>(B) * Sq * H;
  const long long warps = kThreads / 32;
  fa_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + warps - 1) / warps), kThreads, 0, st>>>(
      o, dout, delta, rows, Sq, H, hd);
  return static_cast<int>(cudaGetLastError());
}

template <int NJ>
int launch_fma(const float* q, const float* k, const float* v, const float* lse,
               const float* dout, float* dq, float* dk, float* dv, const float* delta, int B,
               int Sq, int Skv, int H, int K, int hd, float scale, int causal, int has_window,
               int window, int q_off, cudaStream_t st) {
  const int smem = static_cast<int>(sizeof(float) * smem_floats(16 * NJ));
  cudaError_t err = cudaFuncSetAttribute(fa_bwd_dkv_kernel<NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fa_bwd_dq_kernel<NJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv((Skv + kB - 1) / kB, K, B);
  fa_bwd_dkv_kernel<NJ><<<grid_kv, kThreads, smem, st>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Skv, H, K, hd, scale, causal, has_window, window,
      q_off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((Sq + kB - 1) / kB, H, B);
  fa_bwd_dq_kernel<NJ><<<grid_q, kThreads, smem, st>>>(
      q, k, v, dout, lse, delta, dq, Sq, Skv, H, K, hd, scale, causal, has_window, window,
      q_off);
  return static_cast<int>(cudaGetLastError());
}

// fp32: D, then dK/dV and dQ on FMAs
int launch_f32(const float* q, const float* k, const float* v, const float* o,
                   const float* lse, const float* dout, float* dq, float* dk, float* dv,
                   float* delta, int B, int Sq, int Skv, int H, int K, int hd, float scale,
                   int causal, int has_window, int window, int q_off, cudaStream_t st) {
  const int err = launch_delta(o, dout, delta, B, Sq, H, hd, st);
  if (err != 0) return err;
  if (hd <= 32)
    return launch_fma<2>(q, k, v, lse, dout, dq, dk, dv, delta, B, Sq, Skv, H, K, hd, scale,
                         causal, has_window, window, q_off, st);
  if (hd <= 64)
    return launch_fma<4>(q, k, v, lse, dout, dq, dk, dv, delta, B, Sq, Skv, H, K, hd, scale,
                         causal, has_window, window, q_off, st);
  return launch_fma<8>(q, k, v, lse, dout, dq, dk, dv, delta, B, Sq, Skv, H, K, hd, scale,
                       causal, has_window, window, q_off, st);
}

// 1/sqrt(hd) rounded once from double, as the forward's
float softmax_scale(int hd) { return static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd))); }

bool valid_shape(int B, int Sq, int Skv, int H, int K, int hd, int q_off) {
  return B > 0 && Sq > 0 && Skv > 0 && H > 0 && K > 0 && H % K == 0 && hd > 0 && hd <= 128 &&
         H <= 65535 && B <= 65535 && q_off >= 0 && q_off <= (1 << 30) - Sq;
}

}  // namespace

// delta: a (B, H, Sq) fp32 workspace of the caller's (D = rowsum(dO o O)).
// window is read only when has_window is non-zero; q_off is the position of
// q row 0, as in the forward. splits: the number of parts the bf16 dK/dV
// pass cuts each GQA group into (1 <= splits <= H / K); above 1, ws is a
// 2 x splits x (B, Skv, K, hd) fp32 workspace of the caller's for their
// sums. The fp32 kernels take no split (splits 1, ws unread).
extern "C" int repro_flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                             const void* o, const float* lse, const void* dout,
                                             void* dq, void* dk, void* dv, float* delta,
                                             float* ws, int B, int Sq, int Skv, int H, int K,
                                             int hd, int causal, int has_window, int window,
                                             int q_off, int splits, void* stream) {
  (void)ws;
  if (!valid_shape(B, Sq, Skv, H, K, hd, q_off) || splits != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<const float*>(o), lse,
                        static_cast<const float*>(dout), static_cast<float*>(dq),
                        static_cast<float*>(dk), static_cast<float*>(dv), delta, B, Sq, Skv, H,
                        K, hd, softmax_scale(hd), causal, has_window, window, q_off,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int repro_flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                              const void* o, const float* lse,
                                              const void* dout, void* dq, void* dk, void* dv,
                                              float* delta, float* ws, int B, int Sq, int Skv,
                                              int H, int K, int hd, int causal, int has_window,
                                              int window, int q_off, int splits, void* stream) {
  if (!valid_shape(B, Sq, Skv, H, K, hd, q_off) || splits < 1 || splits > H / K ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_delta(static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta,
                               B, Sq, H, hd, st);
  if (err != 0) return err;
  return tc::launch(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), lse, static_cast<const bf16*>(dout),
                    static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), delta,
                    ws, splits, B, Sq, Skv, H, K, hd, softmax_scale(hd), causal, has_window,
                    window, q_off, st);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
