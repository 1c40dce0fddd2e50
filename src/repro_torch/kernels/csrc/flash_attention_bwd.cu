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
//   Three launches on the caller's stream:
//     1. delta: D (B, H, Sq) fp32 into the caller's workspace, a warp a row;
//     2. dK/dV: a CTA per (kv block of 64 keys, kv head, batch) walks the
//        query heads of its group and, for each, the q rows that see its
//        keys, IN ORDER, with dK and dV in registers: GQA's sum over the
//        group is serial, so there are no atomics and the result is the
//        same from run to run;
//     3. dQ: a CTA per (block of 64 q rows, head, batch) walks the keys its
//        rows see, with dQ in registers.
//   Blocks wholly past the causal frontier or outside the window are
//   skipped, as in the forward.
//
//   Bound on an H100 SXM: operations. The backward does 2.5x the forward's
//   QK^T and PV products (S and dP, then dV, dK and dQ; S recomputed once
//   more in the dQ pass): chatglm3-6b's training layer at B=4, S=4096,
//   H=32, hd=128, causal is ~2.75 TFLOP, 2.8 ms at the 989 TFLOP/s of the
//   bf16 tensor cores; its bytes (q, k, v, o, dO, dq, dk, dv, lse) take
//   0.2 ms at 3.35 TB/s.
//
//   bf16 (the training path): tensor cores, mma.sync m16n8k16 with fp32
//   accumulators and ldmatrix from padded bf16 tiles, as in the forward
//   (the helpers are flash_mma.cuh). 4 warps a CTA, each owning 16 rows:
//   16 keys in the dK/dV kernel, which takes 32 q rows a step (S^T and dP^T
//   with K and V as the A operands; P^T and dS^T stay in registers, whose
//   accumulator layout is the A layout of dV += P^T dO and dK += dS^T Q),
//   16 q rows in the dQ kernel, which takes 64 keys a step. P and dS are
//   rounded to bf16 for the second products (FlashAttention-2's choice);
//   exp by ex2.approx, as the forward. Loads are cp.async, not yet
//   pipelined: wgmma fed by TMA, and a ring of stages, are the redesign
//   (ROADMAP Queue 4). A first design ran bf16 on FMA kernels like these below:
//   111.0 ms a call at the main path's chatglm3-6b operands (12.4 TFLOP/s;
//   chip_smoke.py phase 20 on an NVIDIA H100 80GB HBM3, 700.00 W).
//
//   fp32 (the parity checks): FMAs from shared memory, 256 threads as 16 x
//   16, each thread a 4 x 4 block of a 64 x 64 score tile (S and dP in one
//   pass over hd) and a 4 x hd/16 block of its 64 x hd accumulators; tiles
//   padded by one float a row, so that the reads of one warp fall on
//   distinct banks or are broadcasts. TF32 could not meet fp32's tolerance.
//
// Allocates nothing, does not synchronize, and returns the first CUDA error
// of the three launches for the wrapper to raise on.

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
// bf16: tensor cores (mma.sync m16n8k16, fp32 accumulators)
// ------------------------------------------------------------------------- //
namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16 * kWarps;  // the keys of a dK/dV CTA, the q rows of a dQ CTA
constexpr int kBQ = 32;             // q rows a step of the dK/dV loop takes
constexpr int kBK = 64;             // keys a step of the dQ loop takes
constexpr float kLog2e = 1.4426950408889634f;

// a row of HD bf16 plus 16 bytes, as in the forward: the 8 row addresses of
// one ldmatrix fall on 8 distinct 16-byte bank groups
template <int HD>
__host__ __device__ constexpr int ld() { return HD + 8; }

// shared memory of either kernel: two tiles of kRows rows and two of 32
// (dK/dV) or 64 (dQ) rows, plus the dK/dV kernel's lse and D of its q rows
template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * ld<HD>() * (2 * kRows + 2 * (kBQ > kBK ? kBQ : kBK)) +
         sizeof(float) * 2 * kBQ;
}

// rows [row0, row0 + ROWS) of one head into a (ROWS, ld<HD>) tile, zeros past
// S and past hd. VEC: 16-byte cp.async (hd % 8 == 0, 16-byte aligned
// operands); else element copies. The caller commits, waits and syncs.
template <int HD, int ROWS, bool VEC>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, const __nv_bfloat16* base,
                                          int row0, int S, long long step, int hd) {
  if (VEC) {
    constexpr int kChunks = HD / 8;
    for (int e = threadIdx.x; e < ROWS * kChunks; e += kThreads) {
      const int r = e / kChunks;
      const int d = (e - r * kChunks) * 8;
      const int s = row0 + r;
      const bool ok = s < S && d < hd;
      const __nv_bfloat16* src = ok ? base + s * step + d : base;
      cp_async16(smem_addr(tile + r * ld<HD>() + d), src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * HD; e += kThreads) {
      const int r = e / HD;
      const int d = e - r * HD;
      const int s = row0 + r;
      tile[r * ld<HD>() + d] =
          (s < S && d < hd) ? base[s * step + d] : __float2bfloat16(0.f);
    }
  }
}

__device__ __forceinline__ bool visible(int qp, int key, int Sq, int Skv, int q_off,
                                        int causal, int has_window, int window) {
  const int pos = q_off + qp;
  bool ok = qp < Sq && key < Skv;
  if (causal) ok = ok && key <= pos;
  if (has_window) ok = ok && pos - key < window;
  return ok;
}

// dK, dV of one (block of 64 keys, kv head, batch). Each warp owns 16 keys:
// S^T = K Q^T and dP^T = V dO^T for them against 32 q rows at a time (K and
// V the A operands, Q and dO by ldmatrix as B), P^T = exp(S^T - lse) and
// dS^T = P^T (dP^T - D) in registers, whose accumulator layout is the A
// layout of dV += P^T dO and dK += dS^T Q (dO and Q by ldmatrix.trans).
// P and dS are rounded to bf16 for those products (FlashAttention-2's
// choice); every sum is fp32.
template <int HD, bool VEC>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Skv,
           int H, int K, int hd, float scale, int causal, int has_window, int window,
           int q_off) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = ld<HD>();
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kRows x LD
  __nv_bfloat16* sV = sK + kRows * LD;                              // kRows x LD
  __nv_bfloat16* sQ = sV + kRows * LD;                              // kBQ x LD
  __nv_bfloat16* sG = sQ + kBQ * LD;                                // kBQ x LD (dO)
  float* sL = reinterpret_cast<float*>(sG + kBQ * LD);              // lse * log2(e)
  float* sD = sL + kBQ;

  const int kv_lo = blockIdx.x * kRows;  // under causality the first blocks see most rows
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int kv_hi = min(kv_lo + kRows, Skv) - 1;
  const long long q_step = static_cast<long long>(H) * hd;
  const long long kv_step = static_cast<long long>(K) * hd;
  const long long kv_base = (static_cast<long long>(b) * Skv * K + kh) * hd;

  load_tile<HD, kRows, VEC>(sK, k + kv_base, kv_lo, Skv, kv_step, hd);
  load_tile<HD, kRows, VEC>(sV, v + kv_base, kv_lo, Skv, kv_step, hd);

  // the q steps whose rows can see a key of this block
  const int nq = (Sq + kBQ - 1) / kBQ;
  int iq_begin = 0, iq_end = nq;
  if (causal) {  // some row with q_off + i >= kv_lo
    const long long need = static_cast<long long>(kv_lo) - q_off - (kBQ - 1);
    if (need > 0)
      iq_begin = static_cast<int>(min((need + kBQ - 1) / kBQ, static_cast<long long>(nq)));
  }
  if (has_window) {  // some row with q_off + i - kv_hi < window
    const long long last = static_cast<long long>(window) + kv_hi - 1 - q_off;
    iq_end = last < 0 ? 0 : static_cast<int>(min(last / kBQ + 1, static_cast<long long>(nq)));
  }

  float dkacc[HD / 8][4], dvacc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkacc[i][e] = dvacc[i][e] = 0.f;
  const float scale_log2 = scale * kLog2e;
  const int key0 = kv_lo + warp * 16 + g;  // this lane's keys: key0 and key0 + 8

  // ldmatrix addresses: A rows of K and V, B (n = q) of Q and dO, and the
  // transposed B (k = q) of dO and Q
  const int a_off = (warp * 16 + (lane % 16)) * LD + (lane / 16) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
  const int bt_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;

  for (int hg = 0; hg < G; ++hg) {
    const int h = kh * G + hg;
    const long long q_base = (static_cast<long long>(b) * Sq * H + h) * hd;
    const long long stat = (static_cast<long long>(b) * H + h) * Sq;
    for (int iq = iq_begin; iq < iq_end; ++iq) {
      const int q_lo = iq * kBQ;
      __syncthreads();  // every warp is done with the previous step's Q, dO, lse, D
      load_tile<HD, kBQ, VEC>(sQ, q + q_base, q_lo, Sq, q_step, hd);
      load_tile<HD, kBQ, VEC>(sG, dout + q_base, q_lo, Sq, q_step, hd);
      cp_async_commit();
      for (int r = threadIdx.x; r < kBQ; r += kThreads) {
        const bool in = q_lo + r < Sq;
        sL[r] = in ? lse[stat + q_lo + r] * kLog2e : INFINITY;
        sD[r] = in ? delta[stat + q_lo + r] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      float s[kBQ / 8][4], dp[kBQ / 8][4];
#pragma unroll
      for (int i = 0; i < kBQ / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t ak[4], av[4];
        ldsm_x4(smem_addr(sK + a_off + kk * 16), ak[0], ak[1], ak[2], ak[3]);
        ldsm_x4(smem_addr(sV + a_off + kk * 16), av[0], av[1], av[2], av[3]);
#pragma unroll
        for (int np = 0; np < kBQ / 16; ++np) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(smem_addr(sQ + b_off + np * 16 * LD + kk * 16), b0, b1, b2, b3);
          mma(s[2 * np], ak, b0, b1);
          mma(s[2 * np + 1], ak, b2, b3);
          ldsm_x4(smem_addr(sG + b_off + np * 16 * LD + kk * 16), b0, b1, b2, b3);
          mma(dp[2 * np], av, b0, b1);
          mma(dp[2 * np + 1], av, b2, b3);
        }
      }
      // P^T = exp(S^T scale - lse) on the visible pairs, dS^T = P^T (dP^T - D)
#pragma unroll
      for (int nt = 0; nt < kBQ / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = nt * 8 + 2 * t + (e & 1);
          const bool ok = visible(q_lo + qi, key0 + (e / 2) * 8, Sq, Skv, q_off, causal,
                                  has_window, window);
          const float p = ok ? exp2_approx(fmaf(s[nt][e], scale_log2, -sL[qi])) : 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - sD[qi]);
        }
      // dV += P^T dO and dK += dS^T Q over the step's 32 q rows
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                                pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                                pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                                pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int dpi = 0; dpi < HD / 16; ++dpi) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_t(smem_addr(sG + bt_off + kk * 16 * LD + dpi * 16), b0, b1, b2, b3);
          mma(dvacc[2 * dpi], pa, b0, b1);
          mma(dvacc[2 * dpi + 1], pa, b2, b3);
          ldsm_x4_t(smem_addr(sQ + bt_off + kk * 16 * LD + dpi * 16), b0, b1, b2, b3);
          mma(dkacc[2 * dpi], da, b0, b1);
          mma(dkacc[2 * dpi + 1], da, b2, b3);
        }
      }
    }
  }

  cp_async_commit();  // a CTA with no step still has its K and V copies in flight
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + (e / 2) * 8;
      const int c = i * 8 + 2 * t + (e & 1);
      if (key < Skv && c < hd) {
        const long long at = kv_base + key * kv_step + c;
        dk[at] = __float2bfloat16(dkacc[i][e] * scale);
        dv[at] = __float2bfloat16(dvacc[i][e]);
      }
    }
}

// dQ of one (block of 64 q rows, head, batch). Each warp owns 16 rows: S =
// Q K^T and dP = dO V^T against 64 keys at a time, P and dS in registers
// (the A layout of dQ += dS K, K by ldmatrix.trans).
template <int HD, bool VEC>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H, int K, int hd, float scale,
          int causal, int has_window, int window, int q_off) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = ld<HD>();
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kRows x LD
  __nv_bfloat16* sG = sQ + kRows * LD;                              // kRows x LD (dO)
  __nv_bfloat16* sK = sG + kRows * LD;                              // kBK x LD
  __nv_bfloat16* sV = sK + kBK * LD;                                // kBK x LD

  const int nq = (Sq + kRows - 1) / kRows;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x);  // last (heaviest) first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = static_cast<int>(static_cast<long long>(h) * K / H);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int q_lo = iq * kRows;
  const int q_hi = min(q_lo + kRows, Sq) - 1;
  const long long q_step = static_cast<long long>(H) * hd;
  const long long kv_step = static_cast<long long>(K) * hd;
  const long long q_base = (static_cast<long long>(b) * Sq * H + h) * hd;
  const long long kv_base = (static_cast<long long>(b) * Skv * K + kh) * hd;
  const long long stat = (static_cast<long long>(b) * H + h) * Sq;

  load_tile<HD, kRows, VEC>(sQ, q + q_base, q_lo, Sq, q_step, hd);
  load_tile<HD, kRows, VEC>(sG, dout + q_base, q_lo, Sq, q_step, hd);
  const int row0 = q_lo + warp * 16 + g;  // this lane's rows: row0 and row0 + 8
  float l2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    l2[r] = row < Sq ? lse[stat + row] * kLog2e : INFINITY;
    dd[r] = row < Sq ? delta[stat + row] : 0.f;
  }

  const int n_kv = (Skv + kBK - 1) / kBK;
  const int j_end = causal ? min(n_kv, (q_off + q_hi) / kBK + 1) : n_kv;
  int j_begin = 0;
  if (has_window) {
    const long long first = static_cast<long long>(q_off) + q_lo - window + 1;
    if (first > 0) j_begin = static_cast<int>(min(first / kBK, static_cast<long long>(n_kv)));
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const float scale_log2 = scale * kLog2e;
  const int a_off = (warp * 16 + (lane % 16)) * LD + (lane / 16) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
  const int bt_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;

  for (int j = j_begin; j < j_end; ++j) {
    const int kv_lo = j * kBK;
    __syncthreads();  // every warp is done with the previous block's K and V
    load_tile<HD, kBK, VEC>(sK, k + kv_base, kv_lo, Skv, kv_step, hd);
    load_tile<HD, kBK, VEC>(sV, v + kv_base, kv_lo, Skv, kv_step, hd);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t aq[4], ag[4];
      ldsm_x4(smem_addr(sQ + a_off + kk * 16), aq[0], aq[1], aq[2], aq[3]);
      ldsm_x4(smem_addr(sG + a_off + kk * 16), ag[0], ag[1], ag[2], ag[3]);
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_addr(sK + b_off + np * 16 * LD + kk * 16), b0, b1, b2, b3);
        mma(s[2 * np], aq, b0, b1);
        mma(s[2 * np + 1], aq, b2, b3);
        ldsm_x4(smem_addr(sV + b_off + np * 16 * LD + kk * 16), b0, b1, b2, b3);
        mma(dp[2 * np], ag, b0, b1);
        mma(dp[2 * np + 1], ag, b2, b3);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const bool ok = visible(row0 + 8 * r, kv_lo + nt * 8 + 2 * t + (e & 1), Sq, Skv,
                                q_off, causal, has_window, window);
        const float p = ok ? exp2_approx(fmaf(s[nt][e], scale_log2, -l2[r])) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - dd[r]);
      }
    // dQ += dS K over the block's 64 keys
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int dpi = 0; dpi < HD / 16; ++dpi) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(smem_addr(sK + bt_off + kk * 16 * LD + dpi * 16), b0, b1, b2, b3);
        mma(acc[2 * dpi], da, b0, b1);
        mma(acc[2 * dpi + 1], da, b2, b3);
      }
    }
  }

  cp_async_commit();  // a CTA with no key block still has its Q and dO copies in flight
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + (e / 2) * 8;
      const int c = i * 8 + 2 * t + (e & 1);
      if (row < Sq && c < hd) dq[q_base + row * q_step + c] = __float2bfloat16(acc[i][e] * scale);
    }
}

template <int HD, bool VEC>
int launch_hd(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
              const float* lse, const __nv_bfloat16* dout, __nv_bfloat16* dq,
              __nv_bfloat16* dk, __nv_bfloat16* dv, const float* delta, int B, int Sq,
              int Skv, int H, int K, int hd, float scale, int causal, int has_window,
              int window, int q_off, cudaStream_t st) {
  constexpr int smem = static_cast<int>(smem_bytes<HD>());
  cudaError_t err = cudaFuncSetAttribute(dkv_kernel<HD, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_kernel<HD, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv((Skv + kRows - 1) / kRows, K, B);
  dkv_kernel<HD, VEC><<<grid_kv, kThreads, smem, st>>>(q, k, v, dout, lse, delta, dk, dv, Sq,
                                                      Skv, H, K, hd, scale, causal,
                                                      has_window, window, q_off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((Sq + kRows - 1) / kRows, H, B);
  dq_kernel<HD, VEC><<<grid_q, kThreads, smem, st>>>(q, k, v, dout, lse, delta, dq, Sq, Skv,
                                                    H, K, hd, scale, causal, has_window,
                                                    window, q_off);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0; }

template <bool VEC>
int launch_vec(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
               const float* lse, const __nv_bfloat16* dout, __nv_bfloat16* dq,
               __nv_bfloat16* dk, __nv_bfloat16* dv, const float* delta, int B, int Sq,
               int Skv, int H, int K, int hd, float scale, int causal, int has_window,
               int window, int q_off, cudaStream_t st) {
  if (hd <= 32)
    return launch_hd<32, VEC>(q, k, v, lse, dout, dq, dk, dv, delta, B, Sq, Skv, H, K, hd,
                              scale, causal, has_window, window, q_off, st);
  if (hd <= 64)
    return launch_hd<64, VEC>(q, k, v, lse, dout, dq, dk, dv, delta, B, Sq, Skv, H, K, hd,
                              scale, causal, has_window, window, q_off, st);
  return launch_hd<128, VEC>(q, k, v, lse, dout, dq, dk, dv, delta, B, Sq, Skv, H, K, hd,
                             scale, causal, has_window, window, q_off, st);
}

int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           const float* lse, const __nv_bfloat16* dout, __nv_bfloat16* dq, __nv_bfloat16* dk,
           __nv_bfloat16* dv, const float* delta, int B, int Sq, int Skv, int H, int K,
           int hd, float scale, int causal, int has_window, int window, int q_off,
           cudaStream_t st) {
  if (hd % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout))
    return launch_vec<true>(q, k, v, lse, dout, dq, dk, dv, delta, B, Sq, Skv, H, K, hd,
                            scale, causal, has_window, window, q_off, st);
  return launch_vec<false>(q, k, v, lse, dout, dq, dk, dv, delta, B, Sq, Skv, H, K, hd, scale,
                           causal, has_window, window, q_off, st);
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
// q row 0, as in the forward.
extern "C" int repro_flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                             const void* o, const float* lse, const void* dout,
                                             void* dq, void* dk, void* dv, float* delta, int B,
                                             int Sq, int Skv, int H, int K, int hd, int causal,
                                             int has_window, int window, int q_off,
                                             void* stream) {
  if (!valid_shape(B, Sq, Skv, H, K, hd, q_off)) return static_cast<int>(cudaErrorInvalidValue);
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
                                              float* delta, int B, int Sq, int Skv, int H,
                                              int K, int hd, int causal, int has_window,
                                              int window, int q_off, void* stream) {
  if (!valid_shape(B, Sq, Skv, H, K, hd, q_off)) return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_delta(static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta,
                               B, Sq, H, hd, st);
  if (err != 0) return err;
  return tc::launch(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), lse, static_cast<const bf16*>(dout),
                    static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), delta,
                    B, Sq, Skv, H, K, hd, softmax_scale(hd), causal, has_window, window, q_off,
                    st);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
