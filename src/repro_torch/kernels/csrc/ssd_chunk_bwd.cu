// Hand-written Hopper (sm_90a) kernels of the backward of the Mamba2 / SSD
// chunked scan. Plain C interface, loaded with ctypes (kernels/ssd_chunk.py:
// ssd_chunk_scan_bwd); built by kernels/_build.py with nvcc, without
// fast-math or flush-to-zero.
//
// repro_ssd_chunk_scan_bwd_{bf16,f32} replace no TPU kernel: the Pallas
//   kernel repro/kernels/ssd_chunk.py: ssd_chunk_scan (pallas_call at :105)
//   is a serving-only forward with no custom_vjp, and the reference trains
//   its mamba layers by differentiating its pure-JAX chunk loop
//   (repro/models/mamba2.py: ssd_scan, :52). In the port the forward IS the
//   kernel (csrc/ssd_chunk.cu), so its training needs this backward: the
//   vector-Jacobian product of the forward, as kernels/ref.py:
//   ssd_chunk_scan_bwd_ref writes it out. Per chunk of Q positions, with
//   a = dt A, cum its inclusive prefix sum, total = cum[Q-1], h_in the
//   state entering the chunk and dh_out the cotangent of the state leaving
//   it, w_ij = exp(cum_i - cum_j) dt_j (i >= j), s_ij = (C_i . B_j) w_ij,
//   dS_ij = dy_i . x_j, M_ij = w_ij dS_ij and wj_j = exp(total - cum_j) dt_j:
//     dh_in = exp(total) dh_out + sum_i exp(cum_i) dy_i (x) C_i
//     dx_j  = sum_{i>=j} s_ij dy_i + wj_j dh_out B_j
//     dC_i  = sum_{j<=i} M_ij B_j + exp(cum_i) h_in^T dy_i
//     dB_j  = sum_{i>=j} M_ij C_i + wj_j dh_out^T x_j
//     ddt_j = sum_{i>=j} (C_i . B_j) exp(cum_i - cum_j) dS_ij
//             + exp(total - cum_j) u_j + A da_j,   u_j = x_j . dh_out B_j
//     dcum  = row sums of s o dS at i, less their column sums at j,
//             + exp(cum_i) dy_i . h_in C_i - wj_j u_j, and at Q-1
//             + sum_j wj_j u_j + exp(total) <dh_out, h_in>
//     da    = the reverse prefix sum of dcum within the chunk (fp64,
//             rounded once, as the forward's prefix sum),
//     dA    = sum over (b, t) of dt da.
//   The i >= j mask sits INSIDE the exp, as in the forward. A ragged S is
//   masked here (positions past S read as zero and are not written).
//   dB and dC sum over the heads of a group: M and the state terms are
//   per head, B and C are the group's, so dC = (sum_h M^h) B + ... and
//   dB = (sum_h M^h)^T C + ...
//
// Two routes, by x's dtype; no float atomics in either, every sum in a
// fixed order (two calls give the same bits).
//
// bf16 x (the training path): tensor cores, eight launches.
//   1. ssd_bwd_gram_kernel: G = C B^T once per (b, group, chunk), its
//      causal 64 x 64 tiles in fp32 FMAs (8.4 MFLOP a chunk at ds 128: the
//      tensor cores would not pay for a three-way split), stored as G^T in
//      the accumulator order of launch 4's mma tiles (a lane's 8 values of
//      a 16 x 16 tile in 32 contiguous bytes), and B and C copied beside it
//      in the fragment orders launches 2, 4 and 6 read with 16-byte loads
//      (the k index permuted within each 16-wide tile, as in
//      csrc/ssd_chunk.cu; the other operand takes the same permutation).
//      The workspace W, Qp (Qp + 3 DS) floats per (b, group, chunk) (42 MB
//      at mamba2-2.7b), is read from L2 by the heads of the group.
//   2. ssd_bwd_state_kernel: one CTA per (head, chunk, b). The chunk's
//      prefix sum (fp64, rounded once: the forward's scheme) goes to a
//      workspace with dt, for launches 4-6; the chunk's own state terms
//      x^T (B wj) and dy^T (C exp(cum)) are products on the tensor cores
//      into Hs and dHs (B, nh, nc, hd, ds).
//   3. ssd_bwd_walk: the state walk, shared with the fp32 route (one
//      thread per state element, both directions together, a thread's
//      loads of 8 chunks in flight at once).
//   4. ssd_bwd_chunk_kernel_tc: one CTA per (head, chunk, b), 8 warps;
//      warp w owns row tiles w and 15 - w of the chunk (equal causal work):
//      - q = dy h_in, then dcum_i = exp(cum_i) C_i . q_i;
//      - dh_out's terms: B dh_out^T into dx's accumulators, u, ddt, dcum;
//      - the (Q, Q) form per 16 x 16 tile, transposed (rows j, columns
//        i >= j): dS^T = x dy^T, s^T from G^T, the row and column sums of
//        s o dS (dcum) and of G o decay o dS (ddt), and dx += s^T dy with
//        s^T as the A fragment as it stands in the accumulators;
//      - the chunk's reverse prefix sum of dcum (fp64), ddt, and its share
//        of dA (fp64, per (b, chunk, head)).
//      Row sums stay with the warp that owns the row; column sums go to a
//      per-warp vector and are added in warp order. No dB or dC here.
//   5. ssd_bwd_gstate_kernel: dB's and dC's state terms, sum_h exp(cum_i)
//      (dy h_in)_i and sum_h wj_j (x dh_out)_j: one CTA per (product, b x
//      chunk x group) holds every row of the chunk in its warps' registers
//      and walks the group's heads in order, so each head's state is read
//      once; the head's rows, state and prefix come in through a 2-stage
//      cp.async ring (1 stage at hd = ds = 128). Writes dB and dC.
//   6. ssd_bwd_pair_kernel: the head-summed factor sum_h M^h, one causal
//      64 x 64 tile at a time: one CTA per (tile pair it >= jt, b x chunk x
//      group) walks the group's heads in order (2-stage ring of dy's rows
//      it, x's rows jt and the prefix), recomputing the tile's dS (one
//      exact product) and adding w o dS into registers, so each element of
//      the factor is formed once. Then the tile times B's rows jt (dC's
//      share for rows it) and, transposed through shared memory, times C's
//      rows it (dB's share for rows jt), into a workspace of one share per
//      tile pair: 2 x 64 x DS floats, 42 MB at mamba2, where the fp32
//      route keeps (B, S, nh, ds) per-head partials (2 x 671 MB).
//   7. ssd_bwd_pair_sum: dB and dC gain the tile pairs' shares, in tile
//      order, one thread per element.
//   8. ssd_bwd_dA: dA summed over (b, chunk) in that order, in fp64.
//   Products: mma.sync m16n8k16 bf16 with fp32 accumulators. x and dy are
//   exact in bf16; an fp32 operand is split hi + lo (bf16(v), bf16(v - hi):
//   16 bits of mantissa, ~2^-17 relative), or three ways where both sides
//   are fp32 (hi.hi + hi.lo + lo.hi). The split each product takes:
//     x dy^T (dS, launches 4, 6)        1 product  (both exact)
//     s^T dy (dx)                       2          (s split; dy exact)
//     x^T (B wj), dy^T (C e^cum)        2          (state terms; x, dy exact)
//     dy h_in (q, dC), x dh_out (dB)    2          (h_in / dh_out split)
//     B dh_out^T (dx, u)                3          (both fp32)
//     (sum_h M^h) B, (sum_h M^h)^T C    3          (both fp32)
//   The bar is bf16's: 1e-2 of the plain version's Frobenius norm per
//   output; each split product is within ~1e-5 of its fp32 value, the walk
//   carries fp32 across the chunks (16 at S 4096), and dcum, whose row and
//   column sums cancel, is summed from the same rounded s o dS values at i
//   and at j (in fp64 across tiles), as dA demands (at both configs'
//   training operands: dx 1.1e-4 of its norm, from its bf16 rounding, dA
//   <= 5e-5, the rest <= 2.5e-6; PERF.md row 8-bwd). exp:
//   ex2.approx in the (Q, Q) forms, expf elsewhere.
//   Shared memory at hd 64, Q 256: launch 2 76 KB (2 CTAs an SM), launch 4
//   111 KB at ds 128 (2 an SM; the state buffer doubles as the column-sum
//   vectors), launch 5 174 KB (1 an SM), launch 6 49 KB (3 an SM).
//
// fp32 x (parity checks only): five launches on fp32 FMAs (namespace-level
//   kernels below: ssd_bwd_chunk_state, the walk, ssd_bwd_chunk_kernel with
//   per-head dB/dC partials, ssd_bwd_group_sum, ssd_bwd_dA). The walk is
//   shared with the bf16 route; it does the same fp32 arithmetic in the
//   same order as the one-load-a-step walk it replaced, so this route's
//   results are unchanged, bit for bit.
//
//   Bound on an H100 SXM: operations. At mamba2-2.7b's training operands
//   (B=4, S=4096, nh=80, hd=64, ng=1, ds=128, Q=256) the function reads
//   x, dt, A, B and C and dy and writes dx, ddt, dA, dB and dC (547 MB:
//   0.16 ms at 3.35 TB/s); its products (chip_smoke.py: ssd_bwd_work
//   counts them) are 152 GFLOP: 0.31 ms at the 495 TFLOP/s of TF32 tensor
//   cores (the rate the forward's bound takes for its fp32 operands). The
//   bf16 route's splits and recomputations make ~330 GFLOP of bf16
//   products, and Hs, dHs (168 MB each) and W cross device memory several
//   times. Measured on one H100 (chip_smoke.py, PERF.md row 8-bwd): launch
//   4 takes a third of the call, the state terms (launches 2 and 5) another
//   third; each runs at a fraction of the mma rate, bound by latency with
//   8-16 warps an SM.
//
// Launches on the caller's stream, allocates nothing (the wrapper allocates
// the workspaces), does not synchronize, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "flash_mma.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory on sm_90
constexpr int kThreads = 256;     // 16 x 16
constexpr int kT = 64;            // the (Q, Q) form's i and j tile
constexpr int kLd = kT + 1;       // padded row of the transposed tiles
constexpr int kMaxDim = 128;      // head dim and state dim

__host__ __device__ inline int padded_q(int Q) { return (Q + kT - 1) / kT * kT; }

__device__ inline float load_f(const float* p) { return *p; }
__device__ inline float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ inline void store_f(float* p, float v) { *p = v; }
__device__ inline void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// sum over the 16 lanes of a half warp (the threads of one ty)
__device__ inline float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// dtc[p] = dt at chunk position p (0 past Q or S); cum its inclusive
// prefix sum of dtc * A, in fp64 rounded once: the forward's own scheme
// (csrc/ssd_chunk.cu), so both see the same cum. Every thread calls it.
__device__ void chunk_prefix(const float* dtb, long long dt_step, int c0, int Q, int S,
                             int Qp, float a_head, float* dtc, float* cum) {
  const int tid = threadIdx.x, lane = tid & 31;
  for (int p = tid; p < Qp; p += kThreads) {
    const int t = c0 + p;
    dtc[p] = (p < Q && t < S) ? dtb[t * dt_step] : 0.f;
  }
  __syncthreads();
  if (tid < 32) {
    double carry = 0.0;
    for (int base = 0; base < Qp; base += 32) {
      double v = static_cast<double>(dtc[base + lane] * a_head);
      for (int off = 1; off < 32; off <<= 1) {
        const double n = __shfl_up_sync(kFullMask, v, off);
        if (lane >= off) v += n;
      }
      v += carry;
      cum[base + lane] = static_cast<float>(v);
      carry = __shfl_sync(kFullMask, v, 31);
    }
  }
  __syncthreads();
}

// ------------------------------------------------------------------------- //
// 1. the chunks' own state contributions
// ------------------------------------------------------------------------- //
size_t state_smem_bytes(int hd, int ds, int Q) {
  return sizeof(float) * (static_cast<size_t>(kT) * hd + static_cast<size_t>(ds) * kLd
                          + 3 * static_cast<size_t>(padded_q(Q)));
}

// NJ = head dims per thread (hd <= 16 NJ), NS = state dims per thread
// (ds <= 16 NS). Thread (ty, tx) owns d = ty + 16 a, s = tx + 16 c.
template <typename T, int NJ, int NS>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const T* __restrict__ dy,
                    float* __restrict__ Hs, float* __restrict__ dHs, float* __restrict__ tot,
                    int S, int nh, int hd, int ng, int ds, int Q, int nc) {
  extern __shared__ float smem[];
  const int Qp = padded_q(Q);
  float* rows = smem;              // kT x hd: rows[j][d] (x, then dy)
  float* colt = rows + kT * hd;    // ds x kLd: colt[s][j] (B, then C)
  float* dtc = colt + ds * kLd;    // Qp
  float* cum = dtc + Qp;           // Qp
  float* wgt = cum + Qp;           // Qp: wj_j, then exp(cum_i)

  const int c = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int g = head / (nh / ng);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long x_step = static_cast<long long>(nh) * hd;
  const long long bc_step = static_cast<long long>(ng) * ds;
  const int c0 = c * Q;
  const long long xoff = (static_cast<long long>(b) * S * nh + head) * hd;
  const long long bcoff = (static_cast<long long>(b) * S * ng + g) * ds;

  chunk_prefix(dt + static_cast<long long>(b) * S * nh + head, nh, c0, Q, S, Qp, A[head],
               dtc, cum);
  const float total = cum[Q - 1];
  const long long bh = static_cast<long long>(b) * nh + head;
  if (tid == 0) tot[bh * nc + c] = total;
  const long long hoff = (bh * nc + c) * hd * ds;
  const int n_tiles = Qp / kT;

  for (int side = 0; side < 2; ++side) {
    const T* rb = (side == 0 ? x : dy) + xoff;
    const float* cb = (side == 0 ? Bm : Cm) + bcoff;
    __syncthreads();  // the previous side's readers of wgt are done
    for (int p = tid; p < Qp; p += kThreads)
      wgt[p] = side == 0 ? expf(total - cum[p]) * dtc[p] : expf(cum[p]);
    float acc[NJ][NS];
#pragma unroll
    for (int a = 0; a < NJ; ++a)
#pragma unroll
      for (int k = 0; k < NS; ++k) acc[a][k] = 0.f;
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * kT;
      __syncthreads();  // the previous tile's readers are done
      for (int idx = tid; idx < kT * hd; idx += kThreads) {
        const int j = idx / hd, d = idx - j * hd;
        const int p = j0 + j, t = c0 + p;
        rows[j * hd + d] = (p < Q && t < S) ? load_f(rb + t * x_step + d) : 0.f;
      }
      for (int idx = tid; idx < kT * ds; idx += kThreads) {
        const int j = idx / ds, s = idx - j * ds;
        const int p = j0 + j, t = c0 + p;
        colt[s * kLd + j] = (p < Q && t < S) ? cb[t * bc_step + s] : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < kT; ++j) {
        const float w = wgt[j0 + j];
        float xv[NJ], bv[NS];
#pragma unroll
        for (int a = 0; a < NJ; ++a) {
          const int d = ty + 16 * a;
          xv[a] = d < hd ? rows[j * hd + d] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          const int s = tx + 16 * k;
          bv[k] = s < ds ? colt[s * kLd + j] * w : 0.f;
        }
#pragma unroll
        for (int a = 0; a < NJ; ++a)
#pragma unroll
          for (int k = 0; k < NS; ++k) acc[a][k] = fmaf(xv[a], bv[k], acc[a][k]);
      }
    }
    float* out = (side == 0 ? Hs : dHs) + hoff;
#pragma unroll
    for (int a = 0; a < NJ; ++a) {
      const int d = ty + 16 * a;
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const int s = tx + 16 * k;
        if (d < hd && s < ds) out[d * ds + s] = acc[a][k];
      }
    }
  }
}

// ------------------------------------------------------------------------- //
// 2. the state walk: Hs -> h_in per chunk, dHs -> dh_out per chunk
// ------------------------------------------------------------------------- //
// Both routes. One thread per state element walks the chunks in order (Hs
// becomes each chunk's entering state) and in reverse (dHs becomes each
// chunk's dh_out, starting from dh_final), the only sequential pass,
// elementwise and bound by its bytes: both walks together, each thread's
// loads of a run of kWalkRun chunks started at once (they do not depend on
// the carry; with one load in flight a thread the walk was bound by its
// latency, 1.42 ms at mamba2-2.7b's operands), the same fp32 arithmetic in
// the same order either way.
constexpr int kWalkRun = 8;

__global__ void __launch_bounds__(kThreads)
ssd_bwd_walk(float* __restrict__ Hs, float* __restrict__ dHs, const float* __restrict__ tot,
             const float* __restrict__ dh_final, int nh, int hd, int ds, int nc) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int n = hd * ds;
  if (e >= n) return;
  const long long bh = static_cast<long long>(blockIdx.z) * nh + blockIdx.y;
  const float* tb = tot + bh * nc;
  float* hb = Hs + bh * nc * n + e;
  float* db = dHs + bh * nc * n + e;
  float hc = 0.f;
  float dc = dh_final != nullptr ? dh_final[bh * n + e] : 0.f;
  for (int c0 = 0; c0 < nc; c0 += kWalkRun) {
    const int m = min(kWalkRun, nc - c0);
    float hl[kWalkRun], dl[kWalkRun];
#pragma unroll
    for (int k = 0; k < kWalkRun; ++k) {
      if (k < m) {
        hl[k] = hb[static_cast<long long>(c0 + k) * n];
        dl[k] = db[static_cast<long long>(nc - 1 - c0 - k) * n];
      }
    }
#pragma unroll
    for (int k = 0; k < kWalkRun; ++k) {
      if (k < m) {
        const int c = c0 + k, cr = nc - 1 - c0 - k;
        hb[static_cast<long long>(c) * n] = hc;  // as the forward: h <- exp(total) h + local
        hc = hc * expf(tb[c]) + hl[k];
        db[static_cast<long long>(cr) * n] = dc;  // dh_in = exp(total) dh_out + local
        dc = dc * expf(tb[cr]) + dl[k];
      }
    }
  }
}

// ------------------------------------------------------------------------- //
// 3. the chunks' gradients
// ------------------------------------------------------------------------- //
size_t chunk_smem_bytes(int hd, int ds, int Q) {
  return sizeof(float) * (static_cast<size_t>(ds) * (hd + 1)       // st
                          + 2 * static_cast<size_t>(ds) * kLd      // Ct, Bt
                          + 2 * static_cast<size_t>(hd) * kLd      // dyt, xt
                          + static_cast<size_t>(kT) * kLd          // Tt
                          + 2 * 16 * static_cast<size_t>(kT)       // redP, redG
                          + 7 * static_cast<size_t>(padded_q(Q))   // per-position vectors
                          + 16);                                   // fp64 warp sums
}

// the sum of v over the block in fp64, in a fixed order; every thread gets it
__device__ double block_sum(double v, double* red8) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
  if (lane == 0) red8[warp] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < kThreads / 32; ++w) s += red8[w];
  __syncthreads();
  return s;
}

// Thread (ty, tx) owns the tile rows ty * 4 + r (r < 4) and the columns
// tx + 16 k: of the (64, 64) forms (k < 4), of hd (k < NJ), of ds (k < NS).
// Where hd, ds <= 64 two CTAs fit an SM at Q = 256 (115,264 bytes of shared
// memory each), and the second launch bound holds the registers to the 128
// that allows; wider ones run one CTA an SM, with all the registers they
// need.
template <typename T, int NJ, int NS>
__global__ void __launch_bounds__(kThreads, (NJ <= 4 && NS <= 4) ? 2 : 1)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, const T* __restrict__ dy,
                     const float* __restrict__ Hs, const float* __restrict__ dHs,
                     T* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dBp,
                     float* __restrict__ dCp, double* __restrict__ dAp, int S, int nh, int hd,
                     int ng, int ds, int Q, int nc) {
  extern __shared__ float smem[];
  const int Qp = padded_q(Q);
  const int ldh = hd + 1;
  double* dcum = reinterpret_cast<double*>(smem);  // Qp: dcum, summed in fp64
  double* red8 = dcum + Qp;      // 8 warp sums, fp64
  float* st = smem + 2 * (Qp + 8);  // ds x ldh: st[s][d], h_in, then dh_out
  float* Ct = st + ds * ldh;     // ds x kLd: C of the i tile, Ct[s][i]
  float* Bt = Ct + ds * kLd;     // ds x kLd: B of the j tile, Bt[s][j]
  float* dyt = Bt + ds * kLd;    // hd x kLd: dy of the i tile, dyt[d][i]
  float* xt = dyt + hd * kLd;    // hd x kLd: x of the j tile, xt[d][j]
  float* Tt = xt + hd * kLd;     // kT x kLd: s, then dG, Tt[i][j]
  float* redP = Tt + kT * kLd;   // 16 x kT: column sums of s o dS over each ty's rows
  float* redG = redP + 16 * kT;  // 16 x kT: ... of G o decay o dS
  float* dtc = redG + 16 * kT;   // Qp each, by chunk position:
  float* cum = dtc + Qp;
  float* ecum = cum + Qp;        // exp(cum)
  float* et = ecum + Qp;         // exp(total - cum)
  float* ddtd = et + Qp;         // ddt's direct terms

  const int c = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int g = head / (nh / ng);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, lane = tid & 31;
  const float a_head = A[head];
  const long long x_step = static_cast<long long>(nh) * hd;
  const long long bc_step = static_cast<long long>(ng) * ds;
  const long long g_step = static_cast<long long>(nh) * ds;  // dBp / dCp rows
  const int c0 = c * Q;
  const T* xb = x + (static_cast<long long>(b) * S * nh + head) * hd;
  const T* dyb = dy + (static_cast<long long>(b) * S * nh + head) * hd;
  T* dxb = dx + (static_cast<long long>(b) * S * nh + head) * hd;
  const float* Bb = Bm + (static_cast<long long>(b) * S * ng + g) * ds;
  const float* Cb = Cm + (static_cast<long long>(b) * S * ng + g) * ds;
  float* dBb = dBp + (static_cast<long long>(b) * S * nh + head) * ds;
  float* dCb = dCp + (static_cast<long long>(b) * S * nh + head) * ds;
  const long long bh = static_cast<long long>(b) * nh + head;
  const long long hoff = (bh * nc + c) * hd * ds;

  chunk_prefix(dt + static_cast<long long>(b) * S * nh + head, nh, c0, Q, S, Qp, a_head, dtc,
               cum);
  const float total = cum[Q - 1];
  for (int p = tid; p < Qp; p += kThreads) {
    ecum[p] = expf(cum[p]);
    et[p] = expf(total - cum[p]);
    dcum[p] = 0.0;
    ddtd[p] = 0.f;
  }
  for (int idx = tid; idx < hd * ds; idx += kThreads) {
    const int d = idx / ds, s = idx - d * ds;
    st[s * ldh + d] = Hs[hoff + idx];
  }

  auto load_i = [&](int i0) {  // C and dy of chunk rows [i0, i0 + kT)
    for (int idx = tid; idx < kT * ds; idx += kThreads) {
      const int i = idx / ds, s = idx - i * ds;
      const int p = i0 + i, t = c0 + p;
      Ct[s * kLd + i] = (p < Q && t < S) ? Cb[t * bc_step + s] : 0.f;
    }
    for (int idx = tid; idx < kT * hd; idx += kThreads) {
      const int i = idx / hd, d = idx - i * hd;
      const int p = i0 + i, t = c0 + p;
      dyt[d * kLd + i] = (p < Q && t < S) ? load_f(dyb + t * x_step + d) : 0.f;
    }
  };
  auto load_j = [&](int j0) {  // B and x of chunk rows [j0, j0 + kT)
    for (int idx = tid; idx < kT * ds; idx += kThreads) {
      const int j = idx / ds, s = idx - j * ds;
      const int p = j0 + j, t = c0 + p;
      Bt[s * kLd + j] = (p < Q && t < S) ? Bb[t * bc_step + s] : 0.f;
    }
    for (int idx = tid; idx < kT * hd; idx += kThreads) {
      const int j = idx / hd, d = idx - j * hd;
      const int p = j0 + j, t = c0 + p;
      xt[d * kLd + j] = (p < Q && t < S) ? load_f(xb + t * x_step + d) : 0.f;
    }
  };
  const int n_tiles = Qp / kT;

  // --- h_in's terms: dC_i = exp(cum_i) h_in^T dy_i (dC's first addend),
  //     dcum_i += exp(cum_i) C_i . (h_in^T dy_i)
  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = it * kT;
    __syncthreads();  // the previous tile's readers (and st's writers) are done
    load_i(i0);
    __syncthreads();
    float q[4][NS];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < NS; ++k) q[r][k] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float yv[4], hv[NS];
#pragma unroll
      for (int r = 0; r < 4; ++r) yv[r] = dyt[d * kLd + ty * 4 + r];
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const int s = tx + 16 * k;
        hv[k] = s < ds ? st[s * ldh + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < NS; ++k) q[r][k] = fmaf(yv[r], hv[k], q[r][k]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = i0 + ty * 4 + r, t = c0 + p;
      const float e = ecum[p];
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const int s = tx + 16 * k;
        if (s < ds) v = fmaf(Ct[s * kLd + ty * 4 + r], q[r][k], v);
      }
      v = half_warp_sum(v);
      if (tx == 0) dcum[p] += static_cast<double>(e * v);
      if (p < Q && t < S) {
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          const int s = tx + 16 * k;
          if (s < ds) dCb[t * g_step + s] = e * q[r][k];
        }
      }
    }
  }

  // --- dh_out into st; <dh_out, h_in>
  __syncthreads();  // every reader of h_in is done
  float dot = 0.f;
  for (int idx = tid; idx < hd * ds; idx += kThreads) {
    const int d = idx / ds, s = idx - d * ds;
    const float v = dHs[hoff + idx];
    st[s * ldh + d] = v;
    dot = fmaf(v, Hs[hoff + idx], dot);
  }
  const double dtot_state = expf(total) * block_sum(dot, red8);  // syncs
  double wu_sum = 0.0;  // sum_j wj_j u_j over this thread's rows (tx == 0)

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * kT;
    __syncthreads();  // the previous j tile's readers of Bt, xt are done
    load_j(j0);
    __syncthreads();
    float dxa[4][NJ], dBa[4][NS];
    // dh_out's terms of the j tile: dx_j = wj_j dh_out B_j, dB_j = wj_j
    // dh_out^T x_j, u_j = x_j . dh_out B_j
    {
      float hb[4][NJ];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int a = 0; a < NJ; ++a) hb[r][a] = 0.f;
      for (int s = 0; s < ds; ++s) {
        float bv[4], hv[NJ];
#pragma unroll
        for (int r = 0; r < 4; ++r) bv[r] = Bt[s * kLd + ty * 4 + r];
#pragma unroll
        for (int a = 0; a < NJ; ++a) {
          const int d = tx + 16 * a;
          hv[a] = d < hd ? st[s * ldh + d] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int a = 0; a < NJ; ++a) hb[r][a] = fmaf(bv[r], hv[a], hb[r][a]);
      }
      float db[4][NS];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < NS; ++k) db[r][k] = 0.f;
      for (int d = 0; d < hd; ++d) {
        float xv[4], hv[NS];
#pragma unroll
        for (int r = 0; r < 4; ++r) xv[r] = xt[d * kLd + ty * 4 + r];
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          const int s = tx + 16 * k;
          hv[k] = s < ds ? st[s * ldh + d] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < NS; ++k) db[r][k] = fmaf(xv[r], hv[k], db[r][k]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = j0 + ty * 4 + r;
        const float w = et[p] * dtc[p];
        float u = 0.f;
#pragma unroll
        for (int a = 0; a < NJ; ++a) {
          const int d = tx + 16 * a;
          if (d < hd) u = fmaf(xt[d * kLd + ty * 4 + r], hb[r][a], u);
          dxa[r][a] = w * hb[r][a];
        }
#pragma unroll
        for (int k = 0; k < NS; ++k) dBa[r][k] = w * db[r][k];
        u = half_warp_sum(u);
        if (tx == 0) {
          ddtd[p] += et[p] * u;
          dcum[p] -= static_cast<double>(w * u);
          wu_sum += static_cast<double>(w * u);
        }
      }
    }

    // the (Q, Q) form: the i tiles at and below the diagonal
    for (int it = jt; it < n_tiles; ++it) {
      const int i0 = it * kT;
      __syncthreads();  // the previous i tile's readers of Ct, dyt, Tt, red* are done
      load_i(i0);
      __syncthreads();
      float G[4][4], dS[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) G[r][k] = dS[r][k] = 0.f;
      for (int s = 0; s < ds; ++s) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Ct[s * kLd + ty * 4 + r];
#pragma unroll
        for (int k = 0; k < 4; ++k) bv[k] = Bt[s * kLd + tx + 16 * k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) G[r][k] = fmaf(cv[r], bv[k], G[r][k]);
      }
      for (int d = 0; d < hd; ++d) {
        float yv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) yv[r] = dyt[d * kLd + ty * 4 + r];
#pragma unroll
        for (int k = 0; k < 4; ++k) xv[k] = xt[d * kLd + tx + 16 * k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) dS[r][k] = fmaf(yv[r], xv[k], dS[r][k]);
      }
      float rowP[4], colP[4], colG[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) rowP[k] = colP[k] = colG[k] = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = j0 + tx + 16 * k;
          // the mask inside the exp: exp(-inf) = 0, never inf * 0
          const float decay = expf(i >= j ? cum[i] - cum[j] : -CUDART_INF_F);
          const float w = decay * dtc[j];
          const float sv = G[r][k] * w;
          const float pv = sv * dS[r][k];
          rowP[r] += pv;
          colP[k] += pv;
          colG[k] = fmaf(G[r][k] * decay, dS[r][k], colG[k]);
          Tt[(ty * 4 + r) * kLd + tx + 16 * k] = sv;
          G[r][k] = w * dS[r][k];  // dG from here on
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float v = half_warp_sum(rowP[r]);
        if (tx == 0) dcum[i0 + ty * 4 + r] += v;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        redP[ty * kT + tx + 16 * k] = colP[k];
        redG[ty * kT + tx + 16 * k] = colG[k];
      }
      __syncthreads();
      if (tid < kT) {  // the column sums, over ty in order
        double sp = 0.0, sg = 0.0;
        for (int y = 0; y < 16; ++y) {
          sp += redP[y * kT + tid];
          sg += redG[y * kT + tid];
        }
        dcum[j0 + tid] -= sp;
        ddtd[j0 + tid] += static_cast<float>(sg);
      }
      // dx_j += sum_i s_ij dy_i
      for (int i = 0; i < kT; ++i) {
        float sv[4], yv[NJ];
#pragma unroll
        for (int r = 0; r < 4; ++r) sv[r] = Tt[i * kLd + ty * 4 + r];
#pragma unroll
        for (int a = 0; a < NJ; ++a) {
          const int d = tx + 16 * a;
          yv[a] = d < hd ? dyt[d * kLd + i] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int a = 0; a < NJ; ++a) dxa[r][a] = fmaf(sv[r], yv[a], dxa[r][a]);
      }
      __syncthreads();  // every reader of s is done
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) Tt[(ty * 4 + r) * kLd + tx + 16 * k] = G[r][k];
      __syncthreads();
      // dB_j += sum_i dG_ij C_i
      for (int i = 0; i < kT; ++i) {
        float gv[4], cv[NS];
#pragma unroll
        for (int r = 0; r < 4; ++r) gv[r] = Tt[i * kLd + ty * 4 + r];
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          const int s = tx + 16 * k;
          cv[k] = s < ds ? Ct[s * kLd + i] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < NS; ++k) dBa[r][k] = fmaf(gv[r], cv[k], dBa[r][k]);
      }
      // dC_i += sum_j dG_ij B_j: this CTA's own rows, added in place
      float dc[4][NS];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < NS; ++k) dc[r][k] = 0.f;
      for (int j = 0; j < kT; ++j) {
        float gv[4], bv[NS];
#pragma unroll
        for (int r = 0; r < 4; ++r) gv[r] = Tt[(ty * 4 + r) * kLd + j];
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          const int s = tx + 16 * k;
          bv[k] = s < ds ? Bt[s * kLd + j] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < NS; ++k) dc[r][k] = fmaf(gv[r], bv[k], dc[r][k]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = i0 + ty * 4 + r, t = c0 + p;
        if (p >= Q || t >= S) continue;
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          const int s = tx + 16 * k;
          if (s < ds) dCb[t * g_step + s] += dc[r][k];
        }
      }
    }

    // the j tile's dx and (this head's) dB are complete
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = j0 + ty * 4 + r, t = c0 + p;
      if (p >= Q || t >= S) continue;
#pragma unroll
      for (int a = 0; a < NJ; ++a) {
        const int d = tx + 16 * a;
        if (d < hd) store_f(dxb + t * x_step + d, dxa[r][a]);
      }
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const int s = tx + 16 * k;
        if (s < ds) dBb[t * g_step + s] = dBa[r][k];
      }
    }
  }

  // --- the decay exponents: dcum[Q-1] gains total's cotangent; da is the
  //     reverse prefix sum of dcum (fp64, rounded once); ddt = direct + A da;
  //     this chunk's share of dA = sum_t dt_t da_t (fp64)
  const double wu_all = block_sum(wu_sum, red8);  // syncs
  if (tid < 32) {
    if (lane == 0) dcum[Q - 1] += wu_all + dtot_state;
    __syncwarp();
    double carry = 0.0, dA_acc = 0.0;
    for (int base = Qp - 32; base >= 0; base -= 32) {
      double v = dcum[base + lane];
      for (int off = 1; off < 32; off <<= 1) {
        const double n = __shfl_down_sync(kFullMask, v, off);
        if (lane + off < 32) v += n;
      }
      v += carry;
      carry = __shfl_sync(kFullMask, v, 0);
      const int p = base + lane, t = c0 + p;
      const float da = static_cast<float>(v);
      if (p < Q && t < S) ddt[(static_cast<long long>(b) * S + t) * nh + head] =
          ddtd[p] + a_head * da;
      dA_acc += static_cast<double>(dtc[p] * da);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dA_acc += __shfl_down_sync(kFullMask, dA_acc, off);
    if (lane == 0) dAp[(static_cast<long long>(b) * nc + c) * nh + head] = dA_acc;
  }
}

// ------------------------------------------------------------------------- //
// 4-5. the fixed-order reductions
// ------------------------------------------------------------------------- //
__global__ void __launch_bounds__(kThreads)
ssd_bwd_group_sum(const float* __restrict__ dBp, const float* __restrict__ dCp,
                  float* __restrict__ dBm, float* __restrict__ dCm, long long n, int nh, int ng,
                  int ds) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) return;  // e over (b, t, g, s)
  const int s = static_cast<int>(e % ds);
  const long long rg = e / ds;
  const int g = static_cast<int>(rg % ng);
  const long long row = rg / ng;  // b * S + t
  const int hpg = nh / ng;
  const long long off = (row * nh + static_cast<long long>(g) * hpg) * ds + s;
  float aB = 0.f, aC = 0.f;
  for (int k = 0; k < hpg; ++k) {  // in head order
    aB += dBp[off + static_cast<long long>(k) * ds];
    aC += dCp[off + static_cast<long long>(k) * ds];
  }
  dBm[e] = aB;
  dCm[e] = aC;
}

__global__ void ssd_bwd_dA(const double* __restrict__ dAp, float* __restrict__ dA, int Bt,
                           int nc, int nh) {
  const int head = blockIdx.x * blockDim.x + threadIdx.x;
  if (head >= nh) return;
  double acc = 0.0;
  for (int b = 0; b < Bt; ++b)
    for (int c = 0; c < nc; ++c) acc += dAp[(static_cast<long long>(b) * nc + c) * nh + head];
  dA[head] = static_cast<float>(acc);
}

// ------------------------------------------------------------------------- //
// launch
// ------------------------------------------------------------------------- //
struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const float* Bm;
  const float* Cm;
  const void* dy;
  const float* dh_final;
  float* Hs;
  float* dHs;
  float* tot;
  float* dBp;
  float* dCp;
  double* dAp;
  void* dx;
  float* ddt;
  float* dA;
  float* dBm;
  float* dCm;
  int Bt, S, nh, hd, ng, ds, Q, nc;
  cudaStream_t st;
};

template <typename T, int NJ, int NS>
int launch_t(const Args& a) {
  const size_t smem1 = state_smem_bytes(a.hd, a.ds, a.Q);
  const size_t smem3 = chunk_smem_bytes(a.hd, a.ds, a.Q);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_chunk_state<T, NJ, NS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T, NJ, NS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem3));
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const dim3 grid(a.nc, a.nh, a.Bt);
  ssd_bwd_chunk_state<T, NJ, NS><<<grid, kThreads, smem1, a.st>>>(
      x, a.dt, a.A, a.Bm, a.Cm, dy, a.Hs, a.dHs, a.tot, a.S, a.nh, a.hd, a.ng, a.ds, a.Q,
      a.nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2((a.hd * a.ds + kThreads - 1) / kThreads, a.nh, a.Bt);
  ssd_bwd_walk<<<grid2, kThreads, 0, a.st>>>(a.Hs, a.dHs, a.tot, a.dh_final, a.nh, a.hd, a.ds,
                                              a.nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk_kernel<T, NJ, NS><<<grid, kThreads, smem3, a.st>>>(
      x, a.dt, a.A, a.Bm, a.Cm, dy, a.Hs, a.dHs, static_cast<T*>(a.dx), a.ddt, a.dBp, a.dCp,
      a.dAp, a.S, a.nh, a.hd, a.ng, a.ds, a.Q, a.nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(a.Bt) * a.S * a.ng * a.ds;
  ssd_bwd_group_sum<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
                      a.st>>>(a.dBp, a.dCp, a.dBm, a.dCm, n, a.nh, a.ng, a.ds);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dA<<<(a.nh + 127) / 128, 128, 0, a.st>>>(a.dAp, a.dA, a.Bt, a.nc, a.nh);
  return static_cast<int>(cudaGetLastError());
}

// NJ, NS in {4, 8}: widths up to 64 or 128 (narrower ones run masked)
template <typename T>
int launch_dims(const Args& a) {
  if (a.hd <= 64) return a.ds <= 64 ? launch_t<T, 4, 4>(a) : launch_t<T, 4, 8>(a);
  return a.ds <= 64 ? launch_t<T, 8, 4>(a) : launch_t<T, 8, 8>(a);
}


// ------------------------------------------------------------------------- //
// bf16 x: tensor cores
// ------------------------------------------------------------------------- //
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 256;  // 16 row tiles of 16: two per warp in launch 4
constexpr int kGT = 64;     // the G launch's tile and launch 6's tile pairs
constexpr int kGLd = kGT + 1;
constexpr float kLog2e = 1.4426950408889634f;

// hd and ds are padded (zeros) to 64 or 128 in shared memory and in the
// workspace's copies of B and C
__host__ __device__ inline int padded_dim(int n) { return n <= 64 ? 64 : 128; }

// per (b, group, chunk): G^T (Qp x Qp), then B in A order, C in B order
// and B in B order (Qp x DS each)
__host__ __device__ inline long long block_floats(int Qp, int DS) {
  return static_cast<long long>(Qp) * (Qp + 3 * DS);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int a) {
  return a == 0 ? v.x : a == 1 ? v.y : a == 2 ? v.z : v.w;
}

// a pair (lower k in the low half) split into hi = bf16(v) and lo =
// bf16(v - hi) words: 16 bits of mantissa
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  const float2 hf = __bfloat1622float2(h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

// ---- the workspace's fragment orders ------------------------------------ //
// As in csrc/ssd_chunk.cu: the lane (g, t) that holds k = 2t, 2t+1, 2t+8,
// 2t+9 of an m16n8k16 fragment holds the actual columns 4t .. 4t+3, so a
// lane reads 16 contiguous bytes; the other operand takes the same
// permutation (ldmatrix row addresses, permuted columns in shared memory).
__device__ __forceinline__ int frag_lane(int r, int c) { return (r & 7) * 4 + (c >> 2); }

// (i, s) as the A operand (rows i, k = s): [mt][kk][row half][lane][4]
__device__ __forceinline__ int a_off(int i, int s, int KK) {
  return ((((i >> 4) * KK + (s >> 4)) * 2 + ((i >> 3) & 1)) * 32 + frag_lane(i, s & 15)) * 4 +
         (s & 3);
}

// (j, s) as the B operand (k = j, n = s): [kt][nt][lane][4]
__device__ __forceinline__ int b_off(int j, int s, int NT) {
  return (((j >> 4) * NT + (s >> 3)) * 32 + frag_lane(s, j & 15)) * 4 + (j & 3);
}

// G^T (j, i) in the natural accumulator order of the 16 x 16 tile (j >> 4,
// i >> 4): [jt][it][lane][n tile][4], a lane's slots rows g, g+8 by
// columns 2t, 2t+1
__device__ __forceinline__ int gt_off(int j, int i, int MT) {
  return ((((j >> 4) * MT + (i >> 4)) * 32 + (j & 7) * 4 + ((i & 7) >> 1)) * 2 + ((i >> 3) & 1)) *
             4 +
         ((j >> 3) & 1) * 2 + (i & 1);
}

// the permuted position of column c (of 16): 4t + e -> 2t + e, 4t + 2 + e
// -> 8 + 2t + e
__device__ __forceinline__ int perm_col(int c) {
  return ((c >> 2) << 1) + (c & 1) + ((c >> 1) & 1) * 8;
}

// the actual row (of 16) that ldmatrix lane row r (of 8) of k half kb reads
__device__ __forceinline__ int perm_row(int r, int kb) { return (r >> 1) * 4 + (r & 1) + kb * 2; }

// ---- loads into shared memory ------------------------------------------- //
// rows [0, n_rows) of a head's sequence (row r at src + r * step; rows at
// or past n_valid zero) and head dims [0, HD) (past hd zero) into a
// (n_rows, HD + 8) bf16 tile. vec: 16-byte cp.async (hd % 8 == 0, 16-byte
// aligned operands), else element copies; dummy is a valid address.
template <int HD>
__device__ __forceinline__ void load_rows(bf16* tile, const bf16* src, long long step,
                                          int n_rows, int n_valid, int hd, bool vec,
                                          const bf16* dummy) {
  constexpr int kLd = HD + 8;
  if (vec) {
    constexpr int kChunks = HD / 8;
    for (int e = threadIdx.x; e < n_rows * kChunks; e += kThreads) {
      const int r = e / kChunks;
      const int d = (e - r * kChunks) * 8;
      const bool ok = r < n_valid && d < hd;
      cp_async16(smem_addr(tile + r * kLd + d), ok ? src + r * step + d : dummy, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < n_rows * HD; e += kThreads) {
      const int r = e / HD;
      const int d = e - r * HD;
      tile[r * kLd + d] = (r < n_valid && d < hd) ? src[r * step + d] : __float2bfloat16(0.f);
    }
  }
}

// n contiguous floats global -> shared by cp.async
__device__ __forceinline__ void copy_floats(float* dst, const float* src, int n) {
  if ((n & 3) == 0 && (reinterpret_cast<std::uintptr_t>(src) & 15u) == 0) {
    for (int e = threadIdx.x * 4; e < n; e += kThreads * 4)
      cp_async16(smem_addr(dst + e), src + e, 16);
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads) cp_async4(smem_addr(dst + e), src + e, 4);
  }
}

// two bf16 of dx at (row r, head dims d, d + 1)
__device__ __forceinline__ void store_dx(bf16* row, int d, int hd, float v0, float v1,
                                         bool vec) {
  if (d >= hd) return;
  if (vec) {
    *reinterpret_cast<__nv_bfloat162*>(row + d) = __floats2bfloat162_rn(v0, v1);
  } else {
    row[d] = __float2bfloat16(v0);
    if (d + 1 < hd) row[d + 1] = __float2bfloat16(v1);
  }
}

// ---- launch 1: G^T, and B and C in fragment order ----------------------- //
// One CTA per causal (i tile, j tile) pair of 64 x 64, i tile >= j tile;
// C and B staged transposed (rows padded to 65 floats), each thread 4 x 4
// outputs summed over s in order (the forward's ssd_gram_kernel). Rows past
// the chunk or S read as zero. The diagonal tiles also copy their B and C
// rows, zero-padded to DS.
size_t gram_smem_bytes(int ds) { return sizeof(float) * 2 * static_cast<size_t>(ds) * kGLd; }

__global__ void __launch_bounds__(256)
ssd_bwd_gram_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                    float* __restrict__ W, int S, int ng, int ds, int DS, int Q, int Qp) {
  extern __shared__ float gsm[];
  float* Ct = gsm;             // ds x kGLd: Ct[s][i]
  float* Bt = Ct + ds * kGLd;  // ds x kGLd: Bt[s][j]
  const int c = blockIdx.x;
  int tile = blockIdx.y, it = 0;
  while (tile > it) {
    tile -= it + 1;
    ++it;
  }
  const int jt = tile;
  const int bg = blockIdx.z;  // b * ng + group
  const int b = bg / ng, grp = bg - b * ng;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int i0 = it * kGT, j0 = jt * kGT, c0 = c * Q;
  const long long bc_step = static_cast<long long>(ng) * ds;
  const float* Cb = Cm + (static_cast<long long>(b) * S * ng + grp) * ds;
  const float* Bb = Bm + (static_cast<long long>(b) * S * ng + grp) * ds;
  for (int idx = tid; idx < kGT * ds; idx += 256) {
    const int r = idx / ds, s = idx - r * ds;
    const int pi = i0 + r, ti = c0 + pi, pj = j0 + r, tj = c0 + pj;
    Ct[s * kGLd + r] = (pi < Q && ti < S) ? Cb[ti * bc_step + s] : 0.f;
    Bt[s * kGLd + r] = (pj < Q && tj < S) ? Bb[tj * bc_step + s] : 0.f;
  }
  __syncthreads();
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  for (int s = 0; s < ds; ++s) {
    float cv[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) cv[r] = Ct[s * kGLd + ty * 4 + r];
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = Bt[s * kGLd + tx + 16 * q];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(cv[r], bv[q], acc[r][q]);
  }
  float* Wc = W + (static_cast<long long>(bg) * gridDim.x + c) * block_floats(Qp, DS);
  const int MT = Qp / 16;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) Wc[gt_off(j0 + tx + 16 * q, i0 + ty * 4 + r, MT)] = acc[r][q];
  if (it == jt) {
    float* BA = Wc + static_cast<long long>(Qp) * Qp;
    float* CB = BA + static_cast<long long>(Qp) * DS;
    float* BB = CB + static_cast<long long>(Qp) * DS;
    for (int idx = tid; idx < kGT * DS; idx += 256) {
      const int r = idx / DS, s = idx - r * DS;
      const float cv = s < ds ? Ct[s * kGLd + r] : 0.f;
      const float bv = s < ds ? Bt[s * kGLd + r] : 0.f;
      BA[a_off(i0 + r, s, DS / 16)] = bv;
      CB[b_off(i0 + r, s, DS / 8)] = cv;
      BB[b_off(i0 + r, s, DS / 8)] = bv;
    }
  }
}

// ---- launch 2: the chunks' own state terms -------------------------------- //
template <int HD, int DS>
struct StateLayout {
  static constexpr int kLd = HD + 8;
  static constexpr int kPT = HD / 16;           // p tiles (m16), every warp all of them
  static constexpr int kNS = DS / 8 / kWarps;   // s tiles (n8) per warp
  static size_t smem_bytes(int Qp) {
    return sizeof(bf16) * 2 * static_cast<size_t>(Qp) * kLd + sizeof(float) * 4 * Qp;
  }
};

// acc[p][s] = sum_j tile[j][p] (F[j][s] wv[j]): tile^T by ldmatrix.trans
// (rows permuted as F's k), F from the workspace in B order times wv, split
// hi + lo (the tile is exact in bf16)
template <int HD, int DS>
__device__ __forceinline__ void state_product(const bf16* tile, const float* F, const float* wv,
                                              int n_tiles, float (&acc)[HD / 16][DS / 64][4]) {
  using L = StateLayout<HD, DS>;
  constexpr int kLd = L::kLd, kPT = L::kPT, kNS = L::kNS, NT = DS / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int m = 0; m < kPT; ++m)
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  const bf16* abase = tile + perm_row(lane & 7, lane >> 4) * kLd + ((lane >> 3) & 1) * 8;
  const float* Fm = F + (warp * kNS * 32 + lane) * 4;
  float4 f_next[kNS];  // F one k tile ahead
#pragma unroll
  for (int n = 0; n < kNS; ++n) f_next[n] = ld4(Fm + n * 128);
#pragma unroll 1
  for (int kt = 0; kt < n_tiles; ++kt) {
    float4 f_cur[kNS];
#pragma unroll
    for (int n = 0; n < kNS; ++n) f_cur[n] = f_next[n];
    if (kt + 1 < n_tiles) {
#pragma unroll
      for (int n = 0; n < kNS; ++n) f_next[n] = ld4(Fm + ((kt + 1) * NT + n) * 128);
    }
    uint32_t ax[kPT][4];
#pragma unroll
    for (int m = 0; m < kPT; ++m)
      ldsm_x4_t(smem_addr(abase + kt * 16 * kLd + m * 16), ax[m][0], ax[m][1], ax[m][2],
                ax[m][3]);
    const float4 w4 = ld4(wv + kt * 16 + 4 * t);
#pragma unroll
    for (int n = 0; n < kNS; ++n) {
      const float4 f = f_cur[n];
      uint32_t bh0, bl0, bh1, bl1;
      split_pair(f.x * w4.x, f.y * w4.y, bh0, bl0);
      split_pair(f.z * w4.z, f.w * w4.w, bh1, bl1);
#pragma unroll
      for (int m = 0; m < kPT; ++m) {
        mma(acc[m][n], ax[m], bh0, bh1);
        mma(acc[m][n], ax[m], bl0, bl1);
      }
    }
  }
}

template <int HD, int DS>
__device__ __forceinline__ void store_state(float* out, const float (&acc)[HD / 16][DS / 64][4],
                                            int hd, int ds) {
  constexpr int kNS = DS / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < HD / 16; ++m)
#pragma unroll
    for (int n = 0; n < kNS; ++n) {
      const int s = (warp * kNS + n) * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = m * 16 + g + 8 * (e >> 1);
        const int se = s + (e & 1);
        if (p < hd && se < ds) out[p * ds + se] = acc[m][n][e];
      }
    }
}

// One CTA per (head, chunk, b): the prefix sum (chunk_prefix, to the
// workspace cumw with dt: launches 4-6 read them), the chunk's total decay
// exponent, and
// Hs = x^T (B wj), dHs = dy^T (C exp(cum)) on the tensor cores.
template <int HD, int DS>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ W,
                     const bf16* __restrict__ dy, float* __restrict__ Hs,
                     float* __restrict__ dHs, float* __restrict__ tot,
                     float* __restrict__ cumw, int S, int nh, int hd, int ng, int ds, int Q,
                     int Qp, int vec) {
  using L = StateLayout<HD, DS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // Qp x kLd
  bf16* ys = xs + Qp * L::kLd;                   // Qp x kLd
  float* dts = reinterpret_cast<float*>(ys + Qp * L::kLd);
  float* cums = dts + Qp;
  float* wjs = cums + Qp;  // exp(total - cum) dt
  float* ecs = wjs + Qp;   // exp(cum)

  const int head = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y, grp = head / (nh / ng);
  const int c0 = c * Q, nv = min(Q, S - c0);
  const long long x_step = static_cast<long long>(nh) * hd;
  const long long xoff = (static_cast<long long>(b) * S + c0) * x_step + static_cast<long long>(head) * hd;
  load_rows<HD>(xs, x + xoff, x_step, Qp, nv, hd, vec, x);
  cp_async_commit();
  load_rows<HD>(ys, dy + xoff, x_step, Qp, nv, hd, vec, dy);
  cp_async_commit();
  chunk_prefix(dt + static_cast<long long>(b) * S * nh + head, nh, c0, Q, S, Qp, A[head], dts,
               cums);
  const float total = cums[Q - 1];
  const long long bh = static_cast<long long>(b) * nh + head;
  if (threadIdx.x == 0) tot[bh * nc + c] = total;
  float* cw = cumw + (bh * nc + c) * 2 * Qp;
  for (int p = threadIdx.x; p < Qp; p += kThreads) {
    cw[p] = cums[p];
    cw[Qp + p] = dts[p];
    wjs[p] = expf(total - cums[p]) * dts[p];
    ecs[p] = expf(cums[p]);
  }
  const float* Wb = W + ((static_cast<long long>(b) * ng + grp) * nc + c) * block_floats(Qp, DS);
  const float* CB = Wb + static_cast<long long>(Qp) * Qp + static_cast<long long>(Qp) * DS;
  const float* BB = CB + static_cast<long long>(Qp) * DS;
  const int n_tiles = (nv + 15) / 16;
  const long long hoff = (bh * nc + c) * hd * ds;
  float acc[HD / 16][DS / 64][4];
  cp_async_wait<1>();  // x has landed (this thread's copies) ...
  __syncthreads();     // ... every thread's, and the vectors are written
  state_product<HD, DS>(xs, BB, wjs, n_tiles, acc);
  store_state<HD, DS>(Hs + hoff, acc, hd, ds);
  cp_async_wait<0>();
  __syncthreads();
  state_product<HD, DS>(ys, CB, ecs, n_tiles, acc);
  store_state<HD, DS>(dHs + hoff, acc, hd, ds);
}

// ---- launch 4: the per-head gradients ------------------------------------ //
template <int HD, int DS>
struct ChunkLayout {
  static constexpr int kLd = HD + 8;   // x, dy rows
  static constexpr int kLdh = DS + 8;  // state rows, hi and lo
  __host__ __device__ static size_t state_bytes(int Qp) {
    const size_t st = sizeof(bf16) * 2 * HD * kLdh;
    const size_t part = sizeof(float) * kWarps * static_cast<size_t>(Qp);
    return st > part ? st : part;
  }
  static size_t smem_bytes(int Qp) {
    return sizeof(double) * (Qp + kWarps) + sizeof(bf16) * 2 * static_cast<size_t>(Qp) * kLd +
           state_bytes(Qp) + sizeof(float) * 3 * Qp;
  }
};

__device__ __forceinline__ double quad_sum64(double v) {
  v += __shfl_xor_sync(kFullMask, v, 1);
  return v + __shfl_xor_sync(kFullMask, v, 2);
}

template <int HD, int DS>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 2 : 1)
ssd_bwd_chunk_kernel_tc(const bf16* __restrict__ x, const float* __restrict__ A,
                        const float* __restrict__ Cm, const bf16* __restrict__ dy,
                        const float* __restrict__ W, const float* __restrict__ cumw,
                        const float* __restrict__ Hs, const float* __restrict__ dHs,
                        bf16* __restrict__ dx, float* __restrict__ ddt,
                        double* __restrict__ dAp, int S, int nh, int hd, int ng, int ds,
                        int Q, int Qp, int vec) {
  using L = ChunkLayout<HD, DS>;
  constexpr int kLd = L::kLd, kLdh = L::kLdh, NP = HD / 16, NN = HD / 8, KK = DS / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* dcum = reinterpret_cast<double*>(smem_raw);  // Qp: dcum, summed in fp64
  double* red = dcum + Qp;                              // kWarps
  bf16* xs = reinterpret_cast<bf16*>(red + kWarps);     // Qp x kLd
  bf16* ys = xs + Qp * kLd;                             // Qp x kLd
  unsigned char* st_raw = reinterpret_cast<unsigned char*>(ys + Qp * kLd);
  bf16* hs_hi = reinterpret_cast<bf16*>(st_raw);  // HD x kLdh: h_in, then dh_out
  bf16* hs_lo = hs_hi + HD * kLdh;
  float* part = reinterpret_cast<float*>(st_raw);  // kWarps x Qp, once the state is done
  float* cums = reinterpret_cast<float*>(st_raw + L::state_bytes(Qp));
  float* dts = cums + Qp;
  float* ddto = dts + Qp;  // ddt's direct terms

  const int head = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y, grp = head / (nh / ng);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int c0 = c * Q, nv = min(Q, S - c0), MT = Qp / 16;
  const long long x_step = static_cast<long long>(nh) * hd;
  const long long xoff = (static_cast<long long>(b) * S + c0) * x_step + static_cast<long long>(head) * hd;
  const long long bh = static_cast<long long>(b) * nh + head;
  const long long hoff = (bh * nc + c) * hd * ds;
  const float* Wb = W + ((static_cast<long long>(b) * ng + grp) * nc + c) * block_floats(Qp, DS);
  const float* Gt = Wb;
  const float* BA = Wb + static_cast<long long>(Qp) * Qp;
  const long long c_step = static_cast<long long>(ng) * ds;
  const float* Cb = Cm + (static_cast<long long>(b) * S + c0) * c_step + static_cast<long long>(grp) * ds;
  const float a_head = A[head];

  load_rows<HD>(xs, x + xoff, x_step, Qp, nv, hd, vec, x);
  load_rows<HD>(ys, dy + xoff, x_step, Qp, nv, hd, vec, dy);
  cp_async_commit();
  const float* cw = cumw + (bh * nc + c) * 2 * Qp;
  for (int p = threadIdx.x; p < Qp; p += kThreads) {
    cums[p] = cw[p];
    dts[p] = cw[Qp + p];
    ddto[p] = 0.f;
    dcum[p] = 0.0;
  }
  // h_in as hs[d][s], s in natural order (the B operand of dy h_in, by
  // ldmatrix.trans); 16-byte loads where ds % 4 == 0
  const bool st4 = ds % 4 == 0;
  for (int idx = threadIdx.x; idx < HD * (DS / 4); idx += kThreads) {
    const int d = idx / (DS / 4), s = (idx - d * (DS / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (d < hd && s < ds) {
      const float* src = Hs + hoff + d * ds + s;
      v = st4 ? ld4(src) : make_float4(src[0], s + 1 < ds ? src[1] : 0.f,
                                       s + 2 < ds ? src[2] : 0.f, s + 3 < ds ? src[3] : 0.f);
    }
    uint32_t h0, l0, h1, l1;
    split_pair(v.x, v.y, h0, l0);
    split_pair(v.z, v.w, h1, l1);
    *reinterpret_cast<uint2*>(hs_hi + d * kLdh + s) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(hs_lo + d * kLdh + s) = make_uint2(l0, l1);
  }
  cp_async_wait<0>();
  __syncthreads();
  const float total = cums[Q - 1];

  // --- h_in's term of dcum: q = dy h_in (dy exact, h_in hi + lo), then
  //     dcum_i = exp(cum_i) C_i . q_i (the row's first addend)
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    const int mt = half == 0 ? warp : 2 * kWarps - 1 - warp;
    if (mt >= MT) continue;
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    float v0 = 0.f, v1 = 0.f;
#pragma unroll 1
    for (int sc = 0; sc < DS / 32; ++sc) {
      float cv[4][4];  // C at rows r0, r1 and this lane's columns, loaded ahead of the products
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int s = sc * 32 + n * 8 + 2 * t;
        const bool ok0 = r0 < nv, ok1 = r1 < nv;
        cv[n][0] = (ok0 && s < ds) ? Cb[r0 * c_step + s] : 0.f;
        cv[n][1] = (ok0 && s + 1 < ds) ? Cb[r0 * c_step + s + 1] : 0.f;
        cv[n][2] = (ok1 && s < ds) ? Cb[r1 * c_step + s] : 0.f;
        cv[n][3] = (ok1 && s + 1 < ds) ? Cb[r1 * c_step + s + 1] : 0.f;
      }
      float q[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) q[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < NP; ++kd) {
        uint32_t a[4];
        ldsm_x4(smem_addr(ys + (mt * 16 + (lane & 15)) * kLd + kd * 16 + (lane >> 4) * 8), a[0],
                a[1], a[2], a[3]);
#pragma unroll
        for (int sp = 0; sp < 2; ++sp) {
          const int off = (kd * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdh + sc * 32 +
                          sp * 16 + (lane >> 4) * 8;
          uint32_t bh4[4], bl4[4];
          ldsm_x4_t(smem_addr(hs_hi + off), bh4[0], bh4[1], bh4[2], bh4[3]);
          ldsm_x4_t(smem_addr(hs_lo + off), bl4[0], bl4[1], bl4[2], bl4[3]);
          mma(q[2 * sp], a, bh4[0], bh4[1]);
          mma(q[2 * sp], a, bl4[0], bl4[1]);
          mma(q[2 * sp + 1], a, bh4[2], bh4[3]);
          mma(q[2 * sp + 1], a, bl4[2], bl4[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        v0 = fmaf(q[n][0], cv[n][0], fmaf(q[n][1], cv[n][1], v0));
        v1 = fmaf(q[n][2], cv[n][2], fmaf(q[n][3], cv[n][3], v1));
      }
    }
    v0 = quad_sum(v0);
    v1 = quad_sum(v1);
    if (t == 0) {
      dcum[r0] = static_cast<double>(expf(cums[r0]) * v0);
      dcum[r1] = static_cast<double>(expf(cums[r1]) * v1);
    }
  }

  // --- dh_out as hs[d][perm(s)] (the B operand of B dh_out^T, k = s in
  //     the workspace's permuted order); <dh_out, h_in>
  __syncthreads();  // every reader of h_in is done
  float dot = 0.f;
  for (int idx = threadIdx.x; idx < HD * (DS / 4); idx += kThreads) {
    const int d = idx / (DS / 4), s = (idx - d * (DS / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f), h = v;
    if (d < hd && s < ds) {
      const float* src = dHs + hoff + d * ds + s;
      const float* hsrc = Hs + hoff + d * ds + s;
      if (st4) {
        v = ld4(src);
        h = ld4(hsrc);
      } else {
        v = make_float4(src[0], s + 1 < ds ? src[1] : 0.f, s + 2 < ds ? src[2] : 0.f,
                        s + 3 < ds ? src[3] : 0.f);
        h = make_float4(hsrc[0], s + 1 < ds ? hsrc[1] : 0.f, s + 2 < ds ? hsrc[2] : 0.f,
                        s + 3 < ds ? hsrc[3] : 0.f);
      }
    }
    dot = fmaf(v.x, h.x, dot);
    dot = fmaf(v.y, h.y, dot);
    dot = fmaf(v.z, h.z, dot);
    dot = fmaf(v.w, h.w, dot);
    uint32_t h0, l0, h1, l1;
    split_pair(v.x, v.y, h0, l0);
    split_pair(v.z, v.w, h1, l1);
    // columns s .. s + 3 (s % 4 == 0) sit at perm(s), perm(s) + 1 and
    // perm(s + 2), perm(s + 2) + 1
    const int c0_ = (s & ~15) + perm_col(s & 15), c2_ = (s & ~15) + perm_col((s + 2) & 15);
    *reinterpret_cast<uint32_t*>(hs_hi + d * kLdh + c0_) = h0;
    *reinterpret_cast<uint32_t*>(hs_lo + d * kLdh + c0_) = l0;
    *reinterpret_cast<uint32_t*>(hs_hi + d * kLdh + c2_) = h1;
    *reinterpret_cast<uint32_t*>(hs_lo + d * kLdh + c2_) = l1;
  }
  __syncthreads();

  // --- dh_out's terms of the rows j: dx_j = wj_j (B dh_out^T)_j (B from
  //     the workspace in A order, both fp32: three products), u_j = x_j .
  //     (B dh_out^T)_j, ddt_j = exp(total - cum_j) u_j, dcum_j -= wj_j u_j
  float dxa[2][NN][4];
  double wu = 0.0;  // sum_j wj_j u_j over this lane's rows (t == 0)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int mt = half == 0 ? warp : 2 * kWarps - 1 - warp;
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dxa[half][n][e] = 0.f;
    if (mt >= MT) continue;
    const float* Bm_ = BA + mt * KK * 256 + lane * 4;
    const bf16* hbase = hs_hi + ((lane & 7) + ((lane >> 4) << 3)) * kLdh + ((lane >> 3) & 1) * 8;
    float4 b_next[2] = {ld4(Bm_), ld4(Bm_ + 128)};  // one k tile ahead
#pragma unroll 1
    for (int kk = 0; kk < KK; ++kk) {
      const float4 b0 = b_next[0], b1 = b_next[1];
      if (kk + 1 < KK) {
        b_next[0] = ld4(Bm_ + (kk + 1) * 256);
        b_next[1] = ld4(Bm_ + (kk + 1) * 256 + 128);
      }
      uint32_t ah[4], al[4];
      split_pair(b0.x, b0.y, ah[0], al[0]);
      split_pair(b1.x, b1.y, ah[1], al[1]);
      split_pair(b0.z, b0.w, ah[2], al[2]);
      split_pair(b1.z, b1.w, ah[3], al[3]);
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        uint32_t bh4[4], bl4[4];
        ldsm_x4(smem_addr(hbase + np * 16 * kLdh + kk * 16), bh4[0], bh4[1], bh4[2], bh4[3]);
        ldsm_x4(smem_addr(hbase + HD * kLdh + np * 16 * kLdh + kk * 16), bl4[0], bl4[1], bl4[2],
                bl4[3]);
        mma(dxa[half][2 * np], ah, bh4[0], bh4[1]);
        mma(dxa[half][2 * np], ah, bl4[0], bl4[1]);
        mma(dxa[half][2 * np], al, bh4[0], bh4[1]);
        mma(dxa[half][2 * np + 1], ah, bh4[2], bh4[3]);
        mma(dxa[half][2 * np + 1], ah, bl4[2], bl4[3]);
        mma(dxa[half][2 * np + 1], al, bh4[2], bh4[3]);
      }
    }
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    float u0 = 0.f, u1 = 0.f;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int d = n * 8 + 2 * t;
      const float2 x0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + r0 * kLd + d));
      const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + r1 * kLd + d));
      u0 = fmaf(x0.x, dxa[half][n][0], fmaf(x0.y, dxa[half][n][1], u0));
      u1 = fmaf(x1.x, dxa[half][n][2], fmaf(x1.y, dxa[half][n][3], u1));
    }
    u0 = quad_sum(u0);
    u1 = quad_sum(u1);
    const float et0 = expf(total - cums[r0]), et1 = expf(total - cums[r1]);
    const float wj0 = et0 * dts[r0], wj1 = et1 * dts[r1];
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      dxa[half][n][0] *= wj0;
      dxa[half][n][1] *= wj0;
      dxa[half][n][2] *= wj1;
      dxa[half][n][3] *= wj1;
    }
    if (t == 0) {
      ddto[r0] += et0 * u0;
      ddto[r1] += et1 * u1;
      dcum[r0] -= static_cast<double>(wj0 * u0);
      dcum[r1] -= static_cast<double>(wj1 * u1);
      wu += static_cast<double>(wj0 * u0) + static_cast<double>(wj1 * u1);
    }
  }

  // --- the (Q, Q) form, transposed: rows j of the warp's tiles, columns
  //     i >= j in 16 x 16 tiles
  __syncthreads();  // every reader of dh_out is done: the column sums take its place
  for (int p = threadIdx.x; p < kWarps * Qp; p += kThreads) part[p] = 0.f;
  __syncthreads();
  float* mypart = part + warp * Qp;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int mt = half == 0 ? warp : 2 * kWarps - 1 - warp;
    if (mt >= MT) continue;
    const int j0 = mt * 16, rj0 = j0 + g, rj1 = rj0 + 8;
    const float cj0 = cums[rj0], cj1 = cums[rj1], dj0 = dts[rj0], dj1 = dts[rj1];
    double rp0 = 0.0, rp1 = 0.0;  // row sums of s o dS
    float rg0 = 0.f, rg1 = 0.f;   // row sums of G o decay o dS
    const float* Gm = Gt + mt * MT * 256 + lane * 8;
    float4 g_next[2] = {ld4(Gm + mt * 256), ld4(Gm + mt * 256 + 4)};  // one tile ahead
#pragma unroll 1
    for (int it = mt; it < MT; ++it) {
      const float4 g0 = g_next[0], g1 = g_next[1];
      if (it + 1 < MT) {
        g_next[0] = ld4(Gm + (it + 1) * 256);
        g_next[1] = ld4(Gm + (it + 1) * 256 + 4);
      }
      const int i0 = it * 16;
      float dS[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dS[nt][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < NP; ++kd) {
        uint32_t a[4], bb[4];
        ldsm_x4(smem_addr(xs + (j0 + (lane & 15)) * kLd + kd * 16 + (lane >> 4) * 8), a[0], a[1],
                a[2], a[3]);
        ldsm_x4(smem_addr(ys + (i0 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kd * 16 +
                          ((lane >> 3) & 1) * 8),
                bb[0], bb[1], bb[2], bb[3]);
        mma(dS[0], a, bb[0], bb[1]);
        mma(dS[1], a, bb[2], bb[3]);
      }
      float sv[2][4], colp[2][2];
      float p0 = 0.f, p1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 ci = *reinterpret_cast<const float2*>(cums + i0 + nt * 8 + 2 * t);
        colp[nt][0] = colp[nt][1] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + nt * 8 + 2 * t + (e & 1);
          const int j = e < 2 ? rj0 : rj1;
          const float cij = (e & 1) ? ci.y : ci.x;
          // the mask inside the exp: exp(-inf) = 0, never inf * 0
          const float decay =
              exp2_approx(i >= j ? (cij - (e < 2 ? cj0 : cj1)) * kLog2e : -CUDART_INF_F);
          const float gd = at(nt == 0 ? g0 : g1, e) * decay;
          const float s = gd * (e < 2 ? dj0 : dj1);
          const float pv = s * dS[nt][e];
          if (e < 2) {
            p0 += pv;
            q0 = fmaf(gd, dS[nt][e], q0);
          } else {
            p1 += pv;
            q1 = fmaf(gd, dS[nt][e], q1);
          }
          colp[nt][e & 1] += pv;
          sv[nt][e] = s;
        }
      }
      rp0 += static_cast<double>(p0);
      rp1 += static_cast<double>(p1);
      rg0 += q0;
      rg1 += q1;
      // the column sums over the tile's 16 rows, into this warp's vector
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          float v = colp[nt][par];
          v += __shfl_xor_sync(kFullMask, v, 4);
          v += __shfl_xor_sync(kFullMask, v, 8);
          v += __shfl_xor_sync(kFullMask, v, 16);
          if (g == 0) mypart[i0 + nt * 8 + 2 * t + par] += v;
        }
      // dx_j += sum_i s_ij dy_i: s^T as the A fragment (hi + lo), dy by
      // ldmatrix.trans
      uint32_t ah[4], al[4];
      split_pair(sv[0][0], sv[0][1], ah[0], al[0]);
      split_pair(sv[0][2], sv[0][3], ah[1], al[1]);
      split_pair(sv[1][0], sv[1][1], ah[2], al[2]);
      split_pair(sv[1][2], sv[1][3], ah[3], al[3]);
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        uint32_t bb[4];
        ldsm_x4_t(smem_addr(ys + (i0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + np * 16 +
                            (lane >> 4) * 8),
                  bb[0], bb[1], bb[2], bb[3]);
        mma(dxa[half][2 * np], ah, bb[0], bb[1]);
        mma(dxa[half][2 * np], al, bb[0], bb[1]);
        mma(dxa[half][2 * np + 1], ah, bb[2], bb[3]);
        mma(dxa[half][2 * np + 1], al, bb[2], bb[3]);
      }
    }
    rp0 = quad_sum64(rp0);
    rp1 = quad_sum64(rp1);
    rg0 = quad_sum(rg0);
    rg1 = quad_sum(rg1);
    if (t == 0) {
      dcum[rj0] -= rp0;
      dcum[rj1] -= rp1;
      ddto[rj0] += rg0;
      ddto[rj1] += rg1;
    }
    bf16* dxb = dx + xoff;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int d = n * 8 + 2 * t;
      if (rj0 < nv) store_dx(dxb + rj0 * x_step, d, hd, dxa[half][n][0], dxa[half][n][1], vec);
      if (rj1 < nv) store_dx(dxb + rj1 * x_step, d, hd, dxa[half][n][2], dxa[half][n][3], vec);
    }
  }

  // --- the decay exponents: dcum gains the column sums (in warp order) and
  //     at Q-1 total's cotangent; da is the reverse prefix sum of dcum (fp64,
  //     rounded once); ddt = direct + A da; this chunk's share of dA =
  //     sum_t dt_t da_t (fp64)
  __syncthreads();
  const double wu_all = block_sum(wu, red);  // syncs
  const double dot_all = block_sum(static_cast<double>(dot), red);
  for (int p = threadIdx.x; p < Qp; p += kThreads) {
    double v = dcum[p];
    for (int w = 0; w < kWarps; ++w) v += part[w * Qp + p];
    dcum[p] = v;
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) dcum[Q - 1] += wu_all + expf(total) * dot_all;
    __syncwarp();
    double carry = 0.0, dA_acc = 0.0;
    for (int base = Qp - 32; base >= 0; base -= 32) {
      double v = dcum[base + lane];
      for (int off = 1; off < 32; off <<= 1) {
        const double n = __shfl_down_sync(kFullMask, v, off);
        if (lane + off < 32) v += n;
      }
      v += carry;
      carry = __shfl_sync(kFullMask, v, 0);
      const int p = base + lane, tt = c0 + p;
      const float da = static_cast<float>(v);
      if (p < Q && tt < S) ddt[(static_cast<long long>(b) * S + tt) * nh + head] =
          ddto[p] + a_head * da;
      dA_acc += static_cast<double>(dts[p] * da);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dA_acc += __shfl_down_sync(kFullMask, dA_acc, off);
    if (lane == 0) dAp[(static_cast<long long>(b) * nc + c) * nh + head] = dA_acc;
  }
}


// ---- the loop over a group's heads (launches 5 and 6) -------------------- //
// Head k of the group comes into stage k % stages through cp.async, started
// a head ahead with two stages; `convert` runs between two barriers before
// the head's products (nothing with one stage), `compute` after.
template <typename Fetch, typename Convert, typename Compute>
__device__ __forceinline__ void for_each_head(int hpg, int stages, Fetch fetch, Convert convert,
                                              Compute compute) {
  fetch(0, 0);
  cp_async_commit();
#pragma unroll 1
  for (int k = 0; k < hpg; ++k) {
    const int st = stages == 2 ? (k & 1) : 0;
    if (stages == 2 && k + 1 < hpg) fetch(k + 1, (k + 1) & 1);
    cp_async_commit();
    if (stages == 2) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (convert(st)) __syncthreads();
    compute(st);
    __syncthreads();  // every reader of this stage is done
    if (stages == 1 && k + 1 < hpg) {
      fetch(k + 1, 0);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
}

// ---- launch 5: the state terms of dB and dC, summed over a group's heads -- //
template <int HD, int DS>
struct GStateLayout {
  static constexpr int kLd = HD + 8, kLdh = DS + 8;
  // a stage: the rows (bf16), the head's state as it is in Hs / dHs, its
  // prefix sum and dt (fp32)
  __host__ __device__ static size_t stage_bytes(int Qp) {
    return sizeof(bf16) * static_cast<size_t>(Qp) * kLd +
           sizeof(float) * (static_cast<size_t>(HD) * DS + 2 * Qp);
  }
  static size_t hilo_bytes() { return sizeof(bf16) * 2 * HD * kLdh; }
  static int stages(int Qp) {
    return 2 * stage_bytes(Qp) + hilo_bytes() <= static_cast<size_t>(kMaxSmem) ? 2 : 1;
  }
  static size_t smem_bytes(int Qp) { return stages(Qp) * stage_bytes(Qp) + hilo_bytes(); }
};

// kDB false: dC_i = sum_h exp(cum_i) (dy h_in)_i; true: dB_j = sum_h wj_j
// (x dh_out)_j. Every row of the chunk; warp w owns row tiles w and w + 8.
template <bool kDB, int HD, int DS>
__device__ __forceinline__ void gstate_body(const bf16* __restrict__ x,
                                            const bf16* __restrict__ dy,
                                            const float* __restrict__ cumw,
                                            const float* __restrict__ Hs,
                                            const float* __restrict__ dHs,
                                            float* __restrict__ dBm, float* __restrict__ dCm,
                                            int S, int nh, int hd, int ng, int ds, int Q, int Qp,
                                            int nc, bool vec, int stages) {
  using L = GStateLayout<HD, DS>;
  constexpr int kLd = L::kLd, kLdh = L::kLdh, NP = HD / 16, NN = DS / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t sb = L::stage_bytes(Qp);
  bf16* hs_hi = reinterpret_cast<bf16*>(smem_raw + stages * sb);  // HD x kLdh, s natural
  bf16* hs_lo = hs_hi + HD * kLdh;
  auto rows_of = [&](int st) { return reinterpret_cast<bf16*>(smem_raw + st * sb); };
  auto raw_of = [&](int st) { return reinterpret_cast<float*>(rows_of(st) + Qp * kLd); };
  auto vec_of = [&](int st) { return raw_of(st) + HD * DS; };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int z = blockIdx.z, grp = z % ng, bc = z / ng, c = bc % nc, b = bc / nc;
  const int c0 = c * Q, nv = min(Q, S - c0), MT = Qp / 16;
  const int hpg = nh / ng;
  const long long x_step = static_cast<long long>(nh) * hd;
  const bf16* rsrc = kDB ? x : dy;
  const float* state = kDB ? dHs : Hs;
  float acc[2][NN][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;

  auto fetch = [&](int k, int st) {
    const int head = grp * hpg + k;
    const long long base = (static_cast<long long>(b) * S + c0) * x_step + static_cast<long long>(head) * hd;
    load_rows<HD>(rows_of(st), rsrc + base, x_step, Qp, nv, hd, vec, rsrc);
    const long long bhc = (static_cast<long long>(b) * nh + head) * nc + c;
    copy_floats(raw_of(st), state + bhc * hd * ds, hd * ds);
    copy_floats(vec_of(st), cumw + bhc * 2 * Qp, 2 * Qp);
  };
  auto convert = [&](int st) {  // the head's state, hi + lo, [d][s]
    const float* raw = raw_of(st);
    for (int idx = threadIdx.x; idx < HD * (DS / 2); idx += kThreads) {
      const int d = idx / (DS / 2), s = (idx - d * (DS / 2)) * 2;
      const float v0 = (d < hd && s < ds) ? raw[d * ds + s] : 0.f;
      const float v1 = (d < hd && s + 1 < ds) ? raw[d * ds + s + 1] : 0.f;
      uint32_t hi, lo;
      split_pair(v0, v1, hi, lo);
      *reinterpret_cast<uint32_t*>(hs_hi + d * kLdh + s) = hi;
      *reinterpret_cast<uint32_t*>(hs_lo + d * kLdh + s) = lo;
    }
    return true;
  };
  auto compute = [&](int st) {
    const bf16* rt = rows_of(st);
    const float* cumv = vec_of(st);
    const float* dtv = cumv + Qp;
    const float total = cumv[Q - 1];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int mt = warp + kWarps * mi;
      if (mt >= MT) continue;
      uint32_t ar[NP][4];
#pragma unroll
      for (int kd = 0; kd < NP; ++kd)
        ldsm_x4(smem_addr(rt + (mt * 16 + (lane & 15)) * kLd + kd * 16 + (lane >> 4) * 8),
                ar[kd][0], ar[kd][1], ar[kd][2], ar[kd][3]);
      const int r0 = mt * 16 + g, r1 = r0 + 8;
      const float sc0 = kDB ? expf(total - cumv[r0]) * dtv[r0] : expf(cumv[r0]);
      const float sc1 = kDB ? expf(total - cumv[r1]) * dtv[r1] : expf(cumv[r1]);
#pragma unroll
      for (int np = 0; np < DS / 16; ++np) {
        float t8[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) t8[nt][e] = 0.f;
#pragma unroll
        for (int kd = 0; kd < NP; ++kd) {
          const int off =
              (kd * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdh + np * 16 + (lane >> 4) * 8;
          uint32_t bh4[4], bl4[4];
          ldsm_x4_t(smem_addr(hs_hi + off), bh4[0], bh4[1], bh4[2], bh4[3]);
          ldsm_x4_t(smem_addr(hs_lo + off), bl4[0], bl4[1], bl4[2], bl4[3]);
          mma(t8[0], ar[kd], bh4[0], bh4[1]);
          mma(t8[0], ar[kd], bl4[0], bl4[1]);
          mma(t8[1], ar[kd], bh4[2], bh4[3]);
          mma(t8[1], ar[kd], bl4[2], bl4[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mi][2 * np + nt][e] = fmaf(e < 2 ? sc0 : sc1, t8[nt][e], acc[mi][2 * np + nt][e]);
      }
    }
  };
  for_each_head(hpg, stages, fetch, convert, compute);
  float* dst = kDB ? dBm : dCm;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int mt = warp + kWarps * mi;
    if (mt >= MT) continue;
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = mt * 16 + g + 8 * (e >> 1), s = n * 8 + 2 * t + (e & 1);
        if (p < nv && s < ds)
          dst[((static_cast<long long>(b) * S + c0 + p) * ng + grp) * ds + s] = acc[mi][n][e];
      }
  }
}

// One CTA per (product, b x chunk x group); blockIdx.x picks the product:
// 0 dC, 1 dB
template <int HD, int DS>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_gstate_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                      const float* __restrict__ cumw, const float* __restrict__ Hs,
                      const float* __restrict__ dHs, float* __restrict__ dBm,
                      float* __restrict__ dCm, int S, int nh, int hd, int ng, int ds, int Q,
                      int Qp, int nc, int vec, int stages) {
  if (blockIdx.x == 0)
    gstate_body<false, HD, DS>(x, dy, cumw, Hs, dHs, dBm, dCm, S, nh, hd, ng, ds, Q, Qp, nc,
                               vec != 0, stages);
  else
    gstate_body<true, HD, DS>(x, dy, cumw, Hs, dHs, dBm, dCm, S, nh, hd, ng, ds, Q, Qp, nc,
                              vec != 0, stages);
}

// ---- launch 6: the head-summed factor, one causal 64 x 64 tile at a time -- //
// One CTA per (tile pair it >= jt, b x chunk x group) walks the group's
// heads in order and sums M^h = w^h o dS^h over them for its tile only (in
// its warps' registers: 16 floats a thread), so each element of the factor
// is formed once. After the last head it multiplies the tile by B's rows jt
// (dC's share for the rows it) and, transposed, by C's rows it (dB's share
// for the rows jt), into the workspace part; launch 7 adds the shares.
template <int HD, int DS>
struct PairLayout {
  static constexpr int kLd = HD + 8, kT = kGT;
  static constexpr int kLdm = kT + 1;  // the factor staged for its transpose
  static constexpr int kLdo = DS + 4;  // an output tile
  // a stage: dy's rows it and x's rows jt (bf16), the head's prefix sum and
  // dt (fp32)
  __host__ __device__ static size_t stage_bytes(int Qp) {
    return sizeof(bf16) * 2 * kT * kLd + sizeof(float) * 2 * static_cast<size_t>(Qp);
  }
  static size_t smem_bytes(int Qp) {
    const size_t s = 2 * stage_bytes(Qp);
    const size_t end = sizeof(float) * (kT * kLdm + kT * kLdo);
    return s > end ? s : end;
  }
};

// out (kT x kLdo, zeroed first) += a (the warps' A fragments: rows m16 of
// warp & 3, two k16 blocks of half warp >> 2, hi + lo) times F's rows kt0 +
// (warp >> 2) * 2 + kb (B order), the halves added in order; then the tile
// goes to dst (kT x DS)
template <int DS>
__device__ __forceinline__ void tile_product(float* out, const uint32_t (&ah)[2][4],
                                             const uint32_t (&al)[2][4], const float* F,
                                             int kt0, float* dst) {
  constexpr int kLdo = DS + 4, NT = DS / 8, kT = kGT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m = warp & 3, half = warp >> 2;
  for (int idx = threadIdx.x; idx < kT * kLdo; idx += kThreads) out[idx] = 0.f;
  __syncthreads();
#pragma unroll 1
  for (int turn = 0; turn < 2; ++turn) {
    if (half == turn) {
#pragma unroll 1
      for (int sp = 0; sp < DS / 16; ++sp) {
        float p8[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) p8[nt][e] = 0.f;
#pragma unroll
        for (int kb = 0; kb < 2; ++kb) {
          const int kt = kt0 + half * 2 + kb;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const float4 f = ld4(F + ((kt * NT + 2 * sp + nt) * 32 + lane) * 4);
            uint32_t fh0, fl0, fh1, fl1;
            split_pair(f.x, f.y, fh0, fl0);
            split_pair(f.z, f.w, fh1, fl1);
            mma(p8[nt], ah[kb], fh0, fh1);
            mma(p8[nt], ah[kb], fl0, fl1);
            mma(p8[nt], al[kb], fh0, fh1);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            out[(m * 16 + g + 8 * (e >> 1)) * kLdo + sp * 16 + nt * 8 + 2 * t + (e & 1)] +=
                p8[nt][e];
      }
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < kT * (DS / 4); idx += kThreads) {
    const int r = idx / (DS / 4), s = (idx - r * (DS / 4)) * 4;
    *reinterpret_cast<float4*>(dst + r * DS + s) =
        make_float4(out[r * kLdo + s], out[r * kLdo + s + 1], out[r * kLdo + s + 2],
                    out[r * kLdo + s + 3]);
  }
}

template <int HD, int DS>
__global__ void __launch_bounds__(kThreads, 3)
ssd_bwd_pair_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                    const float* __restrict__ W, const float* __restrict__ cumw,
                    float* __restrict__ part, int S, int nh, int hd, int ng, int ds, int Q,
                    int Qp, int nc, int vec) {
  using L = PairLayout<HD, DS>;
  constexpr int kLd = L::kLd, NP = HD / 16, kT = L::kT, kLdm = L::kLdm;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t sb = L::stage_bytes(Qp);
  auto rows_of = [&](int st) { return reinterpret_cast<bf16*>(smem_raw + st * sb); };
  auto cols_of = [&](int st) { return rows_of(st) + kT * kLd; };
  auto vec_of = [&](int st) { return reinterpret_cast<float*>(cols_of(st) + kT * kLd); };

  int tile = blockIdx.x, it = 0;
  while (tile > it) {
    tile -= it + 1;
    ++it;
  }
  const int jt = tile, i0 = it * kT, j0 = jt * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int z = blockIdx.z, grp = z % ng, bc = z / ng, c = bc % nc, b = bc / nc;
  const int c0 = c * Q, nv = min(Q, S - c0), hpg = nh / ng;
  const long long x_step = static_cast<long long>(nh) * hd;
  const int m = warp & 3, half = warp >> 2;  // row tile; half of the columns
  const int ri0 = i0 + m * 16 + g, ri1 = ri0 + 8;
  float msum[2][2][4];  // rows ri, columns j0 + half * 32 + 16 blk + permuted
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) msum[k][nt][e] = 0.f;

  auto fetch = [&](int k, int st) {  // head k of the group into stage st
    const int head = grp * hpg + k;
    const long long base = (static_cast<long long>(b) * S + c0) * x_step + static_cast<long long>(head) * hd;
    load_rows<HD>(rows_of(st), dy + base + i0 * x_step, x_step, kT, nv - i0, hd, vec != 0, dy);
    load_rows<HD>(cols_of(st), x + base + j0 * x_step, x_step, kT, nv - j0, hd, vec != 0, x);
    const long long bhc = (static_cast<long long>(b) * nh + head) * nc + c;
    copy_floats(vec_of(st), cumw + bhc * 2 * Qp, 2 * Qp);
  };
  auto compute = [&](int st) {
    const bf16* rt = rows_of(st);
    const bf16* ct = cols_of(st);
    const float* cumv = vec_of(st);
    const float* dtv = cumv + Qp;
    uint32_t ar[NP][4];  // dy's rows: the A fragments (m16 x hd)
#pragma unroll
    for (int kd = 0; kd < NP; ++kd)
      ldsm_x4(smem_addr(rt + (m * 16 + (lane & 15)) * kLd + kd * 16 + (lane >> 4) * 8), ar[kd][0],
              ar[kd][1], ar[kd][2], ar[kd][3]);
    const float cr0 = cumv[ri0], cr1 = cumv[ri1];
#pragma unroll
    for (int blk = 0; blk < 2; ++blk) {
      // x's rows through ldmatrix in the workspace's permuted order
      const int bc_ = half * 32 + blk * 16;
      float d8[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) d8[nt][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < NP; ++kd) {
        uint32_t bb[4];
        ldsm_x4(smem_addr(ct + (bc_ + perm_row(lane & 7, (lane >> 4) & 1)) * kLd + kd * 16 +
                          ((lane >> 3) & 1) * 8),
                bb[0], bb[1], bb[2], bb[3]);
        mma(d8[0], ar[kd], bb[0], bb[1]);
        mma(d8[1], ar[kd], bb[2], bb[3]);
      }
      const int cb = j0 + bc_ + 4 * t;  // this lane's columns cb .. cb + 3
      const float4 cc = ld4(cumv + cb);
      const float4 dd = ld4(dtv + cb);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int a = 2 * nt + (e & 1);
          const int row = e < 2 ? ri0 : ri1;
          // M[i][j] = exp(cum_i - cum_j) dt_j dS_ij, the mask inside the exp
          const float w = exp2_approx(row >= cb + a ? ((e < 2 ? cr0 : cr1) - at(cc, a)) * kLog2e
                                                    : -CUDART_INF_F) *
                          at(dd, a);
          msum[blk][nt][e] = fmaf(w, d8[nt][e], msum[blk][nt][e]);
        }
    }
  };
  for_each_head(hpg, 2, fetch, [](int) { return false; }, compute);

  const float* Wb = W + ((static_cast<long long>(b) * ng + grp) * nc + c) * block_floats(Qp, DS);
  const float* CB = Wb + static_cast<long long>(Qp) * Qp + static_cast<long long>(Qp) * DS;
  const float* BB = CB + static_cast<long long>(Qp) * DS;
  float* Pz = part + (static_cast<long long>(z) * gridDim.x + blockIdx.x) * 2 * kT * DS;
  float* mt_ = reinterpret_cast<float*>(smem_raw);  // kT x kLdm: the factor, [i][j]
  float* out = mt_ + kT * kLdm;                     // kT x kLdo
  // dC's share: the factor (rows i, k = j as it stands) times B's rows jt
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int blk = 0; blk < 2; ++blk) {
    split_pair(msum[blk][0][0], msum[blk][0][1], ah[blk][0], al[blk][0]);
    split_pair(msum[blk][0][2], msum[blk][0][3], ah[blk][1], al[blk][1]);
    split_pair(msum[blk][1][0], msum[blk][1][1], ah[blk][2], al[blk][2]);
    split_pair(msum[blk][1][2], msum[blk][1][3], ah[blk][3], al[blk][3]);
    // ... and the factor itself into shared memory at its actual columns
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mt_[(m * 16 + g + 8 * (e >> 1)) * kLdm + half * 32 + blk * 16 + 4 * t + 2 * nt + (e & 1)] =
            msum[blk][nt][e];
  }
  tile_product<DS>(out, ah, al, BB, j0 >> 4, Pz);  // syncs first
  // dB's share: the factor transposed (rows j of warp & 3, k = i of half
  // warp >> 2 in the permuted order) times C's rows it
#pragma unroll
  for (int kb = 0; kb < 2; ++kb) {
    const int ib = half * 32 + kb * 16 + 4 * t;
    const int jr = m * 16 + g;
    split_pair(mt_[ib * kLdm + jr], mt_[(ib + 1) * kLdm + jr], ah[kb][0], al[kb][0]);
    split_pair(mt_[ib * kLdm + jr + 8], mt_[(ib + 1) * kLdm + jr + 8], ah[kb][1], al[kb][1]);
    split_pair(mt_[(ib + 2) * kLdm + jr], mt_[(ib + 3) * kLdm + jr], ah[kb][2], al[kb][2]);
    split_pair(mt_[(ib + 2) * kLdm + jr + 8], mt_[(ib + 3) * kLdm + jr + 8], ah[kb][3],
               al[kb][3]);
  }
  __syncthreads();  // out's readers are done before it is zeroed again
  tile_product<DS>(out, ah, al, CB, i0 >> 4, Pz + kT * DS);
}

// ---- launch 7: dB and dC = the state terms + the tile pairs' shares ------- //
// One thread per element of a 64-row tile r: dC's rows add the pairs (r,
// jt) for jt = 0 .. r in order, dB's rows the pairs (it, r) for it = r ..
// in order, onto launch 5's state terms.
__global__ void __launch_bounds__(256)
ssd_bwd_pair_sum(const float* __restrict__ part, float* __restrict__ dBm,
                 float* __restrict__ dCm, int S, int ng, int ds, int DS, int Q, int Qp,
                 int nc) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= kGT * ds) return;
  const int role = blockIdx.y & 1, r = blockIdx.y >> 1;
  const int z = blockIdx.z, grp = z % ng, bc = z / ng, c = bc % nc, b = bc / nc;
  const int rr = e / ds, s = e - rr * ds;
  const int p = r * kGT + rr, c0 = c * Q;
  if (p >= min(Q, S - c0)) return;
  const int nt = Qp / kGT, npairs = nt * (nt + 1) / 2;
  const long long tsz = static_cast<long long>(kGT) * DS;
  const float* Pz = part + static_cast<long long>(z) * npairs * 2 * tsz + rr * DS + s;
  float* dst = role ? dBm : dCm;
  const long long o = ((static_cast<long long>(b) * S + c0 + p) * ng + grp) * ds + s;
  float v = dst[o];
  if (role == 0) {
    for (int jt = 0; jt <= r; ++jt) v += Pz[(r * (r + 1) / 2 + jt) * 2 * tsz];
  } else {
    for (int it = r; it < nt; ++it) v += Pz[((it * (it + 1) / 2 + r) * 2 + 1) * tsz];
  }
  dst[o] = v;
}

// ---- launch ---------------------------------------------------------------- //
struct Args {
  const bf16* x;
  const float* dt;
  const float* A;
  const float* Bm;
  const float* Cm;
  const bf16* dy;
  const float* dh_final;
  float* W;
  float* cumw;
  float* Hs;
  float* dHs;
  float* tot;
  double* dAp;
  bf16* dx;
  float* ddt;
  float* dA;
  float* dBm;
  float* dCm;
  float* part;
  int Bt, S, nh, hd, ng, ds, Q, nc, Qp, vec;
  cudaStream_t st;
};

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int HD, int DS>
size_t max_smem(int Qp) {
  const size_t v[4] = {StateLayout<HD, DS>::smem_bytes(Qp), ChunkLayout<HD, DS>::smem_bytes(Qp),
                       GStateLayout<HD, DS>::smem_bytes(Qp), PairLayout<HD, DS>::smem_bytes(Qp)};
  size_t m = 0;
  for (size_t b : v) m = b > m ? b : m;
  return m;
}

inline size_t smem_needed(int hd, int ds, int Q) {
  const int Qp = padded_q(Q);
  if (padded_dim(hd) == 64)
    return padded_dim(ds) == 64 ? max_smem<64, 64>(Qp) : max_smem<64, 128>(Qp);
  return padded_dim(ds) == 64 ? max_smem<128, 64>(Qp) : max_smem<128, 128>(Qp);
}

template <int HD, int DS>
int launch_dims(const Args& a) {
  const size_t s2 = StateLayout<HD, DS>::smem_bytes(a.Qp);
  const size_t s4 = ChunkLayout<HD, DS>::smem_bytes(a.Qp);
  const size_t s5 = GStateLayout<HD, DS>::smem_bytes(a.Qp);
  const size_t s6 = PairLayout<HD, DS>::smem_bytes(a.Qp);
  cudaError_t err = set_smem(ssd_bwd_state_kernel<HD, DS>, s2);
  if (err == cudaSuccess) err = set_smem(ssd_bwd_chunk_kernel_tc<HD, DS>, s4);
  if (err == cudaSuccess) err = set_smem(ssd_bwd_gstate_kernel<HD, DS>, s5);
  if (err == cudaSuccess) err = set_smem(ssd_bwd_pair_kernel<HD, DS>, s6);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.nh, a.nc, a.Bt);
  ssd_bwd_state_kernel<HD, DS><<<grid, kThreads, s2, a.st>>>(
      a.x, a.dt, a.A, a.W, a.dy, a.Hs, a.dHs, a.tot, a.cumw, a.S, a.nh, a.hd, a.ng, a.ds, a.Q,
      a.Qp, a.vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid3((a.hd * a.ds + kThreads - 1) / kThreads, a.nh, a.Bt);
  ssd_bwd_walk<<<grid3, kThreads, 0, a.st>>>(a.Hs, a.dHs, a.tot, a.dh_final, a.nh, a.hd, a.ds,
                                              a.nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk_kernel_tc<HD, DS><<<grid, kThreads, s4, a.st>>>(
      a.x, a.A, a.Cm, a.dy, a.W, a.cumw, a.Hs, a.dHs, a.dx, a.ddt, a.dAp, a.S, a.nh, a.hd, a.ng,
      a.ds, a.Q, a.Qp, a.vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_gstate_kernel<HD, DS><<<dim3(2, 1, a.Bt * a.nc * a.ng), kThreads, s5, a.st>>>(
      a.x, a.dy, a.cumw, a.Hs, a.dHs, a.dBm, a.dCm, a.S, a.nh, a.hd, a.ng, a.ds, a.Q, a.Qp, a.nc,
      a.vec, GStateLayout<HD, DS>::stages(a.Qp));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = a.Qp / kGT, nz = a.Bt * a.nc * a.ng;
  ssd_bwd_pair_kernel<HD, DS><<<dim3(nt * (nt + 1) / 2, 1, nz), kThreads, s6, a.st>>>(
      a.x, a.dy, a.W, a.cumw, a.part, a.S, a.nh, a.hd, a.ng, a.ds, a.Q, a.Qp, a.nc, a.vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_pair_sum<<<dim3((kGT * a.ds + 255) / 256, 2 * nt, nz), 256, 0, a.st>>>(
      a.part, a.dBm, a.dCm, a.S, a.ng, a.ds, DS, a.Q, a.Qp, a.nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dA<<<(a.nh + 127) / 128, 128, 0, a.st>>>(a.dAp, a.dA, a.Bt, a.nc, a.nh);
  return static_cast<int>(cudaGetLastError());
}

int launch(const Args& a) {
  const int DS = padded_dim(a.ds), n_it = a.Qp / kGT;
  const size_t sg = gram_smem_bytes(a.ds);
  cudaError_t err = set_smem(ssd_bwd_gram_kernel, sg);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_gram_kernel<<<dim3(a.nc, n_it * (n_it + 1) / 2, a.Bt * a.ng), 256, sg, a.st>>>(
      a.Bm, a.Cm, a.W, a.S, a.ng, a.ds, DS, a.Q, a.Qp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (padded_dim(a.hd) == 64)
    return DS == 64 ? launch_dims<64, 64>(a) : launch_dims<64, 128>(a);
  return DS == 64 ? launch_dims<128, 64>(a) : launch_dims<128, 128>(a);
}

}  // namespace tc


bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0; }

}  // namespace

// fp32 x: the FMA route. The wrapper's workspaces: Hs, dHs (Bt, nh, nc,
// hd, ds) fp32; tot (Bt, nh, nc) fp32; dBp, dCp (Bt, S, nh, ds) fp32; dAp
// (Bt, nc, nh) fp64; nc = ceil(S / Q). dh_final may be null (a zero
// cotangent).
extern "C" int repro_ssd_chunk_scan_bwd_f32(
    const void* x, const float* dt, const float* A, const float* Bm, const float* Cm,
    const void* dy, const float* dh_final, float* Hs, float* dHs, float* tot, float* dBp,
    float* dCp, double* dAp, void* dx, float* ddt, float* dA, float* dBm, float* dCm, int Bt,
    int S, int nh, int hd, int ng, int ds, int Q, void* stream) {
  if (Bt <= 0 || S <= 0 || nh <= 0 || hd <= 0 || ds <= 0 || ng <= 0 || nh % ng != 0 ||
      hd > kMaxDim || ds > kMaxDim || Q <= 0 ||
      chunk_smem_bytes(hd, ds, Q) > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, dt, A, Bm, Cm, dy, dh_final, Hs, dHs, tot, dBp, dCp, dAp, dx, ddt, dA,
               dBm, dCm, Bt, S, nh, hd, ng, ds, Q, (S + Q - 1) / Q,
               static_cast<cudaStream_t>(stream)};
  return launch_dims<float>(a);
}

// bf16 x: the tensor-core route. The wrapper's workspaces: W (Bt, ng, nc,
// Qp (Qp + 3 DS)) fp32 (launch 1's G^T, B and C); cumw (Bt, nh, nc, 2 Qp)
// fp32 (each chunk's prefix sum and dt); part (Bt, nc, ng, nt (nt + 1) / 2,
// 2, 64, DS) fp32 (launch 6's shares, nt = Qp / 64); Hs, dHs, tot and dAp
// as the fp32 route's. Qp = Q rounded up to 64, DS = ds rounded up to 64 or
// 128; Q <= 256; Bt nc ng <= 65535, launches 5-7's grid z (the wrapper
// says so first). dh_final may be null.
extern "C" int repro_ssd_chunk_scan_bwd_bf16(
    const void* x, const float* dt, const float* A, const float* Bm, const float* Cm,
    const void* dy, const float* dh_final, float* W, float* cumw, float* Hs, float* dHs,
    float* tot, double* dAp, float* part, void* dx, float* ddt, float* dA, float* dBm,
    float* dCm, int Bt, int S, int nh, int hd, int ng, int ds, int Q, void* stream) {
  const long long nc = Q > 0 ? (static_cast<long long>(S) + Q - 1) / Q : 0;
  if (Bt <= 0 || S <= 0 || nh <= 0 || hd <= 0 || ds <= 0 || ng <= 0 || nh % ng != 0 ||
      hd > kMaxDim || ds > kMaxDim || Q <= 0 || Q > tc::kMaxQ || Bt > 65535 || nc > 65535 ||
      Bt * nc * ng > 65535 || tc::smem_needed(hd, ds, Q) > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = hd % 8 == 0 && aligned16(x) && aligned16(dy) && aligned16(dx);
  const tc::Args a{static_cast<const __nv_bfloat16*>(x), dt, A, Bm, Cm,
                   static_cast<const __nv_bfloat16*>(dy), dh_final, W, cumw, Hs, dHs, tot, dAp,
                   static_cast<__nv_bfloat16*>(dx), ddt, dA, dBm, dCm, part, Bt, S, nh, hd, ng, ds, Q,
                   static_cast<int>(nc), padded_q(Q), vec ? 1 : 0,
                   static_cast<cudaStream_t>(stream)};
  return tc::launch(a);
}

// Dynamic shared memory the larger kernel of a route needs at (hd, ds, Q);
// a launch refuses more than a block's 232,448 bytes, and the wrapper
// checks first, to say why.
extern "C" long long repro_ssd_bwd_smem_bytes(int hd, int ds, int Q) {
  return static_cast<long long>(chunk_smem_bytes(hd, ds, Q));
}

extern "C" long long repro_ssd_bwd_bf16_smem_bytes(int hd, int ds, int Q) {
  if (hd <= 0 || ds <= 0 || hd > kMaxDim || ds > kMaxDim || Q <= 0 || Q > tc::kMaxQ) return -1;
  return static_cast<long long>(tc::smem_needed(hd, ds, Q));
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
