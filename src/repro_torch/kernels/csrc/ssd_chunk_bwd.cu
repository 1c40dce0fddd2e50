// Hand-written Hopper (sm_90a) kernels of the backward of the Mamba2 / SSD
// chunked scan. Plain C interface, loaded with ctypes (kernels/ssd_chunk.py:
// ssd_chunk_scan_bwd); built by kernels/_build.py with nvcc, without
// fast-math or flush-to-zero.
//
// repro_ssd_chunk_scan_bwd replaces no TPU kernel: the Pallas kernel
//   repro/kernels/ssd_chunk.py: ssd_chunk_scan (pallas_call at :105) is a
//   serving-only forward with no custom_vjp, and the reference trains its
//   mamba layers by differentiating its pure-JAX chunk loop
//   (repro/models/mamba2.py: ssd_scan, :52). In the port the forward IS the
//   kernel (csrc/ssd_chunk.cu), so its training needs this backward: the
//   vector-Jacobian product of the forward, as kernels/ref.py:
//   ssd_chunk_scan_bwd_ref writes it out. Per chunk of Q positions, with
//   a = dt A, cum its inclusive prefix sum, total = cum[Q-1], h_in the
//   state entering the chunk and dh_out the cotangent of the state leaving
//   it, w_ij = exp(cum_i - cum_j) dt_j (i >= j), s_ij = (C_i . B_j) w_ij,
//   dS_ij = dy_i . x_j and wj_j = exp(total - cum_j) dt_j:
//     dh_in = exp(total) dh_out + sum_i exp(cum_i) dy_i (x) C_i
//     dx_j  = sum_{i>=j} s_ij dy_i + wj_j dh_out B_j
//     dC_i  = sum_{j<=i} w_ij dS_ij B_j + exp(cum_i) h_in^T dy_i
//     dB_j  = sum_{i>=j} w_ij dS_ij C_i + wj_j dh_out^T x_j
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
//   dB and dC sum over the heads of a group.
//
// Five launches on the caller's stream, no float atomics, every sum in a
// fixed order (two runs give the same bits):
//   1. ssd_bwd_chunk_state: one CTA per (chunk, head, b) forms the chunk's
//      own state contributions, sum_j wj_j x_j (x) B_j and
//      sum_i exp(cum_i) dy_i (x) C_i, into the workspaces Hs and dHs
//      (B, nh, nc, hd, ds), and the chunk's total decay.
//   2. ssd_bwd_state_pass: one thread per state element walks the chunks in
//      order (Hs becomes each chunk's entering state h_in) and in reverse
//      (dHs becomes each chunk's dh_out, starting from dh_final): the only
//      sequential pass, elementwise and bound by its bytes.
//   3. ssd_bwd_chunk_kernel: one CTA per (chunk, head, b), parallel over all
//      of them. h_in's terms first (dC's initial rows, dcum), then dh_out's
//      and the (Q, Q) form in 64 x 64 tiles, j tiles outside: a j tile's dx
//      and dB (per head) stay in registers across the i tiles i >= j and are
//      written once; the i tiles' dC rows (per head) are this CTA's own, so
//      it adds into them in global memory (L2) without atomics. G = C B^T
//      and dS = dy x^T are formed in registers (4 x 4 a thread), s and then
//      dG staged in shared memory for the three products. dcum and ddt's
//      direct terms collect in shared memory through fixed-order row and
//      column sums (dcum in fp64: its row and column sums cancel, and dA
//      weighs its errors by the chunk's summed dt); the chunk's reverse
//      prefix sum gives ddt, and the chunk's share of dA goes to a
//      per-(b, chunk, head) fp64 workspace.
//   4. ssd_bwd_group_sum: dB and dC summed over the heads of each group in
//      head order.
//   5. ssd_bwd_dA: dA summed over (b, chunk) in that order, in fp64.
//   fp32 FMAs from shared memory throughout, both routes: bf16 x and dy are
//   widened on load, dx rounded once to bf16 on the way out. Every tile's
//   product reads one operand as a broadcast and the other at a stride of
//   65 (or hd + 1) floats, so no shared-memory bank is read twice a step.
//   CTAs of 256 threads: two an SM at zamba2's widths (hd = ds = 64, Q =
//   256: 115,264 bytes of shared memory each, 128 registers a thread), one
//   at mamba2-2.7b's (hd 64, ds 128: 165,184 bytes; 231,232 at hd = ds =
//   128).
//
//   Bound on an H100 SXM: operations. At mamba2-2.7b's training operands
//   (B=4, S=4096, nh=80, hd=64, ng=1, ds=128, Q=256) the function reads
//   x, dy, dt, A, B and C and writes dx, ddt, dA, dB and dC (547 MB:
//   0.16 ms at 3.35 TB/s); its products (chip_smoke.py: ssd_bwd_work
//   counts them) are 152 GFLOP: 0.31 ms at the 495 TFLOP/s of TF32 tensor
//   cores (the rate the forward's bound takes for its fp32 operands), 2.3
//   ms at the 67 TFLOP/s of fp32 FMAs, the route taken here, which also
//   recomputes C B^T for every head (280 GFLOP of FMAs in all). Tensor
//   cores (mma.sync / wgmma) and a C B^T shared by the heads of a group
//   are for a redesign.
//
// Launches on the caller's stream, allocates nothing (the wrapper allocates
// the workspaces), does not synchronize, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

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
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_pass(float* __restrict__ Hs, float* __restrict__ dHs,
                   const float* __restrict__ tot, const float* __restrict__ dh_final, int nh,
                   int hd, int ds, int nc) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int n = hd * ds;
  if (e >= n) return;
  const long long bh = static_cast<long long>(blockIdx.z) * nh + blockIdx.y;
  const float* tb = tot + bh * nc;
  float* hb = Hs + bh * nc * n + e;
  float* db = dHs + bh * nc * n + e;
  float carry = 0.f;
  for (int c = 0; c < nc; ++c) {  // as the forward: h <- exp(total) h + local
    const float local = hb[static_cast<long long>(c) * n];
    hb[static_cast<long long>(c) * n] = carry;
    carry = carry * expf(tb[c]) + local;
  }
  carry = dh_final != nullptr ? dh_final[bh * n + e] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {  // dh_in = exp(total) dh_out + local
    const float local = db[static_cast<long long>(c) * n];
    db[static_cast<long long>(c) * n] = carry;
    carry = carry * expf(tb[c]) + local;
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
  ssd_bwd_state_pass<<<grid2, kThreads, 0, a.st>>>(a.Hs, a.dHs, a.tot, a.dh_final, a.nh, a.hd,
                                                     a.ds, a.nc);
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

}  // namespace

// The wrapper's workspaces: Hs, dHs (Bt, nh, nc, hd, ds) fp32; tot (Bt, nh,
// nc) fp32; dBp, dCp (Bt, S, nh, ds) fp32; dAp (Bt, nc, nh) fp64;
// nc = ceil(S / Q). dh_final may be null (a zero cotangent). x_bf16 picks
// the route: x, dy and dx bf16 (1) or fp32 (0).
extern "C" int repro_ssd_chunk_scan_bwd(
    const void* x, const float* dt, const float* A, const float* Bm, const float* Cm,
    const void* dy, const float* dh_final, float* Hs, float* dHs, float* tot, float* dBp,
    float* dCp, double* dAp, void* dx, float* ddt, float* dA, float* dBm, float* dCm, int Bt,
    int S, int nh, int hd, int ng, int ds, int Q, int x_bf16, void* stream) {
  if (Bt <= 0 || S <= 0 || nh <= 0 || hd <= 0 || ds <= 0 || ng <= 0 || nh % ng != 0 ||
      hd > kMaxDim || ds > kMaxDim || Q <= 0 ||
      chunk_smem_bytes(hd, ds, Q) > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, dt, A, Bm, Cm, dy, dh_final, Hs, dHs, tot, dBp, dCp, dAp, dx, ddt, dA,
               dBm, dCm, Bt, S, nh, hd, ng, ds, Q, (S + Q - 1) / Q,
               static_cast<cudaStream_t>(stream)};
  return x_bf16 ? launch_dims<__nv_bfloat16>(a) : launch_dims<float>(a);
}

// Dynamic shared memory the chunk kernel (the larger of the two) needs at
// (hd, ds, Q); the launch refuses more than a block's 232,448 bytes, and the
// wrapper checks first, to say why.
extern "C" long long repro_ssd_bwd_smem_bytes(int hd, int ds, int Q) {
  return static_cast<long long>(chunk_smem_bytes(hd, ds, Q));
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
