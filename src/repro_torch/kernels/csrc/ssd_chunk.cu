// Hand-written Hopper (sm_90a) kernel of the Mamba2 / SSD chunked scan.
// Plain C interface, loaded with ctypes (kernels/ssd_chunk.py); built by
// kernels/_build.py with nvcc, without fast-math or flush-to-zero.
//
// repro_ssd_chunk_scan_{f32,bf16} replace the Pallas kernel
//   repro/kernels/ssd_chunk.py: ssd_chunk_scan (_kernel, pallas_call at :105).
//   x (B, S, nh, hd) fp32 or bf16, dt (B, S, nh) fp32 (post-softplus),
//   A (nh,) fp32 (negative), Bm/Cm (B, S, ng, ds) fp32 -> y (B, S, nh, hd)
//   in x's dtype and the final state h (B, nh, hd, ds) fp32. Head n reads
//   group n / (nh / ng) of B and C. Per chunk of Q positions, with
//   a = dt * A and cum its inclusive prefix sum (total = cum[Q-1]):
//     y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) C_i . h
//     h  <- exp(total) h + sum_j x_j (B_j exp(total - cum_j) dt_j)
//   The i >= j mask sits INSIDE the exp (exp(-inf) = 0): the i < j
//   exponent is positive and would overflow, and masking after the exp
//   gives inf * 0 (repro/models/mamba2.py: ssd_scan). The prefix sum is
//   taken in fp64 and rounded to fp32, as the plain version does, so both
//   see the same cum. A ragged S is masked here (positions past S read dt
//   = 0, x = B = C = 0, which leaves the state unchanged and adds nothing):
//   the wrapper pads nothing.
//
//   Bound on an H100 SXM: bytes. At the prefill's B=4, S=2048, nh=64,
//   hd=64, ng=1, ds=64, Q=256 the function reads x, dt, A, B, C and writes
//   y and h: 144.7 MB, 0.043 ms at 3.35 TB/s. Its products are 17.35 GFLOP
//   (C.B^T once per group, the masked (Q, Q) form times x, C.h, the state
//   update); at the operand splits used below (S.x twice, C.h and the state
//   three times, C.B^T once in fp32) 43.1 GFLOP, 0.044 ms at the 989
//   TFLOP/s of the bf16 tensor cores. chip_smoke.py computes all of these.
//
// fp32 x: the FMA kernel (namespace f32). One CTA owns one (b, head) and
//   walks the chunks IN ORDER in a loop (the TPU kernel's sequential 3rd
//   grid dimension, the (hd, ds) state in VMEM scratch), the state in
//   shared memory; the chunk's (Q, Q) form walked in 64 x 64 tiles, each
//   score tile in registers (16 x 16 threads x 4 x 4), decayed, masked,
//   staged in shared memory and multiplied into the tile's y accumulator.
//   fp32 FMAs only: bf16 parts of fp32 operands would have to be split
//   three ways on both sides to meet fp32's atol 2e-4 on y, and fp32 runs
//   only in the fp32 parity checks. 2.12 ms at the prefill's operands.
//
// bf16 x: tensor cores (namespace tc), two launches per call.
//   The FMA kernel ran it at 2.19 ms (12 TFLOP/s, 50x the bound): 256 CTAs
//   of one (b, head) each, every product fp32 FMAs fed from shared memory,
//   C.B^T recomputed by each of the 64 heads sharing one group.
//   1. ssd_gram_kernel: G = C B^T once per (b, group, chunk), only its
//      causal 64 x 64 tiles, in fp32 FMAs (0.13 GFLOP at the prefill: the
//      tensor cores would not pay for the splits), into an fp32 workspace
//      that stays in the 50 MB L2 for launch 2, with C and B copied beside
//      it. All three are stored in the order of launch 2's mma fragments
//      (see "fragment layouts"), so that its fp32 operands arrive as one
//      16-byte load per lane and 512 contiguous bytes per warp: launch 2
//      was bound by load wavefronts while it read them as 4-byte words
//      from 4 to 8 rows per instruction.
//   2. ssd_scan_kernel: one CTA of 8 warps per (b, head, slab of 64 head
//      dims) walks the chunks IN ORDER; splitting the head dims is exact
//      (y[:, p] and h[p, :] depend only on x[:, p]). 64-dim slabs make 256
//      CTAs at the prefill, one wave at 2 CTAs per SM; the per-chunk work
//      that does not depend on p (the decayed scores, the G, C and B
//      loads) is shared by twice the dims of a 32-dim slab, which gave 512
//      CTAs, two waves at 2 per SM. The next
//      chunk's x slab (bf16) comes through a 2-stage cp.async ring and its
//      dt a chunk ahead in a register; the state (64 x ds fp32) stays in
//      the registers of the warps that own it (each warp an s tile across
//      all 64 dims, so that B w, the same for every dim, is split once),
//      and goes to shared memory as bf16 hi + lo once per chunk for C.h.
//      Per chunk, mma.sync
//      m16n8k16 bf16 with fp32 accumulators:
//      - S x: S = G * exp(cum_i - cum_j) * dt_j is formed in registers as
//        the A fragment (the m16n8 accumulator layout is the m16n8k16 A
//        layout), split hi + lo; x is exact in bf16 (ldmatrix.trans). Each
//        warp takes row tiles w and 15 - w (equal causal work), G one k
//        tile ahead in registers.
//      - exp(cum_i) C_i . h into the same accumulators: C exp(cum_i) and h
//        each hi + lo, three products (hi.hi + hi.lo + lo.hi).
//      - the state h <- exp(total) h + x^T (B w), accumulated onto the
//        decayed state: x^T by ldmatrix.trans, B w split in three bf16
//        parts (24 bits: all of fp32), since h is held to atol 2e-4.
//      y leaves through per-warp shared rows as 16-byte stores.
//
//   Kept from the FMA kernel: the i >= j mask sits INSIDE the exp, the
//   chunk's prefix sum is taken in fp64 and rounded once (a warp per 32
//   positions, then the earlier warps' totals added in order: the same
//   fp64 sums), a ragged S is masked here, not padded by the wrapper.
//
// Launches on the caller's stream, allocates nothing, does not synchronize,
// and returns cudaGetLastError() for the wrapper to raise on.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory on sm_90

// ------------------------------------------------------------------------- //
// fp32 x: fp32 FMAs from shared memory
// ------------------------------------------------------------------------- //
namespace f32 {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kT = 64;         // i and j tile of the chunk's quadratic form
constexpr int kLd = kT + 1;    // padded row of the transposed tiles

__host__ __device__ inline int padded_q(int Q) { return (Q + kT - 1) / kT * kT; }

size_t smem_bytes(int hd, int ds, int Q) {
  return sizeof(float) * (static_cast<size_t>(ds) * hd      // ht[s][d]
                          + static_cast<size_t>(ds) * kLd * 2  // Ct, Bt
                          + static_cast<size_t>(kT) * hd       // xs[j][d]
                          + static_cast<size_t>(kT) * kLd      // St[j][i]
                          + 3 * static_cast<size_t>(padded_q(Q)));  // dt, cum, wj
}

// NJ = head-dim columns per thread (hd <= 16 NJ); NS = state columns per
// thread in the state update (ds <= 16 NS)
template <int NJ, int NS>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ h_out, int S, int nh, int hd, int ng, int ds,
                 int Q) {
  extern __shared__ float smem[];
  const int Qp = padded_q(Q);
  float* ht = smem;                  // ds x hd: the carried state, h[d][s] at ht[s][d]
  float* Ct = ht + ds * hd;          // ds x kLd: Ct[s][i]
  float* Bt = Ct + ds * kLd;         // ds x kLd: Bt[s][j]
  float* xs = Bt + ds * kLd;         // kT x hd: xs[j][d]
  float* St = xs + kT * hd;          // kT x kLd: St[j][i]
  float* dtc = St + kT * kLd;        // Qp
  float* cum = dtc + Qp;             // Qp
  float* wj = cum + Qp;              // Qp

  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int g = head / (nh / ng);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const float a_head = A[head];

  const long long x_step = static_cast<long long>(nh) * hd;  // between positions
  const long long bc_step = static_cast<long long>(ng) * ds;
  const float* xb = x + (static_cast<long long>(b) * S * nh + head) * hd;
  float* yb = y + (static_cast<long long>(b) * S * nh + head) * hd;
  const float* dtb = dt + static_cast<long long>(b) * S * nh + head;
  const float* Bb = Bm + (static_cast<long long>(b) * S * ng + g) * ds;
  const float* Cb = Cm + (static_cast<long long>(b) * S * ng + g) * ds;

  for (int idx = tid; idx < ds * hd; idx += kThreads) ht[idx] = 0.f;

  // stage rows [p0, p0 + kT) of the chunk starting at c0 (positions past
  // Q or S read as zero): Bt[s][j] and xs[j][d]
  auto load_bx = [&](int c0, int p0) {
    for (int idx = tid; idx < kT * ds; idx += kThreads) {
      const int j = idx / ds, s = idx - j * ds;
      const int p = p0 + j, t = c0 + p;
      Bt[s * kLd + j] = (p < Q && t < S) ? Bb[t * bc_step + s] : 0.f;
    }
    for (int idx = tid; idx < kT * hd; idx += kThreads) {
      const int j = idx / hd, d = idx - j * hd;
      const int p = p0 + j, t = c0 + p;
      xs[j * hd + d] = (p < Q && t < S) ? xb[t * x_step + d] : 0.f;
    }
  };

  const int n_chunks = (S + Q - 1) / Q;
  const int n_tiles = Qp / kT;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * Q;
    __syncthreads();  // the previous chunk's readers of dtc/cum/wj are done
    for (int p = tid; p < Qp; p += kThreads) {
      const int t = c0 + p;
      dtc[p] = (p < Q && t < S) ? dtb[t * static_cast<long long>(nh)] : 0.f;
    }
    __syncthreads();
    if (tid < 32) {  // inclusive prefix sum of a = dt * A, in fp64
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
    const float total = cum[Q - 1];
    for (int p = tid; p < Qp; p += kThreads) wj[p] = expf(total - cum[p]) * dtc[p];

    // y, one tile of kT rows at a time
    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kT;
      __syncthreads();  // the previous tile's readers of Ct are done
      for (int idx = tid; idx < kT * ds; idx += kThreads) {
        const int i = idx / ds, s = idx - i * ds;
        const int p = i0 + i, t = c0 + p;
        Ct[s * kLd + i] = (p < Q && t < S) ? Cb[t * bc_step + s] : 0.f;
      }
      float acc[4][NJ];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[r][jj] = 0.f;

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        __syncthreads();  // the previous j tile's readers of Bt, xs, St are done
        load_bx(c0, j0);
        __syncthreads();
        float G[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) G[r][c] = 0.f;
        for (int s = 0; s < ds; ++s) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = Ct[s * kLd + ty * 4 + r];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = Bt[s * kLd + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) G[r][c] = fmaf(cv[r], bv[c], G[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty * 4 + r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            // the mask inside the exp: exp(-inf) = 0, never inf * 0
            const float decay = expf(i >= j ? cum[i] - cum[j] : -CUDART_INF_F);
            St[(tx + 16 * c) * kLd + ty * 4 + r] = G[r][c] * (decay * dtc[j]);
          }
        }
        __syncthreads();
        for (int j = 0; j < kT; ++j) {
          float sv[4], xv[NJ];
#pragma unroll
          for (int r = 0; r < 4; ++r) sv[r] = St[j * kLd + ty * 4 + r];
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
            const int d = tx + 16 * jj;
            xv[jj] = d < hd ? xs[j * hd + d] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int jj = 0; jj < NJ; ++jj) acc[r][jj] = fmaf(sv[r], xv[jj], acc[r][jj]);
        }
      }

      // + exp(cum_i) C_i . h (the incoming state), then store
      float yi[4][NJ];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) yi[r][jj] = 0.f;
      for (int s = 0; s < ds; ++s) {
        float cv[4], hv[NJ];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Ct[s * kLd + ty * 4 + r];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int d = tx + 16 * jj;
          hv[jj] = d < hd ? ht[s * hd + d] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) yi[r][jj] = fmaf(cv[r], hv[jj], yi[r][jj]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = i0 + ty * 4 + r, t = c0 + p;
        if (p >= Q || t >= S) continue;
        const float e = expf(cum[p]);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int d = tx + 16 * jj;
          if (d < hd) yb[t * x_step + d] = acc[r][jj] + yi[r][jj] * e;
        }
      }
    }

    // the state update: h <- exp(total) h + sum_j x_j (B_j wj_j)
    float hacc[NJ][NS];
#pragma unroll
    for (int a = 0; a < NJ; ++a)
#pragma unroll
      for (int c = 0; c < NS; ++c) hacc[a][c] = 0.f;
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * kT;
      __syncthreads();  // every reader of Bt, xs (and of ht, for y) is done
      load_bx(c0, j0);
      __syncthreads();
      for (int j = 0; j < kT; ++j) {
        const float w = wj[j0 + j];
        float xv[NJ], bv[NS];
#pragma unroll
        for (int a = 0; a < NJ; ++a) {
          const int d = tx + 16 * a;
          xv[a] = d < hd ? xs[j * hd + d] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < NS; ++c) {
          const int s = ty + 16 * c;
          bv[c] = s < ds ? Bt[s * kLd + j] * w : 0.f;
        }
#pragma unroll
        for (int a = 0; a < NJ; ++a)
#pragma unroll
          for (int c = 0; c < NS; ++c) hacc[a][c] = fmaf(xv[a], bv[c], hacc[a][c]);
      }
    }
    const float e_total = expf(total);
#pragma unroll
    for (int a = 0; a < NJ; ++a) {
      const int d = tx + 16 * a;
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        const int s = ty + 16 * c;
        if (d < hd && s < ds) ht[s * hd + d] = ht[s * hd + d] * e_total + hacc[a][c];
      }
    }
  }

  __syncthreads();
  float* hb = h_out + (static_cast<long long>(b) * nh + head) * hd * ds;
  for (int idx = tid; idx < hd * ds; idx += kThreads) {
    const int d = idx / ds, s = idx - d * ds;
    hb[idx] = ht[s * hd + d];
  }
}

template <int NJ, int NS>
int launch_t(const float* x, const float* dt, const float* A, const float* Bm,
             const float* Cm, float* y, float* h_out, int Bt, int S, int nh, int hd,
             int ng, int ds, int Q, cudaStream_t st) {
  const size_t smem = smem_bytes(hd, ds, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<NJ, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nh, Bt);
  ssd_chunk_kernel<NJ, NS><<<grid, kThreads, smem, st>>>(
      x, dt, A, Bm, Cm, y, h_out, S, nh, hd, ng, ds, Q);
  return static_cast<int>(cudaGetLastError());
}

template <int NJ>
int launch_ns(const float* x, const float* dt, const float* A, const float* Bm,
              const float* Cm, float* y, float* h_out, int Bt, int S, int nh, int hd,
              int ng, int ds, int Q, cudaStream_t st) {
  if (ds <= 32) return launch_t<NJ, 2>(x, dt, A, Bm, Cm, y, h_out, Bt, S, nh, hd, ng, ds, Q, st);
  if (ds <= 64) return launch_t<NJ, 4>(x, dt, A, Bm, Cm, y, h_out, Bt, S, nh, hd, ng, ds, Q, st);
  return launch_t<NJ, 8>(x, dt, A, Bm, Cm, y, h_out, Bt, S, nh, hd, ng, ds, Q, st);
}

int launch(const void* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, void* y, float* h_out, int Bt, int S, int nh, int hd,
           int ng, int ds, int Q, void* stream) {
  const float* xt = static_cast<const float*>(x);
  float* yt = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 32) return launch_ns<2>(xt, dt, A, Bm, Cm, yt, h_out, Bt, S, nh, hd, ng, ds, Q, st);
  if (hd <= 64) return launch_ns<4>(xt, dt, A, Bm, Cm, yt, h_out, Bt, S, nh, hd, ng, ds, Q, st);
  return launch_ns<8>(xt, dt, A, Bm, Cm, yt, h_out, Bt, S, nh, hd, ng, ds, Q, st);
}

}  // namespace f32

// ------------------------------------------------------------------------- //
// bf16 x: tensor cores
// ------------------------------------------------------------------------- //
namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxQ = 256;  // 16 row tiles of 16: two per warp
constexpr int kSlab = 64;   // head dims per CTA
constexpr int kGT = 64;     // the G launch's i and j tile
constexpr int kGLd = kGT + 1;
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ inline int padded_q(int Q) { return (Q + kGT - 1) / kGT * kGT; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when src_bytes is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a (16x16 bf16, row) . b (16x8 bf16, col), fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// v = hi + lo to 16 bits of mantissa: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split2(float v, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  hi = __float2bfloat16(v);
  lo = __float2bfloat16(v - __bfloat162float(hi));
}

// a pair (lower k in the low half) split into hi and lo words
__device__ __forceinline__ void split2_pair(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat16 h0, l0, h1, l1;
  split2(v0, h0, l0);
  split2(v1, h1, l1);
  hi = pack(h0, h1);
  lo = pack(l0, l1);
}

// v = hi + mid + lo to 24 bits: every bit of an fp32 value (but subnormals)
__device__ __forceinline__ void split3_pair(float v0, float v1, uint32_t& hi, uint32_t& mid,
                                            uint32_t& lo) {
  __nv_bfloat16 h0, m0, l0, h1, m1, l1;
  split2(v0, h0, m0);
  split2(v1, h1, m1);
  l0 = __float2bfloat16(v0 - __bfloat162float(h0) - __bfloat162float(m0));
  l1 = __float2bfloat16(v1 - __bfloat162float(h1) - __bfloat162float(m1));
  hi = pack(h0, h1);
  mid = pack(m0, m1);
  lo = pack(l0, l1);
}

// 2^x by the MUFU (ex2.approx: ~2 ulp, subnormal results flushed to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- the fragment layouts of the workspace ------------------------------ //
// Per (b, group, chunk) the workspace holds Qp * (Qp + 2 DS) floats: G, then
// C, then B, each in the order in which one warp's mma fragments read them,
// so that a lane reads 16 contiguous bytes and a warp 512 (float4 loads, 4
// wavefronts each). Within every 16-wide k tile the k index is permuted:
// the lane (g, t) that holds k = 2t, 2t+1, 2t+8, 2t+9 of an m16n8k16
// fragment holds the actual columns 4t .. 4t+3. The same permutation is
// applied to the other operand (ldmatrix takes one row address per lane,
// and the state's columns are stored in permuted order), so the products
// are unchanged. DS is ds padded to 16, 32, 64 or 128 (zeros).
__host__ __device__ inline int padded_ds(int ds) {
  return ds <= 16 ? 16 : ds <= 32 ? 32 : ds <= 64 ? 64 : 128;
}

__host__ __device__ inline long long block_floats(int Qp, int DS) {
  return static_cast<long long>(Qp) * (Qp + 2 * DS);
}

// lane (g, t) and slot a of row r (of 16) and column c (of 16)
__device__ __forceinline__ int frag_lane(int r, int c) { return (r & 7) * 4 + (c >> 2); }

// G (i, j): [mt][kt][row half][lane][4]
__device__ __forceinline__ int g_off(int i, int j, int MT) {
  return ((((i >> 4) * MT + (j >> 4)) * 2 + ((i >> 3) & 1)) * 32 + frag_lane(i, j & 15)) * 4 +
         (j & 3);
}

// C (i, s), the A operand of C h: [mt][kk][row half][lane][4]
__device__ __forceinline__ int c_off(int i, int s, int KK) {
  return ((((i >> 4) * KK + (s >> 4)) * 2 + ((i >> 3) & 1)) * 32 + frag_lane(i, s & 15)) * 4 +
         (s & 3);
}

// B (j, s), the B operand of the state update (k = j, n = s): [kt][nt][lane][4]
__device__ __forceinline__ int b_off(int j, int s, int NT) {
  return (((j >> 4) * NT + (s >> 3)) * 32 + frag_lane(s, j & 15)) * 4 + (j & 3);
}

// the permuted position of column c (of 16): 4t + e -> 2t + e, 4t + 2 + e
// -> 8 + 2t + e
__device__ __forceinline__ int perm_col(int c) {
  return ((c >> 2) << 1) + (c & 1) + ((c >> 1) & 1) * 8;
}

// the actual row that ldmatrix lane row r (of 8) of k half kb reads
__device__ __forceinline__ int perm_row(int r, int kb) {
  return (r >> 1) * 4 + (r & 1) + kb * 2;
}

// ---- launch 1: G = C B^T once per (b, group, chunk), fp32 FMAs ---------- //
// One CTA per causal (i tile, j tile) pair of 64 x 64, i tile >= j tile;
// C and B staged transposed (rows padded to 65 floats), each thread 4 x 4
// outputs summed over s in order. Rows past the chunk or S read as zero,
// so their G is 0. The diagonal tiles also copy their C and B rows into
// the workspace, in fragment order, zero-padded to DS.
size_t g_smem_bytes(int ds) { return sizeof(float) * 2 * static_cast<size_t>(ds) * kGLd; }

__global__ void __launch_bounds__(256)
ssd_gram_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
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
    for (int q = 0; q < 4; ++q) Wc[g_off(i0 + ty * 4 + r, j0 + tx + 16 * q, MT)] = acc[r][q];
  if (it == jt) {
    float* Cf = Wc + static_cast<long long>(Qp) * Qp;
    float* Bf = Cf + static_cast<long long>(Qp) * DS;
    for (int idx = tid; idx < kGT * DS; idx += 256) {
      const int r = idx / DS, s = idx - r * DS;
      Cf[c_off(i0 + r, s, DS / 16)] = s < ds ? Ct[s * kGLd + r] : 0.f;
      Bf[b_off(i0 + r, s, DS / 8)] = s < ds ? Bt[s * kGLd + r] : 0.f;
    }
  }
}

// ---- launch 2: the scan, one CTA per (b, head, slab of P head dims) ------ //
template <int P, int DS>
struct Layout {
  static constexpr int kLdx = P + 8;   // x tile row: P bf16 + 16 bytes
  static constexpr int kLdh = DS + 8;  // state row: DS bf16 + 16 bytes
  static constexpr int kPM = P / 16;   // the state's p tiles (m16)
  static constexpr int kNT = DS / 8;   // the state's s tiles (n8)
  // the state's tiles over the warps: kSW warps across s, kPW across p;
  // each warp kNS s tiles x kPT p tiles. Across s first: B w, the same
  // for every p, is then split once per warp and not once per p tile.
  static constexpr int kSW = kNT < kWarps ? kNT : kWarps;
  static constexpr int kPW = kWarps / kSW;
  static constexpr int kNS = kNT / kSW;
  static constexpr int kPT = kPM / kPW;
  static_assert(kPM % kPW == 0, "every p tile has an owner");
  static size_t smem_bytes(int Qp) {
    return sizeof(__nv_bfloat16) *
               (2 * static_cast<size_t>(Qp) * kLdx + 2 * P * kLdh + kWarps * 16 * kLdx) +
           sizeof(float) * 3 * static_cast<size_t>(Qp) + sizeof(double) * kWarps;
  }
};

// rows [0, rows) of the chunk at c0 (positions past n_valid zero), head dims
// [p0, p0 + P) (past hd zero) of one head, into a (rows, kLdx) bf16 tile.
// VEC: 16-byte cp.async (hd % 8 == 0, x 16-byte aligned); else element copies.
template <int P, bool VEC>
__device__ __forceinline__ void load_x(__nv_bfloat16* tile, const __nv_bfloat16* xb, int c0,
                                       int rows, int n_valid, long long step, int p0, int hd) {
  constexpr int kLdx = P + 8;
  if (VEC) {
    constexpr int kChunks = P / 8;
    for (int e = threadIdx.x; e < rows * kChunks; e += kThreads) {
      const int r = e / kChunks;
      const int d = (e - r * kChunks) * 8;
      const bool ok = r < n_valid && p0 + d < hd;
      const __nv_bfloat16* src = ok ? xb + (c0 + r) * step + p0 + d : xb;
      cp_async16(smem_addr(tile + r * kLdx + d), src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * P; e += kThreads) {
      const int r = e / P;
      const int d = e - r * P;
      tile[r * kLdx + d] = (r < n_valid && p0 + d < hd) ? xb[(c0 + r) * step + p0 + d]
                                                        : __float2bfloat16(0.f);
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int a) {
  return a == 0 ? v.x : a == 1 ? v.y : a == 2 ? v.z : v.w;
}

template <int P, int DS, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ W,
                __nv_bfloat16* __restrict__ y, float* __restrict__ h_out, int S, int nh,
                int hd, int ng, int ds, int Q, int Qp) {
  using L = Layout<P, DS>;
  constexpr int kLdx = L::kLdx, kLdh = L::kLdh, kNS = L::kNS, kPT = L::kPT;
  constexpr int KK = DS / 16, NT = DS / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // 2 x Qp x kLdx
  __nv_bfloat16* hs_hi = xs + 2 * Qp * kLdx;  // P x kLdh: h[p][perm(s)]
  __nv_bfloat16* hs_lo = hs_hi + P * kLdh;
  __nv_bfloat16* ys = hs_lo + P * kLdh;       // kWarps x 16 x kLdx: y staging
  float* dts = reinterpret_cast<float*>(ys + kWarps * 16 * kLdx);  // Qp
  float* cums = dts + Qp;                                           // Qp
  float* ws = cums + Qp;                                            // Qp
  double* part = reinterpret_cast<double*>(ws + Qp);                // kWarps

  const int p0 = blockIdx.x * P;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int grp = head / (nh / ng);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float a_head = A[head];
  const int nc = (S + Q - 1) / Q;
  const int MT = Qp / 16;

  const long long x_step = static_cast<long long>(nh) * hd;
  const __nv_bfloat16* xb = x + (static_cast<long long>(b) * S * nh + head) * hd;
  __nv_bfloat16* yb = y + (static_cast<long long>(b) * S * nh + head) * hd;
  const float* dtb = dt + static_cast<long long>(b) * S * nh + head;
  const long long blk = block_floats(Qp, DS);
  const float* Wb = W + static_cast<long long>(b * ng + grp) * nc * blk;

  // the state slab h[p][s], fp32, in the registers of the warp that owns
  // it: p tiles [p_tile0, p_tile0 + kPT), s tiles [s_tile0, s_tile0 + kNS)
  const int s_tile0 = (warp % L::kSW) * kNS;
  const int p_tile0 = (warp / L::kSW) * kPT;
  float h[kPT][kNS][4];
#pragma unroll
  for (int m = 0; m < kPT; ++m)
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[m][n][e] = 0.f;

  auto rows_of = [&](int c0) { return min(Q, S - c0); };
  auto tile_rows = [&](int n_valid) { return (n_valid + 15) / 16 * 16; };
  // dt of position threadIdx.x of a chunk (Qp <= kThreads), a chunk ahead
  auto load_dt = [&](int c0) {
    return threadIdx.x < rows_of(c0) ? dtb[(c0 + threadIdx.x) * static_cast<long long>(nh)]
                                     : 0.f;
  };
  float dt_next = load_dt(0);
  {
    const int nv = rows_of(0);
    load_x<P, VEC>(xs, xb, 0, tile_rows(nv), nv, x_step, p0, hd);
  }
  cp_async_commit();

  // ldmatrix row offsets (in rows of the x tile) of the permuted k tiles:
  // the B operand of S x (k halves by lane bit 3) and the A operand of the
  // state update (k halves by lane bit 4)
  const int xrow_b = perm_row(lane & 7, (lane >> 3) & 1);
  const int xrow_a = perm_row(lane & 7, lane >> 4);

  for (int ci = 0; ci < nc; ++ci) {
    const int c0 = ci * Q;
    const int nv = rows_of(c0);
    const int n_tiles = (nv + 15) / 16;
    const __nv_bfloat16* xt = xs + (ci & 1) * Qp * kLdx;
    const float* Gf = Wb + ci * blk;
    const float* Cf = Gf + static_cast<long long>(Qp) * Qp;
    const float* Bf = Cf + static_cast<long long>(Qp) * DS;
    if (ci + 1 < nc) {  // the next chunk's x slab, behind this chunk's work
      const int nv1 = rows_of(c0 + Q);
      load_x<P, VEC>(xs + ((ci + 1) & 1) * Qp * kLdx, xb, c0 + Q, tile_rows(nv1), nv1,
                     x_step, p0, hd);
    }
    cp_async_commit();
    if (threadIdx.x < Qp) dts[threadIdx.x] = dt_next;
    if (ci + 1 < nc) dt_next = load_dt(c0 + Q);
    __syncthreads();

    // inclusive prefix sum of a = dt * A in fp64, rounded once to fp32: a
    // warp per 32 positions, then each adds the earlier warps' totals in
    // order (the same fp64 sums as one warp walking the chunk)
    double v = 0.0;
    const int pos = warp * 32 + lane;
    if (warp * 32 < Qp) {
      v = static_cast<double>(dts[pos] * a_head);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double n = __shfl_up_sync(kFullMask, v, off);
        if (lane >= off) v += n;
      }
      if (lane == 31) part[warp] = v;
    }
    __syncthreads();
    if (warp * 32 < Qp) {
      double carry = 0.0;
      for (int w = 0; w < warp; ++w) carry += part[w];
      cums[pos] = static_cast<float>(v + carry);
    }
    __syncthreads();
    const float total = cums[Q - 1];
    for (int p = threadIdx.x; p < Qp; p += kThreads) ws[p] = expf(total - cums[p]) * dts[p];
    cp_async_wait<1>();  // this chunk's x slab has landed (this thread's copies)
    __syncthreads();     // ... every thread's, and ws is written

    // y: row tiles mt = warp and 15 - warp (equal causal work per warp)
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int mt = half == 0 ? warp : 2 * kWarps - 1 - warp;
      if (mt >= n_tiles) continue;
      const int i0 = mt * 16;
      const int r0 = i0 + g, r1 = i0 + g + 8;
      const float cum_r0 = cums[r0], cum_r1 = cums[r1];
      float acc[P / 8][4];
#pragma unroll
      for (int n = 0; n < P / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

      // S x, S = G * exp(cum_i - cum_j) * dt_j for j <= i (the mask inside
      // the exp), split hi + lo; x by ldmatrix.trans. G one k tile ahead.
      const float* Gm = Gf + mt * MT * 256 + lane * 4;
      const __nv_bfloat16* xbase = xt + xrow_b * kLdx + (lane >> 4) * 8;
      float4 g_next[2] = {ld4(Gm), ld4(Gm + 128)};
#pragma unroll 1
      for (int kt = 0; kt <= mt; ++kt) {
        const int j0 = kt * 16;
        const float4 gv0 = g_next[0], gv1 = g_next[1];
        if (kt < mt) {
          g_next[0] = ld4(Gm + (kt + 1) * 256);
          g_next[1] = ld4(Gm + (kt + 1) * 256 + 128);
        }
        const int jb = j0 + 4 * t;  // this lane's columns jb .. jb + 3
        const float4 cj = ld4(cums + jb), dj = ld4(dts + jb);
        float s0[4], s1[4];  // rows r0, r1
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float e0 = r0 >= jb + a ? (cum_r0 - at(cj, a)) * kLog2e : -CUDART_INF_F;
          const float e1 = r1 >= jb + a ? (cum_r1 - at(cj, a)) * kLog2e : -CUDART_INF_F;
          s0[a] = at(gv0, a) * (exp2_approx(e0) * at(dj, a));
          s1[a] = at(gv1, a) * (exp2_approx(e1) * at(dj, a));
        }
        uint32_t a_hi[4], a_lo[4];
        split2_pair(s0[0], s0[1], a_hi[0], a_lo[0]);
        split2_pair(s1[0], s1[1], a_hi[1], a_lo[1]);
        split2_pair(s0[2], s0[3], a_hi[2], a_lo[2]);
        split2_pair(s1[2], s1[3], a_hi[3], a_lo[3]);
#pragma unroll
        for (int dp = 0; dp < P / 16; ++dp) {
          uint32_t bx[4];
          ldsm_x4_t(smem_addr(xbase + j0 * kLdx + dp * 16), bx);
          mma(acc[2 * dp], a_hi, bx[0], bx[1]);
          mma(acc[2 * dp], a_lo, bx[0], bx[1]);
          mma(acc[2 * dp + 1], a_hi, bx[2], bx[3]);
          mma(acc[2 * dp + 1], a_lo, bx[2], bx[3]);
        }
      }

      // + exp(cum_i) C_i . h (the incoming state), into the same
      // accumulators: C_i exp(cum_i) hi + lo, h hi + lo from shared memory;
      // 3 products (hi.hi + hi.lo + lo.hi)
      if (ci > 0) {
        const float e0 = expf(cum_r0), e1 = expf(cum_r1);
        const float* Cm_ = Cf + mt * KK * 256 + lane * 4;
        const __nv_bfloat16* hbase =
            hs_hi + ((lane & 7) + ((lane >> 4) << 3)) * kLdh + ((lane >> 3) & 1) * 8;
        const long long lo_off = hs_lo - hs_hi;
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          const float4 cv0 = ld4(Cm_ + kk * 256), cv1 = ld4(Cm_ + kk * 256 + 128);
          uint32_t c_hi[4], c_lo[4];
          split2_pair(cv0.x * e0, cv0.y * e0, c_hi[0], c_lo[0]);
          split2_pair(cv1.x * e1, cv1.y * e1, c_hi[1], c_lo[1]);
          split2_pair(cv0.z * e0, cv0.w * e0, c_hi[2], c_lo[2]);
          split2_pair(cv1.z * e1, cv1.w * e1, c_hi[3], c_lo[3]);
#pragma unroll
          for (int np = 0; np < P / 16; ++np) {
            uint32_t bh[4], bl[4];
            ldsm_x4(smem_addr(hbase + np * 16 * kLdh + kk * 16), bh);
            ldsm_x4(smem_addr(hbase + lo_off + np * 16 * kLdh + kk * 16), bl);
            mma(acc[2 * np], c_hi, bh[0], bh[1]);
            mma(acc[2 * np], c_hi, bl[0], bl[1]);
            mma(acc[2 * np], c_lo, bh[0], bh[1]);
            mma(acc[2 * np + 1], c_hi, bh[2], bh[3]);
            mma(acc[2 * np + 1], c_hi, bl[2], bl[3]);
            mma(acc[2 * np + 1], c_lo, bh[2], bh[3]);
          }
        }
      }
      if (VEC) {  // through this warp's staging rows, out as 16-byte rows
        __nv_bfloat16* yw = ys + warp * 16 * kLdx;
#pragma unroll
        for (int n = 0; n < P / 8; ++n) {
          *reinterpret_cast<__nv_bfloat162*>(yw + g * kLdx + n * 8 + 2 * t) =
              __floats2bfloat162_rn(acc[n][0], acc[n][1]);
          *reinterpret_cast<__nv_bfloat162*>(yw + (g + 8) * kLdx + n * 8 + 2 * t) =
              __floats2bfloat162_rn(acc[n][2], acc[n][3]);
        }
        __syncwarp();
        constexpr int kChunks = P / 8;
        for (int e = lane; e < 16 * kChunks; e += 32) {
          const int r = e / kChunks;
          const int d = (e - r * kChunks) * 8;
          if (i0 + r < nv && p0 + d < hd)
            *reinterpret_cast<uint4*>(yb + (c0 + i0 + r) * x_step + p0 + d) =
                *reinterpret_cast<const uint4*>(yw + r * kLdx + d);
        }
        __syncwarp();
      } else {
#pragma unroll
        for (int n = 0; n < P / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e < 2 ? r0 : r1;
            const int pe = p0 + n * 8 + 2 * t + (e & 1);
            if (row < nv && pe < hd) yb[(c0 + row) * x_step + pe] = __float2bfloat16(acc[n][e]);
          }
        }
      }
    }

    // the state: h <- exp(total) h + x^T (B w), accumulated onto the
    // decayed state; x^T by ldmatrix.trans, B w in three bf16 parts (x is
    // exact in bf16). B one k tile ahead.
    {
      const float e_total = expf(total);
#pragma unroll
      for (int m = 0; m < kPT; ++m)
#pragma unroll
        for (int n = 0; n < kNS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) h[m][n][e] *= e_total;
      const __nv_bfloat16* abase =
          xt + xrow_a * kLdx + p_tile0 * 16 + ((lane >> 3) & 1) * 8;
      const float* Bm_ = Bf + (s_tile0 * 32 + lane) * 4;
      float4 b_next[kNS];
#pragma unroll
      for (int n = 0; n < kNS; ++n) b_next[n] = ld4(Bm_ + n * 128);
#pragma unroll 1
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int j0 = kt * 16;
        float4 b_cur[kNS];
#pragma unroll
        for (int n = 0; n < kNS; ++n) b_cur[n] = b_next[n];
        if (kt + 1 < n_tiles) {
#pragma unroll
          for (int n = 0; n < kNS; ++n) b_next[n] = ld4(Bm_ + ((kt + 1) * NT + n) * 128);
        }
        uint32_t ax[kPT][4];
#pragma unroll
        for (int m = 0; m < kPT; ++m) ldsm_x4_t(smem_addr(abase + j0 * kLdx + m * 16), ax[m]);
        const float4 wv = ld4(ws + j0 + 4 * t);
#pragma unroll
        for (int n = 0; n < kNS; ++n) {
          uint32_t b_hi[2], b_mid[2], b_lo[2];
          split3_pair(b_cur[n].x * wv.x, b_cur[n].y * wv.y, b_hi[0], b_mid[0], b_lo[0]);
          split3_pair(b_cur[n].z * wv.z, b_cur[n].w * wv.w, b_hi[1], b_mid[1], b_lo[1]);
#pragma unroll
          for (int m = 0; m < kPT; ++m) {
            mma(h[m][n], ax[m], b_hi[0], b_hi[1]);
            mma(h[m][n], ax[m], b_mid[0], b_mid[1]);
            mma(h[m][n], ax[m], b_lo[0], b_lo[1]);
          }
        }
      }
    }
    __syncthreads();  // every reader of hs (C h) and of this x slab is done
    if (ci + 1 < nc) {  // h hi + lo, columns in permuted order
#pragma unroll
      for (int n = 0; n < kNS; ++n) {
        const int s = (s_tile0 + n) * 8 + 2 * t;
        const int col = (s & ~15) + perm_col(s & 15);
#pragma unroll
        for (int m = 0; m < kPT; ++m) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int p = (p_tile0 + m) * 16 + g + 8 * r;
            uint32_t hi, lo;
            split2_pair(h[m][n][2 * r], h[m][n][2 * r + 1], hi, lo);
            *reinterpret_cast<uint32_t*>(hs_hi + p * kLdh + col) = hi;
            *reinterpret_cast<uint32_t*>(hs_lo + p * kLdh + col) = lo;
          }
        }
      }
    }
  }

  float* hb = h_out + (static_cast<long long>(b) * nh + head) * hd * ds;
#pragma unroll
  for (int m = 0; m < kPT; ++m)
#pragma unroll
    for (int n = 0; n < kNS; ++n) {
      const int s = (s_tile0 + n) * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + (p_tile0 + m) * 16 + g + 8 * (e >> 1);
        const int se = s + (e & 1);
        if (p < hd && se < ds) hb[p * ds + se] = h[m][n][e];
      }
    }
}

template <int P, int DS, bool VEC>
int launch_scan(const __nv_bfloat16* x, const float* dt, const float* A, const float* W,
                __nv_bfloat16* y, float* h_out, int Bt, int S, int nh, int hd, int ng, int ds,
                int Q, cudaStream_t st) {
  const int Qp = padded_q(Q);
  const size_t smem = Layout<P, DS>::smem_bytes(Qp);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<P, DS, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((hd + P - 1) / P, nh, Bt);
  ssd_scan_kernel<P, DS, VEC><<<grid, kThreads, smem, st>>>(x, dt, A, W, y, h_out, S, nh, hd,
                                                            ng, ds, Q, Qp);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int launch_ds(const __nv_bfloat16* x, const float* dt, const float* A, const float* W,
              __nv_bfloat16* y, float* h_out, int Bt, int S, int nh, int hd, int ng, int ds,
              int Q, cudaStream_t st) {
  switch (padded_ds(ds)) {
    case 16: return launch_scan<kSlab, 16, VEC>(x, dt, A, W, y, h_out, Bt, S, nh, hd, ng, ds, Q, st);
    case 32: return launch_scan<kSlab, 32, VEC>(x, dt, A, W, y, h_out, Bt, S, nh, hd, ng, ds, Q, st);
    case 64: return launch_scan<kSlab, 64, VEC>(x, dt, A, W, y, h_out, Bt, S, nh, hd, ng, ds, Q, st);
    default: return launch_scan<kSlab, 128, VEC>(x, dt, A, W, y, h_out, Bt, S, nh, hd, ng, ds, Q, st);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0; }

// launch 1: G, and C and B in fragment order, for every (b, group, chunk)
int launch_gram(const float* Bm, const float* Cm, float* W, int Bt, int S, int ng, int ds,
                int Q, cudaStream_t st) {
  const int Qp = padded_q(Q);
  const int n_it = Qp / kGT;
  const size_t smem = g_smem_bytes(ds);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_gram_kernel<<<dim3((S + Q - 1) / Q, n_it * (n_it + 1) / 2, Bt * ng), 256, smem, st>>>(
      Bm, Cm, W, S, ng, ds, padded_ds(ds), Q, Qp);
  return static_cast<int>(cudaGetLastError());
}

// launch 2: the scan, reading launch 1's workspace
int launch_scan_all(const void* x, const float* dt, const float* A, const float* W, void* y,
                    float* h_out, int Bt, int S, int nh, int hd, int ng, int ds, int Q,
                    cudaStream_t st) {
  const auto* xt = static_cast<const __nv_bfloat16*>(x);
  auto* yt = static_cast<__nv_bfloat16*>(y);
  if (hd % 8 == 0 && aligned16(x) && aligned16(y))
    return launch_ds<true>(xt, dt, A, W, yt, h_out, Bt, S, nh, hd, ng, ds, Q, st);
  return launch_ds<false>(xt, dt, A, W, yt, h_out, Bt, S, nh, hd, ng, ds, Q, st);
}

}  // namespace tc

bool valid_shape(int Bt, int S, int nh, int hd, int ng, int ds, int Q) {
  return Bt > 0 && S > 0 && nh > 0 && hd > 0 && ng > 0 && ds > 0 && Q > 0 && nh % ng == 0 &&
         hd <= 128 && ds <= 128 && Bt <= 65535 && nh <= 65535;
}

bool valid_bf16_shape(int Bt, int S, int nh, int hd, int ng, int ds, int Q) {
  return valid_shape(Bt, S, nh, hd, ng, ds, Q) && Q <= tc::kMaxQ &&
         static_cast<long long>(Bt) * ng <= 65535;
}

}  // namespace

// Q is the chunk (the caller's min(chunk, S)); S need not be a multiple.
extern "C" int repro_ssd_chunk_scan_f32(const void* x, const float* dt, const float* A,
                                        const float* Bm, const float* Cm, void* y,
                                        float* h_out, int Bt, int S, int nh, int hd,
                                        int ng, int ds, int Q, void* stream) {
  if (!valid_shape(Bt, S, nh, hd, ng, ds, Q) ||
      f32::smem_bytes(hd, ds, Q) > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  return f32::launch(x, dt, A, Bm, Cm, y, h_out, Bt, S, nh, hd, ng, ds, Q, stream);
}

// W: the caller's fp32 workspace of Bt * ng * nc * Qp * (Qp + 2 DS) floats,
// nc = ceil(S / Q), Qp = Q rounded up to 64, DS = ds rounded up to 16, 32,
// 64 or 128 (kernels/ssd_chunk.py: gram_workspace_shape). Q <= 256. Two
// launches: G = C B^T (with C and B in fragment order), then the scan.
extern "C" int repro_ssd_chunk_scan_bf16(const void* x, const float* dt, const float* A,
                                         const float* Bm, const float* Cm, float* W,
                                         void* y, float* h_out, int Bt, int S, int nh,
                                         int hd, int ng, int ds, int Q, void* stream) {
  if (!valid_bf16_shape(Bt, S, nh, hd, ng, ds, Q)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = tc::launch_gram(Bm, Cm, W, Bt, S, ng, ds, Q, st);
  if (err != 0) return err;
  return tc::launch_scan_all(x, dt, A, W, y, h_out, Bt, S, nh, hd, ng, ds, Q, st);
}

// The two launches of repro_ssd_chunk_scan_bf16 one at a time (to time
// them apart); the scan reads the workspace the first one wrote.
extern "C" int repro_ssd_gram_bf16(const float* Bm, const float* Cm, float* W, int Bt, int S,
                                   int nh, int ng, int ds, int Q, void* stream) {
  if (!valid_bf16_shape(Bt, S, nh, 1, ng, ds, Q)) return static_cast<int>(cudaErrorInvalidValue);
  return tc::launch_gram(Bm, Cm, W, Bt, S, ng, ds, Q, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_ssd_scan_bf16(const void* x, const float* dt, const float* A,
                                   const float* W, void* y, float* h_out, int Bt, int S,
                                   int nh, int hd, int ng, int ds, int Q, void* stream) {
  if (!valid_bf16_shape(Bt, S, nh, hd, ng, ds, Q)) return static_cast<int>(cudaErrorInvalidValue);
  return tc::launch_scan_all(x, dt, A, W, y, h_out, Bt, S, nh, hd, ng, ds, Q,
                             static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory the fp32 kernel needs at (hd, ds, Q): it grows with
// Q (three fp32 vectors of the chunk, padded to 64). The launch refuses
// more than a block's 232,448 bytes; the wrapper checks first, to say why.
extern "C" long long repro_ssd_smem_bytes(int hd, int ds, int Q) {
  return static_cast<long long>(f32::smem_bytes(hd, ds, Q));
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
