// Hand-written Hopper (sm_90a) kernel of the Mamba2 / SSD chunked scan.
// Plain C interface, loaded with ctypes (kernels/ssd_chunk.py); built by
// kernels/_build.py with nvcc, without fast-math or flush-to-zero.
//
// repro_ssd_chunk_scan_{f32,bf16} replace the Pallas kernel
//   repro/kernels/ssd_chunk.py: ssd_chunk_scan (_kernel).
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
//   Bound on an H100 SXM: operations (or bytes, whichever the run gives;
//   chip_smoke.py computes both). At the prefill's B=4, S=2048, nh=64,
//   hd=64, ng=1, ds=64, Q=256 the chunk products are ~43 GFLOP (C.B^T,
//   the masked (Q, Q) form times x, C.h and the state update) on ~140 MB of
//   x, y, dt, B, C and h: 0.04-0.09 ms at the tensor cores' bf16/TF32 rates.
//   Design (simple first): the TPU kernel walks the chunks on its
//   sequential 3rd grid dimension with the (hd, ds) state in VMEM scratch.
//   Here one CTA owns one (b, head) and walks the chunks IN ORDER in a
//   loop, the state in shared memory (ds x hd fp32, 16 KB at 64 x 64).
//   The (Q, Q) fp32 score tile that sat in VMEM would be 256 KB at Q = 256,
//   more than a block's 227 KB, so it is never held whole: the chunk's i
//   rows are walked in tiles of 64, and for each the j <= i tiles of 64 in
//   order, each 64 x 64 score tile computed in registers (16 x 16 threads x
//   4 x 4), decayed and masked, staged in shared memory and multiplied into
//   the tile's y accumulator. The state update walks the j tiles once more.
//   C and B sit transposed in shared memory (rows padded to 65 floats) so
//   the reductions read consecutive words. fp32 FMAs only (no tensor cores
//   yet; that is later work), ~2 CTAs per SM.
//
// Launches on the caller's stream, allocates nothing, does not synchronize,
// and returns cudaGetLastError() for the wrapper to raise on.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kT = 64;         // i and j tile of the chunk's quadratic form
constexpr int kLd = kT + 1;    // padded row of the transposed tiles
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory on sm_90

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

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
template <typename T, int NJ, int NS>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, T* __restrict__ y,
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
  const T* xb = x + (static_cast<long long>(b) * S * nh + head) * hd;
  T* yb = y + (static_cast<long long>(b) * S * nh + head) * hd;
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
      xs[j * hd + d] = (p < Q && t < S) ? to_f(xb[t * x_step + d]) : 0.f;
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
          if (d < hd) yb[t * x_step + d] = from_f<T>(acc[r][jj] + yi[r][jj] * e);
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

template <typename T, int NJ, int NS>
int launch_t(const T* x, const float* dt, const float* A, const float* Bm,
             const float* Cm, T* y, float* h_out, int Bt, int S, int nh, int hd,
             int ng, int ds, int Q, cudaStream_t st) {
  const size_t smem = smem_bytes(hd, ds, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T, NJ, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nh, Bt);
  ssd_chunk_kernel<T, NJ, NS><<<grid, kThreads, smem, st>>>(
      x, dt, A, Bm, Cm, y, h_out, S, nh, hd, ng, ds, Q);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NJ>
int launch_ns(const T* x, const float* dt, const float* A, const float* Bm,
              const float* Cm, T* y, float* h_out, int Bt, int S, int nh, int hd,
              int ng, int ds, int Q, cudaStream_t st) {
  if (ds <= 32) return launch_t<T, NJ, 2>(x, dt, A, Bm, Cm, y, h_out, Bt, S, nh, hd, ng, ds, Q, st);
  if (ds <= 64) return launch_t<T, NJ, 4>(x, dt, A, Bm, Cm, y, h_out, Bt, S, nh, hd, ng, ds, Q, st);
  return launch_t<T, NJ, 8>(x, dt, A, Bm, Cm, y, h_out, Bt, S, nh, hd, ng, ds, Q, st);
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, void* y, float* h_out, int Bt, int S, int nh, int hd,
           int ng, int ds, int Q, void* stream) {
  if (Bt <= 0 || S <= 0 || nh <= 0 || hd <= 0 || ng <= 0 || ds <= 0 || Q <= 0 ||
      nh % ng != 0 || hd > 128 || ds > 128 || Bt > 65535 ||
      smem_bytes(hd, ds, Q) > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 32) return launch_ns<T, 2>(xt, dt, A, Bm, Cm, yt, h_out, Bt, S, nh, hd, ng, ds, Q, st);
  if (hd <= 64) return launch_ns<T, 4>(xt, dt, A, Bm, Cm, yt, h_out, Bt, S, nh, hd, ng, ds, Q, st);
  return launch_ns<T, 8>(xt, dt, A, Bm, Cm, yt, h_out, Bt, S, nh, hd, ng, ds, Q, st);
}

}  // namespace

// Q is the chunk (the caller's min(chunk, S)); S need not be a multiple.
extern "C" int repro_ssd_chunk_scan_f32(const void* x, const float* dt, const float* A,
                                        const float* Bm, const float* Cm, void* y,
                                        float* h_out, int Bt, int S, int nh, int hd,
                                        int ng, int ds, int Q, void* stream) {
  return launch<float>(x, dt, A, Bm, Cm, y, h_out, Bt, S, nh, hd, ng, ds, Q, stream);
}

extern "C" int repro_ssd_chunk_scan_bf16(const void* x, const float* dt, const float* A,
                                         const float* Bm, const float* Cm, void* y,
                                         float* h_out, int Bt, int S, int nh, int hd,
                                         int ng, int ds, int Q, void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, h_out, Bt, S, nh, hd, ng, ds, Q,
                               stream);
}

// Dynamic shared memory the kernel needs at (hd, ds, Q): it grows with Q
// (three fp32 vectors of the chunk, padded to 64). The launch refuses more
// than a block's 232,448 bytes; the wrapper checks first, to say why.
extern "C" long long repro_ssd_smem_bytes(int hd, int ds, int Q) {
  return static_cast<long long>(smem_bytes(hd, ds, Q));
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
