// Hand-written Hopper (sm_90a) kernel of causal / sliding-window GQA flash
// attention, forward only. Plain C interface, loaded with ctypes
// (kernels/flash_attention.py); built by kernels/_build.py with nvcc,
// without fast-math or flush-to-zero.
//
// repro_flash_attention_{f32,bf16} replace the Pallas kernel
//   repro/kernels/flash_attention.py: flash_attention (_kernel).
//   q (B, Sq, H, hd), k/v (B, Skv, K, hd) with H % K == 0, fp32 or bf16 ->
//   o (B, Sq, H, hd) in q's dtype. Query head h reads kv head h * K / H.
//   Scores s = (q . k) * 1/sqrt(hd) in fp32; masked where kv_pos >= Skv, or
//   (causal) kv_pos > q_pos, or (window) q_pos - kv_pos >= window. Online
//   softmax with a running max, denominator and accumulator in fp32; p is
//   rounded to v's dtype before the PV product, as layers.chunked_attention
//   and ref.flash_attention_ref do; the result is acc / max(l, 1e-30).
//   Keys past Skv are masked here, in the kernel: the wrapper pads nothing.
//   (The reference wrapper zero-pads k/v to a block multiple and its Pallas
//   kernel masks only by causality and window, so its non-causal outputs
//   take the padded keys into the softmax; this kernel follows
//   chunked_attention and flash_attention_ref, which mask kv_pos < Skv.)
//
//   Bound on an H100 SXM: operations. Causal attention over the prefill's
//   B=4, S=2048, H=32, hd=64 does 4*B*H*hd*S^2/2 ~ 69 GFLOP of QK^T and PV
//   products on 134 MB of q, k, v and o: 0.07 ms at the 989 TFLOP/s of the
//   bf16 tensor cores, 0.04 ms of bytes at 3.35 TB/s.
//   Design (simple first): the TPU kernel walks the KV blocks on its
//   sequential 4th grid dimension with the running statistics in VMEM
//   scratch; Hopper blocks run in no order, so one CTA owns one (b, h,
//   64-row q tile) and walks the KV blocks IN ORDER in a loop, the
//   statistics in registers. Blocks wholly past the causal frontier or
//   before the window are skipped; the q tiles are issued heaviest (last)
//   first, so the causal triangle's long tiles start early. 256 threads
//   compute a 64x64 score tile as 16x16 threads x (4 rows x 4 columns) with
//   fp32 FMAs from shared memory; q and k sit transposed in shared memory
//   (rows padded to 65 floats) so the reduction reads consecutive words.
//   Row statistics are reduced across the 16 threads of a row by shuffles.
//   No tensor cores yet (mma.sync / wgmma with TMA is later work): the FMA
//   pipes bound it at 67 TFLOP/s at best, ~15x the bound above.
//
// Launches on the caller's stream, allocates nothing, does not synchronize,
// and returns cudaGetLastError() for the wrapper to raise on.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBQ = 64;        // q rows per CTA
constexpr int kBKV = 64;       // keys per block of the in-CTA loop
constexpr int kLd = 65;        // padded row of the transposed tiles
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

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

// p rounded to v's dtype (the PV operand), back in fp32
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float row_max(float v) {  // over the 16 tx lanes
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

size_t smem_bytes(int hd) {
  return sizeof(float) * (static_cast<size_t>(hd) * kLd * 2  // Qt, Kt
                          + static_cast<size_t>(kBKV) * hd     // Vs
                          + static_cast<size_t>(kBKV) * kLd);  // Pt
}

// NJ = output columns per thread (hd <= 16 * NJ)
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int H, int K, int hd, float scale, int causal, int has_window,
                 int window) {
  extern __shared__ float smem[];
  float* Qt = smem;               // hd x kLd: Qt[d][r]
  float* Kt = Qt + hd * kLd;      // hd x kLd: Kt[d][c]
  float* Vs = Kt + hd * kLd;      // kBKV x hd: Vs[c][d]
  float* Pt = Vs + kBKV * hd;     // kBKV x kLd: Pt[c][r]

  const int nq = (Sq + kBQ - 1) / kBQ;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = static_cast<int>(static_cast<long long>(h) * K / H);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q_lo = iq * kBQ;

  const long long q_step = static_cast<long long>(H) * hd;   // between positions
  const long long kv_step = static_cast<long long>(K) * hd;
  const T* qb = q + (static_cast<long long>(b) * Sq * H + h) * hd;
  const T* kb = k + (static_cast<long long>(b) * Skv * K + kh) * hd;
  const T* vb = v + (static_cast<long long>(b) * Skv * K + kh) * hd;

  for (int idx = tid; idx < kBQ * hd; idx += kThreads) {
    const int r = idx / hd, d = idx - r * hd;
    const int s = q_lo + r;
    Qt[d * kLd + r] = s < Sq ? to_f(qb[s * q_step + d]) : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  const int q_hi = min(q_lo + kBQ, Sq) - 1;
  const int n_kv = (Skv + kBKV - 1) / kBKV;
  const int j_end = causal ? min(n_kv, q_hi / kBKV + 1) : n_kv;
  int j_begin = 0;
  if (has_window) {
    const long long first = static_cast<long long>(q_lo) - window + 1;
    if (first > 0) j_begin = static_cast<int>(first / kBKV);
  }

  for (int j = j_begin; j < j_end; ++j) {
    const int kv_lo = j * kBKV;
    __syncthreads();  // the previous block's readers of Kt, Vs, Pt are done
    for (int idx = tid; idx < kBKV * hd; idx += kThreads) {
      const int c = idx / hd, d = idx - c * hd;
      const int s = kv_lo + c;
      float kval = 0.f, vval = 0.f;
      if (s < Skv) {
        kval = to_f(kb[s * kv_step + d]);
        vval = to_f(vb[s * kv_step + d]);
      }
      Kt[d * kLd + c] = kval;
      Vs[c * hd + d] = vval;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qt[d * kLd + ty * 4 + i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = Kt[d * kLd + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[i][jj] = fmaf(qv[i], kv[jj], sc[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q_lo + ty * 4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kp = kv_lo + tx + 16 * jj;
        bool valid = kp < Skv && qp < Sq;
        if (causal) valid = valid && kp <= qp;
        if (has_window) valid = valid && (qp - kp < window);
        ok[jj] = valid;
        sc[i][jj] = valid ? sc[i][jj] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][jj]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = ok[jj] ? expf(sc[i][jj] - m_new) : 0.f;
        ps += p;
        Pt[(tx + 16 * jj) * kLd + ty * 4 + i] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + row_sum(ps);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

    for (int c = 0; c < kBKV; ++c) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Pt[c * kLd + ty * 4 + i];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int d = tx + 16 * jj;
        vv[jj] = d < hd ? Vs[c * hd + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = fmaf(pv[i], vv[jj], acc[i][jj]);
    }
  }

  T* ob = o + (static_cast<long long>(b) * Sq * H + h) * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q_lo + ty * 4 + i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < hd) ob[qp * q_step + d] = from_f<T>(acc[i][jj] / denom);
    }
  }
}

template <typename T, int NJ>
int launch_nj(const T* q, const T* k, const T* v, T* o, int B, int Sq, int Skv,
              int H, int K, int hd, int causal, int has_window, int window,
              cudaStream_t st) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  // 1/sqrt(hd) rounded once from double, as the reference's Python float is
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  flash_fwd_kernel<T, NJ><<<grid, kThreads, smem, st>>>(
      q, k, v, o, Sq, Skv, H, K, hd, scale, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Skv, int H, int K, int hd, int causal, int has_window, int window,
           void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || K <= 0 || H % K != 0 || hd <= 0 ||
      hd > 128 || H > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 32) return launch_nj<T, 2>(qt, kt, vt, ot, B, Sq, Skv, H, K, hd, causal, has_window, window, st);
  if (hd <= 64) return launch_nj<T, 4>(qt, kt, vt, ot, B, Sq, Skv, H, K, hd, causal, has_window, window, st);
  return launch_nj<T, 8>(qt, kt, vt, ot, B, Sq, Skv, H, K, hd, causal, has_window, window, st);
}

}  // namespace

// The 1/sqrt(hd) scale is the kernel's (as in the TPU kernel). window is
// read only when has_window is non-zero.
extern "C" int repro_flash_attention_f32(const void* q, const void* k, const void* v,
                                         void* o, int B, int Sq, int Skv, int H,
                                         int K, int hd, int causal, int has_window,
                                         int window, void* stream) {
  return launch<float>(q, k, v, o, B, Sq, Skv, H, K, hd, causal, has_window, window,
                       stream);
}

extern "C" int repro_flash_attention_bf16(const void* q, const void* k, const void* v,
                                          void* o, int B, int Sq, int Skv, int H,
                                          int K, int hd, int causal, int has_window,
                                          int window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, K, hd, causal, has_window,
                               window, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
