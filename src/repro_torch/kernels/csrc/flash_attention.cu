// Hand-written Hopper (sm_90a) kernels of causal / sliding-window GQA flash
// attention, forward only. Plain C interface, loaded with ctypes
// (kernels/flash_attention.py); built by kernels/_build.py with nvcc,
// without fast-math or flush-to-zero.
//
// repro_flash_attention_{bf16,f32} replace the Pallas kernel
//   repro/kernels/flash_attention.py: flash_attention (_kernel).
//   q (B, Sq, H, hd), k/v (B, Skv, K, hd) with H % K == 0, bf16 or fp32 ->
//   o (B, Sq, H, hd) in q's dtype. Query head h reads kv head h * K / H.
//   Query row i sits at position q_pos = q_off + i (q_off >= 0:
//   layers.chunked_attention's q_offset, a query chunk after a prefix of
//   keys); key j at kv_pos = j.
//   Scores s = (q . k) * 1/sqrt(hd) in fp32; masked where kv_pos >= Skv, or
//   (causal) kv_pos > q_pos, or (window) q_pos - kv_pos >= window. Online
//   softmax with a running max, denominator and accumulator in fp32; p is
//   rounded to v's dtype before the PV product, as layers.chunked_attention
//   and ref.flash_attention_ref do; the result is acc / max(l, 1e-30).
//   Keys past Skv are masked here, in the kernel: the wrapper pads nothing.
//   (The reference wrapper zero-pads k/v to a block multiple and its Pallas
//   kernel masks only by causality and window, so its non-causal outputs
//   take the padded keys into the softmax; these kernels follow
//   chunked_attention and flash_attention_ref, which mask kv_pos < Skv.)
//
//   Bound on an H100 SXM: operations. Causal attention over the zamba2
//   prefill's B=4, S=2048, H=32, hd=64 does 4*B*H*hd*S^2/2 ~ 69 GFLOP of
//   QK^T and PV products on 134 MB of q, k, v and o: 0.07 ms at the 989
//   TFLOP/s of the bf16 tensor cores, 0.04 ms of bytes at 3.35 TB/s.
//
//   Both kernels take the TPU kernel's sequential 4th grid dimension (the
//   KV blocks, running statistics in VMEM scratch) into a loop inside one
//   CTA, which owns one (b, h, q tile) and walks the KV blocks IN ORDER with
//   the statistics in registers. Blocks wholly past the causal frontier or
//   before the window are skipped, masks are applied only to the blocks
//   that straddle the diagonal, the window's edge or Skv, and the q tiles
//   are issued heaviest (last) first.
//
// bf16: tensor cores (route: mma.sync m16n8k16 + ldmatrix + cp.async, the
//   FA2 shape; wgmma with TMA-fed tiles is later work). The FMA kernel
//   below it ran bf16 at 3.85 ms at the prefill's operands (17.9 TFLOP/s;
//   NVIDIA H100 80GB HBM3, 700.00 W): both products were fp32 FMAs from
//   shared memory, bf16 widened to fp32 there, the QK^T loop at 8 shared
//   loads per 16 FMAs, 66 KB of shared memory per 64 q rows, and the FMA
//   pipes cap fp32 at ~67 TFLOP/s even at their peak. Here one CTA of 8
//   warps owns 128 q rows (16 per warp); bf16 tiles stay bf16 in shared
//   memory, rows padded by 16 bytes so that ldmatrix reads them without
//   bank conflicts, hd zero-padded up to 32, 64 or 128 (zeros change
//   neither the dot products nor the stored columns). Q is loaded once and
//   held in registers as mma A fragments. K/V tiles of 64 keys go through
//   a 3-stage cp.async ring, two blocks ahead, with one barrier per block.
//   S = Q K^T on the tensor cores, fp32 accumulators; the online softmax
//   runs on those fragments in registers, one FFMA and one MUFU.EX2 per
//   score (log2(e) folded into the scale; ex2.approx is within the bf16
//   tolerance); P is rounded to bf16 in registers and is the A operand of
//   the PV product as it stands (the m16n8 accumulator layout is the
//   m16n8k16 A layout), V read by ldmatrix.trans; O stays fp32 in
//   registers and leaves through shared memory as 16-byte rows.
//   0.327 ms at the prefill's operands, ~210 TFLOP/s, against 0.187 ms
//   for F.scaled_dot_product_attention in the same run (chip_smoke.py;
//   NVIDIA H100 80GB HBM3, 700.00 W). Tried there and slower: 4 warps x
//   32 rows (2 fragments per K/V read), 128-key blocks, 64-row tiles.
//
// fp32: the FMA kernel (fp32 FMAs from shared memory, 64 q rows per CTA,
//   16x16 threads x 4x4 scores). TF32 tensor cores keep ~10 mantissa bits,
//   which cannot meet the fp32 atol of 2e-5; fp32 runs only in the fp32
//   parity checks, not on the bf16 serving path. 3.77 ms at the prefill's
//   operands (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W).
//
// Launches on the caller's stream, allocates nothing, does not synchronize,
// and returns cudaGetLastError() for the wrapper to raise on.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

// ------------------------------------------------------------------------- //
// bf16: tensor cores
// ------------------------------------------------------------------------- //
namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 16 * kWarps;  // q rows per CTA, 16 per warp
constexpr int kBN = 64;           // keys per KV block
constexpr int kStages = 3;        // the K/V ring: 2 blocks ahead
constexpr float kLog2e = 1.4426950408889634f;

// a row of HD bf16 plus 16 bytes: consecutive rows start 16 bytes apart
// modulo 128, so the 8 row addresses of one ldmatrix hit 8 distinct
// 16-byte bank groups
template <int HD>
__host__ __device__ constexpr int ld() { return HD + 8; }

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(ld<HD>()) * (kBM + 2 * kStages * kBN);
}

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

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
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

// two floats rounded to nearest even (torch's .to(bfloat16)); lo in the
// low half, the lower column of an mma fragment
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x by the MUFU (ex2.approx: ~2 ulp, subnormal results flushed to 0),
// for the softmax, which is held to a tolerance
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {  // over the 4 lanes of a row
  v = fmaxf(v, __shfl_xor_sync(kFullMask, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFullMask, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFullMask, v, 1);
  return v + __shfl_xor_sync(kFullMask, v, 2);
}

// rows [row0, row0 + ROWS) of one head (positions step apart, hd wide) into
// a (ROWS, ld<HD>) tile, zeros past S and past hd. VEC: 16-byte cp.async
// (hd % 8 == 0, 16-byte aligned operands); else plain element copies.
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

template <int HD, bool VEC>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 2 : 1)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      int Sq, int Skv, int H, int K, int hd, float scale, int causal,
                      int has_window, int window, int q_off) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = ld<HD>();
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kBM x LD
  __nv_bfloat16* sK = sQ + kBM * LD;                                // kStages x kBN x LD
  __nv_bfloat16* sV = sK + kStages * kBN * LD;                      // kStages x kBN x LD

  // the q tile in the slowest grid dimension, last (heaviest) first
  const int iq = static_cast<int>(gridDim.z) - 1 - static_cast<int>(blockIdx.z);
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kh = static_cast<int>(static_cast<long long>(h) * K / H);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // the fragment's row (and row + 8)
  const int t = lane % 4;  // its column pair
  const int q_lo = iq * kBM;
  const int q_hi = min(q_lo + kBM, Sq) - 1;
  const int p_lo = q_off + q_lo, p_hi = q_off + q_hi;  // the tile's positions

  const long long q_step = static_cast<long long>(H) * hd;  // between positions
  const long long kv_step = static_cast<long long>(K) * hd;
  const __nv_bfloat16* qb = q + (static_cast<long long>(b) * Sq * H + h) * hd;
  const __nv_bfloat16* kb = k + (static_cast<long long>(b) * Skv * K + kh) * hd;
  const __nv_bfloat16* vb = v + (static_cast<long long>(b) * Skv * K + kh) * hd;

  const int n_kv = (Skv + kBN - 1) / kBN;
  const int j_end = causal ? min(n_kv, p_hi / kBN + 1) : n_kv;
  int j_begin = 0;
  if (has_window) {
    const long long first = static_cast<long long>(p_lo) - window + 1;
    if (first > 0) j_begin = static_cast<int>(min(first / kBN, static_cast<long long>(n_kv)));
  }

  // Q, then the first two KV blocks: one cp.async group each
  load_tile<HD, kBM, VEC>(sQ, qb, q_lo, Sq, q_step, hd);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (j_begin + i < j_end) {
      load_tile<HD, kBN, VEC>(sK + i * kBN * LD, kb, (j_begin + i) * kBN, Skv, kv_step, hd);
      load_tile<HD, kBN, VEC>(sV + i * kBN * LD, vb, (j_begin + i) * kBN, Skv, kv_step, hd);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();
  __syncthreads();

  // this warp's 16 q rows as A fragments, one per 16 dims
  uint32_t qf[HD / 16][4];
  {
    const __nv_bfloat16* base = sQ + (warp * 16 + (lane % 16)) * LD + (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldsm_x4(smem_addr(base + kk * 16), qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
  }

  float oacc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[i][e] = 0.f;
  // rows g and g + 8 of the warp's 16 ([0], [1]): running max of the raw
  // scores, and this lane's share of the denominator (summed over the row's
  // 4 lanes at the end)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float scale_log2 = scale * kLog2e;
  const int rows[2] = {p_lo + warp * 16 + g, p_lo + warp * 16 + g + 8};  // positions

  for (int j = j_begin; j < j_end; ++j) {
    const int buf = (j - j_begin) % kStages;
    cp_async_wait<kStages - 2>();  // block j has landed (this thread's copies)
    // ... and every thread's; and every warp is done with block j - 1, whose
    // stage the block kStages - 1 ahead refills: one barrier per block
    __syncthreads();
    if (j + kStages - 1 < j_end) {
      const int nb = (buf + kStages - 1) % kStages;
      load_tile<HD, kBN, VEC>(sK + nb * kBN * LD, kb, (j + kStages - 1) * kBN, Skv, kv_step, hd);
      load_tile<HD, kBN, VEC>(sV + nb * kBN * LD, vb, (j + kStages - 1) * kBN, Skv, kv_step, hd);
    }
    cp_async_commit();
    const __nv_bfloat16* tK = sK + buf * kBN * LD;
    const __nv_bfloat16* tV = sV + buf * kBN * LD;
    const int kv_lo = j * kBN;

    // S = Q K^T: 8 accumulator tiles of 16 rows x 8 keys
    float sacc[kBN / 8][4];
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[i][e] = 0.f;
    {
      const __nv_bfloat16* base =
          tK + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < kBN / 16; ++np) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(smem_addr(base + np * 16 * LD + kk * 16), b0, b1, b2, b3);
          mma(sacc[2 * np], qf[kk], b0, b1);
          mma(sacc[2 * np + 1], qf[kk], b2, b3);
        }
      }
    }

    // mask, only where the block straddles an edge; the row maxima
    const bool need_mask = kv_lo + kBN > Skv || (causal && kv_lo + kBN - 1 > p_lo) ||
                           (has_window && p_hi - kv_lo >= window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (need_mask) {
          const int r = rows[e / 2];
          const int col = kv_lo + nt * 8 + 2 * t + (e & 1);
          bool ok = col < Skv;
          if (causal) ok = ok && col <= r;
          if (has_window) ok = ok && r - col < window;
          if (!ok) sacc[nt][e] = -INFINITY;
        }
        mx[e / 2] = fmaxf(mx[e / 2], sacc[nt][e]);
      }
    }
    // p = 2^(s * scale * log2(e) - m * scale * log2(e)), one FFMA and one
    // MUFU.EX2 per score (scale > 0: the raw scores' max is the scaled one's)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));
      // a row with every key masked so far keeps max -inf: shift by 0
      // there, so 2^-inf = 0 and never 2^(-inf + inf)
      const float sh = mn == -INFINITY ? 0.f : mn * scale_log2;
      const float alpha = exp2_approx(m[r] * scale_log2 - sh);
      m[r] = mn;
      float ps = 0.f;
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt) {
        sacc[nt][2 * r] = exp2_approx(fmaf(sacc[nt][2 * r], scale_log2, -sh));
        sacc[nt][2 * r + 1] = exp2_approx(fmaf(sacc[nt][2 * r + 1], scale_log2, -sh));
        ps += sacc[nt][2 * r] + sacc[nt][2 * r + 1];
      }
      l[r] = l[r] * alpha + ps;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        oacc[i][2 * r] *= alpha;
        oacc[i][2 * r + 1] *= alpha;
      }
    }

    // O += P V: P (bf16) from the score fragments, V by ldmatrix.trans
    {
      const __nv_bfloat16* base =
          tV + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
                                pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
                                pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
                                pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_t(smem_addr(base + kk * 16 * LD + dp * 16), b0, b1, b2, b3);
          mma(oacc[2 * dp], pa, b0, b1);
          mma(oacc[2 * dp + 1], pa, b2, b3);
        }
      }
    }
  }

  // epilogue: O / max(l, 1e-30) as bf16, through this warp's own 16 rows of
  // sQ (no other warp reads them), then out as whole rows
  const float d0 = fmaxf(quad_sum(l[0]), 1e-30f);
  const float d1 = fmaxf(quad_sum(l[1]), 1e-30f);
  __nv_bfloat16* sO = sQ + warp * 16 * LD;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int c = i * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(sO + g * LD + c) =
        __floats2bfloat162_rn(oacc[i][0] / d0, oacc[i][1] / d0);
    *reinterpret_cast<__nv_bfloat162*>(sO + (g + 8) * LD + c) =
        __floats2bfloat162_rn(oacc[i][2] / d1, oacc[i][3] / d1);
  }
  __syncwarp();
  __nv_bfloat16* ob = o + (static_cast<long long>(b) * Sq * H + h) * hd;
  const int row0 = q_lo + warp * 16;
  if (VEC) {
    constexpr int kChunks = HD / 8;
    for (int e = lane; e < 16 * kChunks; e += 32) {
      const int r = e / kChunks;
      const int d = (e - r * kChunks) * 8;
      if (row0 + r < Sq && d < hd)
        *reinterpret_cast<uint4*>(ob + (row0 + r) * q_step + d) =
            *reinterpret_cast<const uint4*>(sO + r * LD + d);
    }
  } else {
    for (int e = lane; e < 16 * hd; e += 32) {
      const int r = e / hd;
      const int d = e - r * hd;
      if (row0 + r < Sq) ob[(row0 + r) * q_step + d] = sO[r * LD + d];
    }
  }
}

template <int HD, bool VEC>
int launch_hd(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
              __nv_bfloat16* o, int B, int Sq, int Skv, int H, int K, int hd, int causal,
              int has_window, int window, int q_off, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<HD, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq = (Sq + kBM - 1) / kBM;
  const dim3 grid(H, B, nq);
  // 1/sqrt(hd) rounded once from double, as the reference's Python float is
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  flash_fwd_bf16_kernel<HD, VEC><<<grid, kThreads, smem, st>>>(
      q, k, v, o, Sq, Skv, H, K, hd, scale, causal, has_window, window, q_off);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int launch_vec(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
               __nv_bfloat16* o, int B, int Sq, int Skv, int H, int K, int hd, int causal,
               int has_window, int window, int q_off, cudaStream_t st) {
  if (hd <= 32)
    return launch_hd<32, VEC>(q, k, v, o, B, Sq, Skv, H, K, hd, causal, has_window, window,
                              q_off, st);
  if (hd <= 64)
    return launch_hd<64, VEC>(q, k, v, o, B, Sq, Skv, H, K, hd, causal, has_window, window,
                              q_off, st);
  return launch_hd<128, VEC>(q, k, v, o, B, Sq, Skv, H, K, hd, causal, has_window, window,
                             q_off, st);
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0; }

int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
           int H, int K, int hd, int causal, int has_window, int window, int q_off,
           void* stream) {
  const auto* qt = static_cast<const __nv_bfloat16*>(q);
  const auto* kt = static_cast<const __nv_bfloat16*>(k);
  const auto* vt = static_cast<const __nv_bfloat16*>(v);
  auto* ot = static_cast<__nv_bfloat16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o))
    return launch_vec<true>(qt, kt, vt, ot, B, Sq, Skv, H, K, hd, causal, has_window, window,
                            q_off, st);
  return launch_vec<false>(qt, kt, vt, ot, B, Sq, Skv, H, K, hd, causal, has_window, window,
                           q_off, st);
}

}  // namespace tc

// ------------------------------------------------------------------------- //
// fp32: FMAs from shared memory
// ------------------------------------------------------------------------- //
namespace f32 {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBQ = 64;        // q rows per CTA
constexpr int kBKV = 64;       // keys per block of the in-CTA loop
constexpr int kLd = 65;        // padded row of the transposed tiles

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
template <int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv,
                     int H, int K, int hd, float scale, int causal, int has_window,
                     int window, int q_off) {
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
  const float* qb = q + (static_cast<long long>(b) * Sq * H + h) * hd;
  const float* kb = k + (static_cast<long long>(b) * Skv * K + kh) * hd;
  const float* vb = v + (static_cast<long long>(b) * Skv * K + kh) * hd;

  for (int idx = tid; idx < kBQ * hd; idx += kThreads) {
    const int r = idx / hd, d = idx - r * hd;
    const int s = q_lo + r;
    Qt[d * kLd + r] = s < Sq ? qb[s * q_step + d] : 0.f;
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
  const int j_end = causal ? min(n_kv, (q_off + q_hi) / kBKV + 1) : n_kv;
  int j_begin = 0;
  if (has_window) {
    const long long first = static_cast<long long>(q_off) + q_lo - window + 1;
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
        kval = kb[s * kv_step + d];
        vval = vb[s * kv_step + d];
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
      const int pos = q_off + qp;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kp = kv_lo + tx + 16 * jj;
        bool valid = kp < Skv && qp < Sq;
        if (causal) valid = valid && kp <= pos;
        if (has_window) valid = valid && (pos - kp < window);
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
        Pt[(tx + 16 * jj) * kLd + ty * 4 + i] = p;  // v's dtype is fp32: no rounding
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

  float* ob = o + (static_cast<long long>(b) * Sq * H + h) * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q_lo + ty * 4 + i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < hd) ob[qp * q_step + d] = acc[i][jj] / denom;
    }
  }
}

template <int NJ>
int launch_nj(const float* q, const float* k, const float* v, float* o, int B, int Sq,
              int Skv, int H, int K, int hd, int causal, int has_window, int window,
              int q_off, cudaStream_t st) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  flash_fwd_f32_kernel<NJ><<<grid, kThreads, smem, st>>>(
      q, k, v, o, Sq, Skv, H, K, hd, scale, causal, has_window, window, q_off);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
           int H, int K, int hd, int causal, int has_window, int window, int q_off,
           void* stream) {
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  float* ot = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 32)
    return launch_nj<2>(qt, kt, vt, ot, B, Sq, Skv, H, K, hd, causal, has_window, window,
                        q_off, st);
  if (hd <= 64)
    return launch_nj<4>(qt, kt, vt, ot, B, Sq, Skv, H, K, hd, causal, has_window, window,
                        q_off, st);
  return launch_nj<8>(qt, kt, vt, ot, B, Sq, Skv, H, K, hd, causal, has_window, window,
                      q_off, st);
}

}  // namespace f32

bool valid_shape(int B, int Sq, int Skv, int H, int K, int hd) {
  return B > 0 && Sq > 0 && Skv > 0 && H > 0 && K > 0 && H % K == 0 && hd > 0 &&
         hd <= 128 && H <= 65535 && B <= 65535;
}

}  // namespace

// The 1/sqrt(hd) scale is the kernel's (as in the TPU kernel). window is
// read only when has_window is non-zero; q_off is the position of q row 0.
extern "C" int repro_flash_attention_f32(const void* q, const void* k, const void* v,
                                         void* o, int B, int Sq, int Skv, int H,
                                         int K, int hd, int causal, int has_window,
                                         int window, int q_off, void* stream) {
  if (!valid_shape(B, Sq, Skv, H, K, hd) || q_off < 0 || q_off > (1 << 30) - Sq)
    return static_cast<int>(cudaErrorInvalidValue);
  return f32::launch(q, k, v, o, B, Sq, Skv, H, K, hd, causal, has_window, window, q_off,
                     stream);
}

extern "C" int repro_flash_attention_bf16(const void* q, const void* k, const void* v,
                                          void* o, int B, int Sq, int Skv, int H,
                                          int K, int hd, int causal, int has_window,
                                          int window, int q_off, void* stream) {
  if (!valid_shape(B, Sq, Skv, H, K, hd) || (Sq + tc::kBM - 1) / tc::kBM > 65535 ||
      q_off < 0 || q_off > (1 << 30) - Sq)
    return static_cast<int>(cudaErrorInvalidValue);
  return tc::launch(q, k, v, o, B, Sq, Skv, H, K, hd, causal, has_window, window, q_off,
                    stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
