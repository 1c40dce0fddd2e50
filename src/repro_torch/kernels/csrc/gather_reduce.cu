// Hand-written Hopper (sm_90a) kernels of the embedding forward: the bag
// gather-reduce of every [Lookup] / [Train] forward (fp32, fp16, bf16 and
// dequantizing int8 storage), the [Insert] drop-mode fill (a byte copy, and
// fp32 rows converted into bf16 slots), and the fused fill + gather-reduce
// of one training cycle (fp32, fp16, bf16, int8).
// Plain C interface, loaded with ctypes (kernels/gather_reduce.py); built by
// kernels/_build.py with nvcc, without fast-math or flush-to-zero, so each
// fp32 add rounds exactly as the plain PyTorch versions' adds do. Every add
// (and the int8 dequant multiply) is an explicit __fadd_rn / __fmul_rn, so
// no --fmad setting can contract them.
//
// repro_gather_reduce_f32 / _f16 replace the Pallas kernel
//   repro/kernels/gather_reduce.py: gather_reduce (_gather_kernel); the
//   fp16 form is what repro/kernels/ops.py: gather_reduce_q runs for fp16
//   storage (scale=None).
//   out[b, :] = storage[ids[b, 0]] + storage[ids[b, 1]] + ... (fp32, l order;
//   fp16 rows widened to fp32 exactly before the add)
//   Bound on an H100 SXM: bytes. It reads every looked-up row once (the
//   unique rows of the call at best, nb*L*D*itemsize bytes at worst), the
//   ids and writes nb*D*4 bytes; it does one add per element read, far
//   below the card's 67 TFLOP/s fp32. At the serving slice's shape (16384
//   bags x L=20 x D=128 fp32) the no-reuse bound is ~177.5 MB / 3.35 TB/s
//   ~ 53 us.
//   Design: one warp per bag, each lane owning 4 consecutive output floats
//   (neighbouring lanes on neighbouring addresses; a D=128 fp32 row is one
//   512-byte warp load of float4s, a D=128 fp16 row one 256-byte warp load
//   of 4-half chunks). Each output element is accumulated by ONE thread,
//   starting from the l=0 row and adding l=1..L-1 in order: no split-L
//   reduction and no atomics, so the sum is bitwise equal to
//   kernels/ref.py: gather_reduce_ref / gather_reduce_q_ref. The TPU kernel
//   gets that order from its sequential grid; Hopper blocks run in no
//   order, so the loop over l lives inside the thread. The bag's ids are
//   loaded once per 32 lookups by the whole warp (one coalesced load) and
//   broadcast with shuffles, so a row load never waits on its own id load;
//   8 warps per block and many resident blocks keep enough row loads in
//   flight to cover HBM latency. Rows whose width or address does not allow
//   the 4-wide chunks take a scalar (one element per lane) variant.
//
// repro_gather_reduce_q8 replaces the Pallas kernel
//   repro/kernels/gather_reduce.py: gather_reduce_q (_gather_q_kernel).
//   out[b, :] = sum over l of float(q[ids[b, l]]) * scale[ids[b, l]]
//   (int8 payload, fp32 per-row scale; fp32 bags, l order).
//   Bound: bytes, each unique looked-up row's D payload bytes + its 4-byte
//   scale, the ids and the nb*D*4 bytes of bags: ~42 MB, ~13 us at the
//   training slice's ~247k unique rows. The int8 payload makes the rows 4x
//   smaller than fp32, so the fp32 bags written are now the larger half.
//   The scale is an (N, 1) column beside the payload (core/scratchpad.py),
//   so a unique lookup touches a 128-byte payload line (D=128) and a
//   32-byte scale sector (~247k lines + ~110k sectors at those operands,
//   whose slots lie close). The rate of these random accesses, not the
//   bytes, bounds the gather on the card, and the payload rows most of
//   it: chip_smoke.py phase 9 prints the rates, and the time with the
//   scale column already in L2.
//   Design (D % 16 == 0, payload and bags 16-byte aligned:
//   gather_bag_i8_staged): one warp per bag, its rows staged in shared
//   memory. Per 32-lookup group the ids come in one coalesced load; then
//   every row of the group is copied with 16-byte cp.async.cg (lane t
//   copies chunk t % 8 of rows t / 8, t / 8 + 4, ...: one warp instruction
//   covers 4 rows of 128 bytes, where a 4-byte load per lane covers one),
//   the lane that holds lookup j's id loading its scale beside them, not
//   in front of them; then lane c adds the char4 column c of rows 0..n-1
//   in l order from shared memory, each scale passed on by a shuffle. The
//   grid is persistent (as many blocks as are co-resident) and strides
//   over the bags. A register version (all 32 rows of a group loaded into
//   registers before the first add) ran slower on the card: its registers
//   left far fewer resident warps, and one 4-byte load per row and lane
//   kept the load instructions as many as before. Each addend is
//   __fmul_rn(float(q), s): the product is exact (payload 7 significant
//   bits, snapped scale <= 17, core/quantize.py), so it adds no rounding
//   and the sum is bitwise equal to the plain version. Other widths and
//   alignments (D = 8, 40, a view 4 but not 16 bytes in) keep reduce_bag
//   with I8x4 / I8x1 lanes, the lane that loads an id loading its scale.
//
// repro_gather_reduce_bf16 / repro_fill_f32_to_bf16 /
// repro_fill_gather_reduce_bf16 are the same three kernels for a bf16
// storage (ScratchPipe / ReadOnlyCacheServer(storage_dtype=torch.bfloat16),
// the fp32 path's bf16 scratchpad): what the Pallas gather_reduce, fill
// and fill_gather_reduce compute when their storage operand is bf16
// (repro/kernels/ref.py: gather_reduce_ref casts the fp32 sum to the
// storage dtype, fill_ref casts the fp32 rows to it).
//   gather: bf16 rows widened to fp32 exactly (a 16-bit shift), summed in
//   fp32 in l order as above, the bag rounded ONCE to bf16 (round to
//   nearest even, __float2bfloat16_rn, as torch's .to(torch.bfloat16) on
//   the card): bf16 bags, bitwise the plain version's.
//   fill: fp32 rows (F, D) in, each element rounded to bf16 in the kernel
//   (RNE, NaN, infinities, signed zeros and subnormals as .to() gives
//   them) and written to its slot; drop mode as repro_fill.
//   fused: the converting fill, grid.sync(), then the bf16 gather over the
//   post-fill storage, as repro_fill_gather_reduce_f32 orders them.
//   Bound: bytes. The gather reads each unique looked-up row's 2*D bytes
//   once, the ids, and writes nb*D*2 bytes of bags; the fill reads each
//   valid fp32 row (4*D bytes) and writes its bf16 slot (2*D bytes). The
//   adds and conversions (one per element read) sit far below the card's
//   67 TFLOP/s fp32.
//   Design: the fp32 kernels' warp-per-bag gather with a 4-value lane
//   chunk (8 bytes of bf16, so a D=128 row is one 256-byte warp load) and
//   its scalar form for other widths; the fill converts one row per warp,
//   each lane loading a float4 and storing 4 bf16 (8 bytes), or one value
//   per lane where D % 4 or an address rules that out.
//
// repro_fill replaces the Pallas kernel
//   repro/kernels/gather_reduce.py: fill (_fill_kernel), for every storage
//   type: it is a byte copy.
//   storage[slots[i], :] = rows[i, :] for every slots[i] < N; the pad
//   sentinel (== N, core/plan.py: pad_index) is dropped.
//   Bound: bytes, 2 * F_valid * row_bytes (read each valid row, write it
//   once) plus the F slot ids, over 3.35 TB/s.
//   Design: lanes copy 16-byte chunks where the row width and both
//   addresses allow it, else 8, 4, 2 or 1 (chosen once per call on the
//   host; the branch is uniform across the grid). A row of 1, 2, 4, 8 or
//   16 chunks of 16 bytes (an int8 D=128 row is 8, fp16 D=128 16) is
//   narrower than a warp's 512-byte load: one warp per row would leave
//   lanes idle and each warp one short chain of slot load -> row load ->
//   store, 128 bytes in flight. There a warp takes a group of G = min(32,
//   256 / chunks) rows (32 int8 D=128 rows), loads their G slot ids in one
//   coalesced load, hands them out by shuffles, and each lane issues up to
//   8 chunk loads of the group (contiguous in `rows`, so each warp load is
//   512 bytes) before its first store: 4 KB in flight per warp. The narrow
//   and the one-warp-per-row forms are separate instantiations: the wide
//   rows (fp32 D=128, the serving and fp32 training fills) would lose
//   resident warps to the narrow form's registers. Other row widths keep
//   one warp per row. A dropped row costs its share
//   of one id load. The Pallas kernel writes in grid order; Hopper blocks
//   race, so the kernel relies on a
//   PRECONDITION: the valid slots of one call are unique (the planner
//   assigns each slot once per plan, and the serving runtime drops stale
//   pairs before filling, core/serving_cache.py: _insert). Negative slots
//   are rejected by the Python wrapper; the kernel also drops them rather
//   than write out of bounds.
//
// repro_fill_gather_reduce_f32 / _f16 / _q8 replace the Pallas kernels
//   repro/kernels/gather_reduce.py: fill_gather_reduce (_make_fused_kernel)
//   and fill_gather_reduce_q (the int8 form).
//   The fill above, then the gather-reduce above over the POST-fill
//   storage: a bag that looks up a slot filled in the same call reads the
//   filled row (== kernels/ref.py: fill_gather_reduce_ref /
//   fill_gather_reduce_q_ref, bitwise). The int8 form fills the payload
//   only: its scale column was scattered by an earlier op on the same
//   stream (core/scratchpad.py: fill_gather_reduce_q), so the kernel reads
//   it, like the gather, through the read-only path.
//   Bound: bytes, the sum of the two: read + write of each valid fill row,
//   each unique looked-up row read once (a row that was just filled counts
//   again, though the int8 form's ~15 MB of just-filled rows can stay in
//   the 50 MB L2 between the phases, where fp32's ~61 MB cannot), the ids,
//   the fill slots and the bags written. Random accesses: the fill's row
//   stores plus the gather's (int8: payload lines + scale sectors).
//   Design: ONE cooperative launch (cudaLaunchCooperativeKernel) of a
//   persistent grid sized to what can be co-resident on the card (the
//   occupancy query times the SM count). Phase 1: warps stride over the
//   fill's work items (a row, or a group of narrow rows), as the fill
//   kernel does. Then cooperative_groups' grid.sync(): every fill store is
//   complete and visible before any block starts phase 2. Phase 2: warps
//   stride over the bags, as the gather kernels do (int8 rows of 16-byte
//   multiples: staged in shared memory), but read payload rows with
//   __ldcg or cp.async.cg (cached in L2 only, the card's point of
//   coherence), never through the read-only non-coherent path that __ldg
//   takes: the rows were written in this same launch. The int8 form's
//   staging array is static shared memory, so the occupancy query that
//   sizes the cooperative grid counts it. The TPU kernel orders fill before gather with its
//   sequential grid (the fills are the first F grid steps); here the
//   barrier does, and it costs one launch instead of two. The other
//   design, a gather that reads "around" the fill (a slot -> fill-row
//   map), would need an N-entry map built and cleared by extra launches.
//   Same precondition as the fill: the valid fill slots of one call are
//   unique.
//
// All: launch on the caller's stream, allocate nothing, do not
// synchronize, and return the launch's error for the wrapper to raise on.
// Slot ids of the gathers must lie in [0, N) or be negative: the caller
// guarantees it (the runtimes look up only resident rows). A negative id
// is a masked lookup and adds a zero row in its place, in l order, so the
// bag is bitwise kernels/ref.py's masked sum (the full-table DLRM over a
// row shard masks the ids outside the shard: models/dlrm.py). The staged
// int8 gather (D % 16 == 0) takes ids in [0, N) only. Every row address is
// a 64-bit product (a slot as long long times the row's elements or bytes),
// so a storage of more than 2^31 elements is addressed whole (the uncut
// full-table DLRM: 80M rows x 128).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// Storage-row load: through the read-only path where the kernel never
// writes storage (kReadOnly), else from L2 (rows written earlier in the
// same launch by other blocks).
template <bool kReadOnly, typename V>
__device__ __forceinline__ V load(const V* p) {
  if constexpr (kReadOnly) {
    return __ldg(p);
  } else {
    return __ldcg(p);
  }
}

__device__ __forceinline__ float half_bits_to_float(unsigned bits) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(bits)));
}

// bf16 <-> fp32: the widening is exact (the bf16 bits are the top half of
// the fp32 word); the narrowing rounds to nearest even, as torch's
// .to(torch.bfloat16) on the card does.
__device__ __forceinline__ float bf16_bits_to_float(unsigned bits) {
  return __uint_as_float(bits << 16);
}
__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
// two values -> two bf16 in one 32-bit word, the first in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

// The bags of every form but bf16 storage's are written as the fp32 sums.
template <typename A>
struct Fp32Bags {
  using Out = A;
  __device__ static Out narrow(A a) { return a; }
};

// Row formats of the gather: In is what a lane loads per chunk, Acc the
// fp32 values it adds (4 consecutive elements, or 1), Out what it writes
// per chunk of the bag. convert() widens a chunk to fp32 exactly; scale is
// the row's int8 scale (unused otherwise); narrow() turns the sum into
// the bag's type.
struct F32x4 : Fp32Bags<float4> {
  using In = float4;
  using Acc = float4;
  static constexpr bool kScaled = false;
  __device__ static Acc convert(In v, float) { return v; }
};
struct F32x1 : Fp32Bags<float> {
  using In = float;
  using Acc = float;
  static constexpr bool kScaled = false;
  __device__ static Acc convert(In v, float) { return v; }
};
struct BF16x4 {  // 4 bf16, little-endian in two 32-bit words; bf16 bags
  using In = uint2;
  using Acc = float4;
  using Out = uint2;
  static constexpr bool kScaled = false;
  __device__ static Acc convert(In v, float) {
    return make_float4(bf16_bits_to_float(v.x & 0xffffu), bf16_bits_to_float(v.x >> 16),
                       bf16_bits_to_float(v.y & 0xffffu), bf16_bits_to_float(v.y >> 16));
  }
  __device__ static Out narrow(Acc a) {
    return make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
  }
};
struct BF16x1 {
  using In = unsigned short;
  using Acc = float;
  using Out = unsigned short;
  static constexpr bool kScaled = false;
  __device__ static Acc convert(In v, float) { return bf16_bits_to_float(v); }
  __device__ static Out narrow(Acc a) { return static_cast<unsigned short>(bf16_bits(a)); }
};
struct F16x4 : Fp32Bags<float4> {  // 4 halves, little-endian in two 32-bit words
  using In = uint2;
  using Acc = float4;
  static constexpr bool kScaled = false;
  __device__ static Acc convert(In v, float) {
    return make_float4(half_bits_to_float(v.x & 0xffffu), half_bits_to_float(v.x >> 16),
                       half_bits_to_float(v.y & 0xffffu), half_bits_to_float(v.y >> 16));
  }
};
struct F16x1 : Fp32Bags<float> {
  using In = unsigned short;
  using Acc = float;
  static constexpr bool kScaled = false;
  __device__ static Acc convert(In v, float) { return half_bits_to_float(v); }
};
struct I8x4 : Fp32Bags<float4> {
  using In = char4;
  using Acc = float4;
  static constexpr bool kScaled = true;
  __device__ static Acc convert(In v, float s) {
    return make_float4(__fmul_rn(static_cast<float>(v.x), s),
                       __fmul_rn(static_cast<float>(v.y), s),
                       __fmul_rn(static_cast<float>(v.z), s),
                       __fmul_rn(static_cast<float>(v.w), s));
  }
};
struct I8x1 : Fp32Bags<float> {
  using In = signed char;
  using Acc = float;
  static constexpr bool kScaled = true;
  __device__ static Acc convert(In v, float s) {
    return __fmul_rn(static_cast<float>(v), s);
  }
};

// int8 rows of a multiple of 16 bytes, 16-byte aligned: the gather stages
// a group's rows in shared memory (gather_bag_i8_staged) instead of
// reduce_bag's loads into registers; each lane adds char4 columns as I8x4.
struct I8Stage {
  using Acc = float4;
  using Out = float4;
};

// One warp sums one bag: each output element is accumulated by ONE lane,
// from the l=0 row, adding l=1..L-1 in order. dv = chunks per row (D / 4
// or D). Called warp-uniformly.
template <bool kReadOnly, typename R>
__device__ __forceinline__ void reduce_bag(const typename R::In* storage,
                                           const float* __restrict__ scale,
                                           const int* __restrict__ ids,
                                           typename R::Out* __restrict__ out,
                                           long long bag, int L, int dv,
                                           int lane) {
  using Acc = typename R::Acc;
  const int* bag_ids = ids + bag * L;
  typename R::Out* dst = out + bag * dv;
  for (int c0 = 0; c0 < dv; c0 += kWarp) {
    const int c = c0 + lane;
    const bool active = c < dv;
    Acc acc{};
    for (int l0 = 0; l0 < L; l0 += kWarp) {
      const int n = min(kWarp, L - l0);
      const int my_id = lane < n ? __ldg(bag_ids + l0 + lane) : 0;
      float my_scale = 1.0f;
      if constexpr (R::kScaled) {
        // the scale column is never written by these kernels
        my_scale = lane < n && my_id >= 0 ? __ldg(scale + my_id) : 1.0f;
      }
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const long long s = __shfl_sync(kFullMask, my_id, j);
        float sc = 1.0f;
        if constexpr (R::kScaled) sc = __shfl_sync(kFullMask, my_scale, j);
        if (active) {
          // a masked lookup (negative id, warp-uniform) adds a zero row
          const Acc v = s >= 0 ? R::convert(load<kReadOnly>(storage + s * dv + c), sc)
                               : Acc{};
          acc = (l0 + j == 0) ? v : add(acc, v);
        }
      }
    }
    if (active) dst[c] = R::narrow(acc);
  }
}

// row bytes staged per pass of the staged int8 gather: 8 chunks of 16
constexpr int kSlab = 128;

// 16-byte copy global -> shared that bypasses L1 (cached in L2 only, so it
// sees rows stored earlier in the same launch), and the wait for all of the
// thread's copies.
__device__ __forceinline__ void copy_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem));
}
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// One warp sums int8 bag `bag` (D % 16 == 0) with its rows staged in
// shared memory, `stage` being the warp's own kWarp x kSlab bytes. Per
// 128-byte column slab and 32-lookup group: one coalesced id load, then
// every row of the group is copied with 16-byte cp.async (lane t copies
// chunk t % 8 of rows t / 8, t / 8 + 4, ...: one warp instruction covers 4
// rows, where a 4-byte load per lane covers 1), each lookup's scale loaded
// beside them; then lane c adds the char4 column c of rows 0..n-1 in l
// order, from shared memory. Called warp-uniformly.
__device__ __forceinline__ void gather_bag_i8_staged(const char* storage,
                                                     const float* __restrict__ scale,
                                                     const int* __restrict__ ids,
                                                     float4* __restrict__ out,
                                                     long long bag, int L, int D,
                                                     char4* stage, int lane) {
  const int* bag_ids = ids + bag * L;
  const int chunk = lane % 8;
  for (int c0 = 0; c0 < D; c0 += kSlab) {
    const int slab = min(kSlab, D - c0);
    const bool copies = chunk * 16 < slab;
    const bool active = lane * 4 < slab;
    float4 acc{};
    for (int l0 = 0; l0 < L; l0 += kWarp) {
      const int n = min(kWarp, L - l0);
      const int my_id = lane < n ? __ldg(bag_ids + l0 + lane) : 0;
      for (int r0 = 0; r0 < n; r0 += 4) {  // n is warp-uniform
        const int r = r0 + lane / 8;
        const long long s = __shfl_sync(kFullMask, my_id, min(r, n - 1));
        if (r < n && copies) {
          copy_async16(stage + r * (kSlab / 4) + chunk * 4,
                       storage + s * D + c0 + chunk * 16);
        }
      }
      // the scale column is never written by these kernels
      const float my_scale = lane < n ? __ldg(scale + my_id) : 1.0f;
      copy_async_wait();
      __syncwarp();
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const float sc = __shfl_sync(kFullMask, my_scale, j);
        if (active) {
          const float4 a = I8x4::convert(stage[j * (kSlab / 4) + lane], sc);
          acc = (l0 + j == 0) ? a : add(acc, a);
        }
      }
      __syncwarp();  // the stage is read before the next group overwrites it
    }
    if (active) out[bag * (D / 4) + c0 / 4 + lane] = acc;
  }
}

// One warp copies fill row i (row_bytes bytes, in chunks of C) into its
// slot; the sentinel (>= N) and negative slots are dropped.
template <typename C>
__device__ __forceinline__ void copy_row(char* storage, const char* rows,
                                         int s, long long i, int row_bytes,
                                         int lane) {
  C* dst = reinterpret_cast<C*>(storage + static_cast<long long>(s) * row_bytes);
  const C* src = reinterpret_cast<const C*>(rows + i * row_bytes);
  const int n = row_bytes / static_cast<int>(sizeof(C));
  for (int c = lane; c < n; c += kWarp) dst[c] = __ldg(src + c);
}

__device__ __forceinline__ void fill_row(char* storage,
                                         const int* __restrict__ slots,
                                         const char* __restrict__ rows,
                                         long long i, int row_bytes, int chunk,
                                         long long N, int lane) {
  const int s = __ldg(slots + i);
  if (s < 0 || static_cast<long long>(s) >= N) return;  // drop sentinel
  switch (chunk) {  // uniform over the whole grid
    case 16: copy_row<uint4>(storage, rows, s, i, row_bytes, lane); break;
    case 8: copy_row<uint2>(storage, rows, s, i, row_bytes, lane); break;
    case 4: copy_row<unsigned>(storage, rows, s, i, row_bytes, lane); break;
    case 2: copy_row<unsigned short>(storage, rows, s, i, row_bytes, lane); break;
    default: copy_row<unsigned char>(storage, rows, s, i, row_bytes, lane); break;
  }
}

// 16-byte chunk loads a lane of the narrow-row fill issues before its
// first store
constexpr int kFillBatch = 8;

// One warp copies the G narrow fill rows from i0: each row is n = 1, 2, 4,
// 8 or 16 chunks of 16 bytes, and G = min(32, 32 * kFillBatch / n). One
// coalesced load of their slot ids, then every chunk load of the group,
// then the stores. The group's chunks are contiguous in `rows`: lane t
// takes chunks t, t + 32, ..., so chunk t % n of rows t / n, t / n + 32 / n,
// ... (G n is a multiple of 32: the bound on k is warp-uniform).
__device__ __forceinline__ void copy_rows(char* storage,
                                          const int* __restrict__ slots,
                                          const char* __restrict__ rows,
                                          long long i0, long long F,
                                          int row_bytes, int G, long long N,
                                          int lane) {
  const int n = row_bytes / 16;
  const int log_n = __ffs(n) - 1;
  const int chunks = G * n;
  const int my_slot = lane < G && i0 + lane < F ? __ldg(slots + i0 + lane) : -1;
  const uint4* src = reinterpret_cast<const uint4*>(rows + i0 * row_bytes);
  const int col = lane & (n - 1);
  uint4 v[kFillBatch];
  int s[kFillBatch];
#pragma unroll
  for (int k = 0; k < kFillBatch; ++k) {
    s[k] = -1;
    if (k * kWarp < chunks) {
      const int q = lane + k * kWarp;
      s[k] = __shfl_sync(kFullMask, my_slot, q >> log_n);
      if (s[k] >= 0 && static_cast<long long>(s[k]) < N) {  // drop sentinel
        v[k] = __ldg(src + q);
      } else {
        s[k] = -1;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kFillBatch; ++k) {
    if (s[k] >= 0) {
      reinterpret_cast<uint4*>(storage + static_cast<long long>(s[k]) * row_bytes)[col] =
          v[k];
    }
  }
}

// Work item w of the fill: the group of G narrow rows from w * G, or row
// w (kNarrow false: one warp per row; a separate instantiation, so that
// it does not carry the narrow form's registers). Called warp-uniformly.
template <bool kNarrow>
__device__ __forceinline__ void fill_item(char* storage,
                                          const int* __restrict__ slots,
                                          const char* __restrict__ rows,
                                          long long w, long long F,
                                          int row_bytes, int chunk, int G,
                                          long long N, int lane) {
  if constexpr (kNarrow) {
    copy_rows(storage, slots, rows, w * G, F, row_bytes, G, N, lane);
  } else {
    fill_row(storage, slots, rows, w, row_bytes, chunk, N, lane);
  }
}

// One warp converts fill row i (D fp32 values) into its bf16 slot, each
// value rounded to nearest even; the sentinel (>= N) and negative slots are
// dropped. kVec: a lane loads a float4 and stores 4 bf16 (D % 4 == 0, rows
// 16-byte and storage 8-byte aligned), else one value per lane.
template <bool kVec>
__device__ __forceinline__ void fill_row_bf16(unsigned short* storage,
                                              const int* __restrict__ slots,
                                              const float* __restrict__ rows,
                                              long long i, int D, long long N,
                                              int lane) {
  const int s = __ldg(slots + i);
  if (s < 0 || static_cast<long long>(s) >= N) return;  // drop sentinel
  unsigned short* dst = storage + static_cast<long long>(s) * D;
  const float* src = rows + i * D;
  if constexpr (kVec) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    uint2* dst4 = reinterpret_cast<uint2*>(dst);
    for (int c = lane; c < D / 4; c += kWarp) {
      const float4 v = __ldg(src4 + c);
      dst4[c] = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
  } else {
    for (int c = lane; c < D; c += kWarp) {
      dst[c] = static_cast<unsigned short>(bf16_bits(__ldg(src + c)));
    }
  }
}

template <typename R>
__global__ void __launch_bounds__(kThreads)
    gather_reduce_kernel(const typename R::In* __restrict__ storage,
                         const float* __restrict__ scale,
                         const int* __restrict__ ids,
                         typename R::Out* __restrict__ out, long long nb, int L,
                         int dv) {
  // warp-uniform: a warp either owns a bag or leaves together, so the full
  // shuffle mask is always exact
  const long long bag =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (bag >= nb) return;
  reduce_bag<true, R>(storage, scale, ids, out, bag, L, dv, threadIdx.x % kWarp);
}

// Persistent: the grid is what can be co-resident; warps stride over bags.
__global__ void __launch_bounds__(kThreads)
    gather_i8_staged_kernel(const char* __restrict__ storage,
                            const float* __restrict__ scale,
                            const int* __restrict__ ids,
                            float4* __restrict__ out, long long nb, int L, int D) {
  __shared__ __align__(16) char4 stage[kWarpsPerBlock][kWarp * kSlab / 4];
  const long long stride = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  for (long long bag =
           static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
       bag < nb; bag += stride) {
    gather_bag_i8_staged(storage, scale, ids, out, bag, L, D, stage[threadIdx.x / kWarp],
                         threadIdx.x % kWarp);
  }
}

template <bool kNarrow>
__global__ void __launch_bounds__(kThreads)
    fill_kernel(char* __restrict__ storage, const int* __restrict__ slots,
                const char* __restrict__ rows, long long F, long long items,
                int row_bytes, int chunk, int G, long long N) {
  const long long w =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (w >= items) return;
  fill_item<kNarrow>(storage, slots, rows, w, F, row_bytes, chunk, G, N,
                     threadIdx.x % kWarp);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    fill_bf16_kernel(unsigned short* __restrict__ storage,
                     const int* __restrict__ slots,
                     const float* __restrict__ rows, long long F, int D,
                     long long N) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (i >= F) return;
  fill_row_bf16<kVec>(storage, slots, rows, i, D, N, threadIdx.x % kWarp);
}

// Cooperative launch only: the converting fill into a bf16 storage, the
// grid-wide barrier, then the bf16 gather over the post-fill storage (R is
// BF16x4 or BF16x1), its rows read from L2 (__ldcg), as below.
template <typename R, bool kVec>
__global__ void __launch_bounds__(kThreads)
    fill_gather_reduce_bf16_kernel(unsigned short* storage,
                                   const int* __restrict__ slots,
                                   const float* __restrict__ rows, long long F,
                                   long long N, int D,
                                   const int* __restrict__ ids,
                                   typename R::Out* __restrict__ out,
                                   long long nb, int L, int dv) {
  const long long first =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  const long long stride = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  const int lane = threadIdx.x % kWarp;
  for (long long i = first; i < F; i += stride) {
    fill_row_bf16<kVec>(storage, slots, rows, i, D, N, lane);
  }
  cooperative_groups::this_grid().sync();
  const auto* st = reinterpret_cast<const typename R::In*>(storage);
  for (long long bag = first; bag < nb; bag += stride) {
    reduce_bag<false, R>(st, nullptr, ids, out, bag, L, dv, lane);
  }
}

// Cooperative launch only: every block of the grid must be co-resident.
template <typename R, bool kNarrow>
__global__ void __launch_bounds__(kThreads)
    fill_gather_reduce_kernel(char* storage, const int* __restrict__ slots,
                              const char* __restrict__ rows, long long F,
                              long long items, long long N, int row_bytes,
                              int chunk, int G,
                              const float* __restrict__ scale,
                              const int* __restrict__ ids,
                              typename R::Out* __restrict__ out, long long nb,
                              int L, int dv) {
  const long long first =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  const long long stride = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  const int lane = threadIdx.x % kWarp;
  for (long long w = first; w < items; w += stride) {
    fill_item<kNarrow>(storage, slots, rows, w, F, row_bytes, chunk, G, N, lane);
  }
  cooperative_groups::this_grid().sync();
  if constexpr (std::is_same_v<R, I8Stage>) {
    __shared__ __align__(16) char4 stage[kWarpsPerBlock][kWarp * kSlab / 4];
    for (long long bag = first; bag < nb; bag += stride) {
      gather_bag_i8_staged(storage, scale, ids, out, bag, L, dv * 4,
                           stage[threadIdx.x / kWarp], lane);
    }
  } else {
    const auto* st = reinterpret_cast<const typename R::In*>(storage);
    for (long long bag = first; bag < nb; bag += stride) {
      reduce_bag<false, R>(st, scale, ids, out, bag, L, dv, lane);
    }
  }
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<std::uintptr_t>(p) & (bytes - 1u)) == 0;
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

// How the fill copies a row: chunk bytes (16, 8, 4, 2 or 1: the widest
// that divides the row and keeps every row of both arrays aligned) and G
// rows per warp (G > 1 where a row is 1, 2, 4, 8 or 16 chunks of 16
// bytes); items is the number of warp work items.
struct FillLayout {
  int chunk, G;
  long long items;
};

FillLayout fill_layout(const void* storage, const void* rows, int row_bytes,
                       long long F) {
  int chunk = 1;
  for (int c = 16; c > 1; c /= 2) {
    if (row_bytes % c == 0 && aligned(storage, c) && aligned(rows, c)) {
      chunk = c;
      break;
    }
  }
  const int n = row_bytes / chunk;
  const bool narrow = chunk == 16 && n < kWarp && (n & (n - 1)) == 0;
  const int G = narrow ? std::min(kWarp, kFillBatch * kWarp / n) : 1;
  return {chunk, G, (F + G - 1) / G};
}

// Blocks of fn (kThreads each, no dynamic shared memory) that can be
// co-resident on the current device.
cudaError_t resident_blocks(const void* fn, long long* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
  }
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorCooperativeLaunchTooLarge;
  *blocks = static_cast<long long>(per_sm) * sms;
  return err;
}

template <typename R>
int launch_gather(const void* storage, const float* scale, const int* ids,
                  void* out, long long nb, int L, int dv, cudaStream_t st) {
  gather_reduce_kernel<R><<<blocks_for(nb), kThreads, 0, st>>>(
      static_cast<const typename R::In*>(storage), scale, ids,
      static_cast<typename R::Out*>(out), nb, L, dv);
  return static_cast<int>(cudaGetLastError());
}

int launch_gather_i8_staged(const void* storage, const float* scale,
                            const int* ids, float* out, long long nb, int L,
                            int D, cudaStream_t st) {
  long long resident = 0;
  const cudaError_t err = resident_blocks(
      reinterpret_cast<const void*>(&gather_i8_staged_kernel), &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid =
      static_cast<unsigned>(std::min<long long>(blocks_for(nb), resident));
  gather_i8_staged_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const char*>(storage), scale, ids, reinterpret_cast<float4*>(out),
      nb, L, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename R>
int launch_fused(void* storage, const int* slots, const void* rows, long long F,
                 long long N, int row_bytes, const float* scale, const int* ids,
                 float* out, long long nb, int L, int dv, cudaStream_t st) {
  FillLayout fl = fill_layout(storage, rows, row_bytes, F);
  const void* fn =
      fl.G > 1 ? reinterpret_cast<const void*>(&fill_gather_reduce_kernel<R, true>)
               : reinterpret_cast<const void*>(&fill_gather_reduce_kernel<R, false>);
  long long resident = 0;
  cudaError_t err = resident_blocks(fn, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(
      std::min<long long>(blocks_for(std::max(fl.items, nb)), resident));
  char* st_bytes = static_cast<char*>(storage);
  const char* row_data = static_cast<const char*>(rows);
  auto* acc_out = reinterpret_cast<typename R::Out*>(out);
  void* args[] = {&st_bytes, &slots, &row_data, &F, &fl.items, &N, &row_bytes,
                  &fl.chunk, &fl.G, &scale, &ids, &acc_out, &nb, &L, &dv};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool bad_gather(long long nb, int L, int D) { return nb <= 0 || L <= 0 || D <= 0; }

// The converting fill's lanes take a float4 each where the width and both
// arrays allow it (fp32 rows 16-byte, bf16 storage 8-byte aligned).
bool fill_bf16_vec(const void* storage, const void* rows, int D) {
  return D % 4 == 0 && aligned(storage, 8) && aligned(rows, 16);
}

template <typename R, bool kVec>
int launch_fused_bf16(void* storage, const int* slots, const float* rows, long long F,
                      long long N, int D, const int* ids, void* out, long long nb,
                      int L, int dv, cudaStream_t st) {
  const void* fn = reinterpret_cast<const void*>(&fill_gather_reduce_bf16_kernel<R, kVec>);
  long long resident = 0;
  cudaError_t err = resident_blocks(fn, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid =
      static_cast<unsigned>(std::min<long long>(blocks_for(std::max(F, nb)), resident));
  auto* st_bf16 = static_cast<unsigned short*>(storage);
  auto* bags = static_cast<typename R::Out*>(out);
  void* args[] = {&st_bf16, &slots, &rows, &F, &N, &D, &ids, &bags, &nb, &L, &dv};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool bad_fused(long long F, long long nb, int L, int D) {
  return F <= 0 || bad_gather(nb, L, D);
}

}  // namespace

extern "C" int repro_gather_reduce_f32(const float* storage, const int* ids,
                                       float* out, long long nb, int L, int D,
                                       void* stream) {
  if (bad_gather(nb, L, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && aligned(storage, 16) && aligned(out, 16)) {
    return launch_gather<F32x4>(storage, nullptr, ids, out, nb, L, D / 4, st);
  }
  return launch_gather<F32x1>(storage, nullptr, ids, out, nb, L, D, st);
}

extern "C" int repro_gather_reduce_f16(const void* storage, const int* ids,
                                       float* out, long long nb, int L, int D,
                                       void* stream) {
  if (bad_gather(nb, L, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && aligned(storage, 8) && aligned(out, 16)) {
    return launch_gather<F16x4>(storage, nullptr, ids, out, nb, L, D / 4, st);
  }
  return launch_gather<F16x1>(storage, nullptr, ids, out, nb, L, D, st);
}

extern "C" int repro_gather_reduce_q8(const void* data, const float* scale,
                                      const int* ids, float* out, long long nb,
                                      int L, int D, void* stream) {
  if (bad_gather(nb, L, D) || scale == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 16 == 0 && aligned(data, 16) && aligned(out, 16)) {
    return launch_gather_i8_staged(data, scale, ids, out, nb, L, D, st);
  }
  if (D % 4 == 0 && aligned(data, 4) && aligned(out, 16)) {
    return launch_gather<I8x4>(data, scale, ids, out, nb, L, D / 4, st);
  }
  return launch_gather<I8x1>(data, scale, ids, out, nb, L, D, st);
}

extern "C" int repro_fill(void* storage, const int* slots, const void* rows,
                          long long F, int row_bytes, long long N, void* stream) {
  if (F <= 0 || row_bytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FillLayout fl = fill_layout(storage, rows, row_bytes, F);
  auto* fn = fl.G > 1 ? &fill_kernel<true> : &fill_kernel<false>;
  fn<<<blocks_for(fl.items), kThreads, 0, st>>>(
      static_cast<char*>(storage), slots, static_cast<const char*>(rows), F,
      fl.items, row_bytes, fl.chunk, fl.G, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_fill_gather_reduce_f32(float* storage, const int* slots,
                                            const float* rows, long long F,
                                            long long N, const int* ids,
                                            float* out, long long nb, int L,
                                            int D, void* stream) {
  if (bad_fused(F, nb, L, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && aligned(storage, 16) && aligned(out, 16)) {
    return launch_fused<F32x4>(storage, slots, rows, F, N, D * 4, nullptr, ids,
                               out, nb, L, D / 4, st);
  }
  return launch_fused<F32x1>(storage, slots, rows, F, N, D * 4, nullptr, ids,
                             out, nb, L, D, st);
}

extern "C" int repro_fill_gather_reduce_f16(void* storage, const int* slots,
                                            const void* rows, long long F,
                                            long long N, const int* ids,
                                            float* out, long long nb, int L,
                                            int D, void* stream) {
  if (bad_fused(F, nb, L, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && aligned(storage, 8) && aligned(out, 16)) {
    return launch_fused<F16x4>(storage, slots, rows, F, N, D * 2, nullptr, ids,
                               out, nb, L, D / 4, st);
  }
  return launch_fused<F16x1>(storage, slots, rows, F, N, D * 2, nullptr, ids,
                             out, nb, L, D, st);
}

extern "C" int repro_gather_reduce_bf16(const void* storage, const int* ids,
                                        void* out, long long nb, int L, int D,
                                        void* stream) {
  if (bad_gather(nb, L, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && aligned(storage, 8) && aligned(out, 8)) {
    return launch_gather<BF16x4>(storage, nullptr, ids, out, nb, L, D / 4, st);
  }
  return launch_gather<BF16x1>(storage, nullptr, ids, out, nb, L, D, st);
}

// fp32 rows (F, D) into a bf16 storage (N, D), rounded in the kernel.
extern "C" int repro_fill_f32_to_bf16(void* storage, const int* slots,
                                      const float* rows, long long F, int D,
                                      long long N, void* stream) {
  if (F <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* dst = static_cast<unsigned short*>(storage);
  if (fill_bf16_vec(storage, rows, D)) {
    fill_bf16_kernel<true><<<blocks_for(F), kThreads, 0, st>>>(dst, slots, rows, F, D, N);
  } else {
    fill_bf16_kernel<false><<<blocks_for(F), kThreads, 0, st>>>(dst, slots, rows, F, D, N);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_fill_gather_reduce_bf16(void* storage, const int* slots,
                                             const float* rows, long long F,
                                             long long N, const int* ids,
                                             void* out, long long nb, int L,
                                             int D, void* stream) {
  if (bad_fused(F, nb, L, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec_fill = fill_bf16_vec(storage, rows, D);
  if (D % 4 == 0 && aligned(storage, 8) && aligned(out, 8)) {
    return vec_fill ? launch_fused_bf16<BF16x4, true>(storage, slots, rows, F, N, D, ids,
                                                      out, nb, L, D / 4, st)
                    : launch_fused_bf16<BF16x4, false>(storage, slots, rows, F, N, D, ids,
                                                       out, nb, L, D / 4, st);
  }
  return vec_fill ? launch_fused_bf16<BF16x1, true>(storage, slots, rows, F, N, D, ids, out,
                                                    nb, L, D, st)
                  : launch_fused_bf16<BF16x1, false>(storage, slots, rows, F, N, D, ids, out,
                                                     nb, L, D, st);
}

extern "C" int repro_fill_gather_reduce_q8(void* data, const float* scale,
                                           const int* slots, const void* rows,
                                           long long F, long long N,
                                           const int* ids, float* out,
                                           long long nb, int L, int D,
                                           void* stream) {
  if (bad_fused(F, nb, L, D) || scale == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 16 == 0 && aligned(data, 16) && aligned(out, 16)) {
    return launch_fused<I8Stage>(data, slots, rows, F, N, D, scale, ids, out, nb,
                               L, D / 4, st);
  }
  if (D % 4 == 0 && aligned(data, 4) && aligned(out, 16)) {
    return launch_fused<I8x4>(data, slots, rows, F, N, D, scale, ids, out, nb,
                              L, D / 4, st);
  }
  return launch_fused<I8x1>(data, slots, rows, F, N, D, scale, ids, out, nb, L,
                            D, st);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
