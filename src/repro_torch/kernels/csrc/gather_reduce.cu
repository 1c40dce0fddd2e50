// Hand-written Hopper (sm_90a) kernels of the embedding forward: the bag
// gather-reduce of every [Lookup] / [Train] forward, the [Insert] drop-mode
// fill, and the fused fill + gather-reduce of one training cycle.
// Plain C interface, loaded with ctypes (kernels/gather_reduce.py); built by
// kernels/_build.py with nvcc, without fast-math or flush-to-zero, so each
// fp32 add rounds exactly as the plain PyTorch versions' adds do.
//
// repro_gather_reduce_f32 replaces the Pallas kernel
//   repro/kernels/gather_reduce.py: gather_reduce (_gather_kernel).
//   out[b, :] = storage[ids[b, 0]] + storage[ids[b, 1]] + ... (fp32, l order)
//   Bound on an H100 SXM: bytes. It reads every looked-up row once (the
//   unique rows of the call at best, nb*L*D*4 bytes at worst), the ids and
//   writes nb*D*4 bytes; it does one add per byte-quad read, far below the
//   card's 67 TFLOP/s fp32. At the serving slice's shape (16384 bags x L=20
//   x D=128) the no-reuse bound is ~177.5 MB / 3.35 TB/s ~ 53 us.
//   Design: one warp per bag, lanes over the row in 16-byte float4 chunks
//   (neighbouring lanes on neighbouring addresses; a D=128 row is exactly one
//   512-byte warp load). Each output element is accumulated by ONE thread,
//   starting from the l=0 row and adding l=1..L-1 in order: no split-L
//   reduction and no atomics, so the sum is bitwise equal to
//   kernels/ref.py: gather_reduce_ref. The TPU kernel gets that order from
//   its sequential grid; Hopper blocks run in no order, so the loop over l
//   lives inside the thread. The bag's ids are loaded once per 32 lookups
//   by the whole warp (one coalesced load) and broadcast with shuffles, so
//   a row load never waits on its own id load; 8 warps per block and many
//   resident blocks keep enough row loads in flight to cover HBM latency.
//
// repro_fill_f32 replaces the Pallas kernel
//   repro/kernels/gather_reduce.py: fill (_fill_kernel).
//   storage[slots[i], :] = rows[i, :] for every slots[i] < N; the pad
//   sentinel (== N, core/plan.py: pad_index) is dropped.
//   Bound: bytes, 2 * F_valid * D * 4 (read each valid row, write it once)
//   plus the F slot ids, over 3.35 TB/s.
//   Design: one warp per fill row, lanes copying float4 chunks; a dropped
//   row costs one id load. The Pallas kernel writes in grid order; Hopper
//   blocks race, so the kernel relies on a PRECONDITION: the valid slots of
//   one call are unique (the planner assigns each slot once per plan, and
//   the serving runtime drops stale pairs before filling,
//   core/serving_cache.py: _insert). Negative slots are rejected by the
//   Python wrapper; the kernel also drops them rather than write out of
//   bounds.
//
// repro_fill_gather_reduce_f32 replaces the Pallas kernel
//   repro/kernels/gather_reduce.py: fill_gather_reduce (_make_fused_kernel).
//   The fill above, then the gather-reduce above over the POST-fill
//   storage: a bag that looks up a slot filled in the same call reads the
//   filled row (== kernels/ref.py: fill_gather_reduce_ref, bitwise).
//   Bound: bytes, the sum of the two: read + write of each valid fill row,
//   each unique looked-up row read once (a row that was just filled counts
//   again: the card cannot keep 260k rows on chip between the phases), the
//   ids, the fill slots and the bags written.
//   Design: ONE cooperative launch (cudaLaunchCooperativeKernel) of a
//   persistent grid sized to what can be co-resident on the card (the
//   occupancy query times the SM count). Phase 1: warps stride over the
//   fill rows, as the fill kernel does. Then cooperative_groups'
//   grid.sync(): every fill store is complete and visible before any
//   block starts phase 2. Phase 2: warps stride over the bags, as the
//   gather kernel does, but load storage rows with __ldcg (cached in L2
//   only, the card's point of coherence), never through the read-only
//   non-coherent path that __ldg takes: the rows were written in this same
//   launch. The TPU kernel orders fill before gather with its sequential
//   grid (the fills are the first F grid steps); here the barrier does,
//   and it costs one launch instead of two. The other design, a gather
//   that reads "around" the fill (a slot -> fill-row map), would need an
//   N-entry map built and cleared by extra launches. Same precondition as
//   the fill: the valid fill slots of one call are unique.
//
// All: launch on the caller's stream, allocate nothing, do not
// synchronize, and return the launch's error for the wrapper to raise on.
// Slot ids of the gathers must lie in [0, N): the caller guarantees it
// (the runtimes look up only resident rows).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float add(float a, float b) { return a + b; }

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Storage-row load: through the read-only path where the kernel never
// writes storage (kReadOnly), else from L2 (rows written earlier in the
// same launch by other blocks).
template <bool kReadOnly, typename V>
__device__ __forceinline__ V load_row(const V* p) {
  if constexpr (kReadOnly) {
    return __ldg(p);
  } else {
    return __ldcg(p);
  }
}

// One warp sums one bag: each output element is accumulated by ONE lane,
// from the l=0 row, adding l=1..L-1 in order. V is float4 (D % 4 == 0,
// 16-byte aligned rows) or float; dv = D in Vs. Called warp-uniformly.
template <bool kReadOnly, typename V>
__device__ __forceinline__ void reduce_bag(const V* storage,
                                           const int* __restrict__ ids,
                                           V* __restrict__ out, long long bag,
                                           int L, int dv, int lane) {
  const int* bag_ids = ids + bag * L;
  V* dst = out + bag * dv;
  for (int c0 = 0; c0 < dv; c0 += kWarp) {
    const int c = c0 + lane;
    const bool active = c < dv;
    V acc{};
    for (int l0 = 0; l0 < L; l0 += kWarp) {
      const int n = min(kWarp, L - l0);
      const int my_id = lane < n ? __ldg(bag_ids + l0 + lane) : 0;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const long long s = __shfl_sync(kFullMask, my_id, j);
        if (active) {
          const V v = load_row<kReadOnly>(storage + s * dv + c);
          acc = (l0 + j == 0) ? v : add(acc, v);
        }
      }
    }
    if (active) dst[c] = acc;
  }
}

// One warp copies fill row i into its slot; the sentinel (>= N) and
// negative slots are dropped.
template <typename V>
__device__ __forceinline__ void fill_row(V* storage,
                                         const int* __restrict__ slots,
                                         const V* __restrict__ rows,
                                         long long i, int dv, long long N,
                                         int lane) {
  const int s = __ldg(slots + i);
  if (s < 0 || static_cast<long long>(s) >= N) return;  // drop sentinel
  V* dst = storage + static_cast<long long>(s) * dv;
  const V* src = rows + i * dv;
  for (int c = lane; c < dv; c += kWarp) dst[c] = __ldg(src + c);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    gather_reduce_kernel(const V* __restrict__ storage,
                         const int* __restrict__ ids, V* __restrict__ out,
                         long long nb, int L, int dv) {
  // warp-uniform: a warp either owns a bag or leaves together, so the full
  // shuffle mask is always exact
  const long long bag =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (bag >= nb) return;
  reduce_bag<true>(storage, ids, out, bag, L, dv, threadIdx.x % kWarp);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    fill_kernel(V* __restrict__ storage, const int* __restrict__ slots,
                const V* __restrict__ rows, long long F, int dv, long long N) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (i >= F) return;
  fill_row(storage, slots, rows, i, dv, N, threadIdx.x % kWarp);
}

// Cooperative launch only: every block of the grid must be co-resident.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    fill_gather_reduce_kernel(V* storage, const int* __restrict__ slots,
                              const V* __restrict__ rows, long long F,
                              long long N, const int* __restrict__ ids,
                              V* __restrict__ out, long long nb, int L,
                              int dv) {
  const long long first =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  const long long stride = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  const int lane = threadIdx.x % kWarp;
  for (long long i = first; i < F; i += stride) {
    fill_row(storage, slots, rows, i, dv, N, lane);
  }
  cooperative_groups::this_grid().sync();
  for (long long bag = first; bag < nb; bag += stride) {
    reduce_bag<false>(storage, ids, out, bag, L, dv, lane);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" int repro_gather_reduce_f32(const float* storage, const int* ids,
                                       float* out, long long nb, int L, int D,
                                       void* stream) {
  if (nb <= 0 || L <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && aligned16(storage) && aligned16(out)) {
    gather_reduce_kernel<float4><<<blocks_for(nb), kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(storage), ids,
        reinterpret_cast<float4*>(out), nb, L, D / 4);
  } else {
    gather_reduce_kernel<float><<<blocks_for(nb), kThreads, 0, st>>>(
        storage, ids, out, nb, L, D);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_fill_f32(float* storage, const int* slots,
                              const float* rows, long long F, int D,
                              long long N, void* stream) {
  if (F <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && aligned16(storage) && aligned16(rows)) {
    fill_kernel<float4><<<blocks_for(F), kThreads, 0, st>>>(
        reinterpret_cast<float4*>(storage), slots,
        reinterpret_cast<const float4*>(rows), F, D / 4, N);
  } else {
    fill_kernel<float><<<blocks_for(F), kThreads, 0, st>>>(storage, slots,
                                                           rows, F, D, N);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <typename V>
int launch_fused(V* storage, const int* slots, const V* rows, long long F,
                 long long N, const int* ids, V* out, long long nb, int L,
                 int dv, cudaStream_t st) {
  const void* fn = reinterpret_cast<const void*>(&fill_gather_reduce_kernel<V>);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const long long want = blocks_for(std::max(F, nb));
  const unsigned grid = static_cast<unsigned>(
      std::min<long long>(want, static_cast<long long>(per_sm) * sms));
  void* args[] = {&storage, &slots, &rows, &F, &N, &ids, &out, &nb, &L, &dv};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_fill_gather_reduce_f32(float* storage, const int* slots,
                                            const float* rows, long long F,
                                            long long N, const int* ids,
                                            float* out, long long nb, int L,
                                            int D, void* stream) {
  if (F <= 0 || nb <= 0 || L <= 0 || D <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && aligned16(storage) && aligned16(rows) && aligned16(out)) {
    return launch_fused(reinterpret_cast<float4*>(storage), slots,
                        reinterpret_cast<const float4*>(rows), F, N, ids,
                        reinterpret_cast<float4*>(out), nb, L, D / 4, st);
  }
  return launch_fused(storage, slots, rows, F, N, ids, out, nb, L, D, st);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
