// Hand-written Hopper (sm_90a) kernel of the training backward: gradient
// duplication + coalescing + scatter update of the embedding rows.
// Plain C interface, loaded with ctypes (kernels/grad_coalesce.py); built by
// kernels/_build.py with nvcc, without fast-math or flush-to-zero, so each
// fp32 add rounds exactly as the plain PyTorch version's adds do.
//
// repro_scatter_add_sorted_f32 replaces the Pallas kernel
//   repro/kernels/grad_coalesce.py: scatter_add (_kernel).
//   storage[ids[b, l], :] += deltas[b, :] for every (b, l), in place, with
//   the duplicates of one row added in flat bag-major order:
//   row + d_first + d_next + ... (== kernels/ref.py: scatter_add_ref).
//   The deltas arrive pre-rounded per bag ((-lr * g) in fp32, rounded once
//   outside the kernel): the body is a pure add, so nothing can contract
//   into an FMA.
//   Bound on an H100 SXM: bytes. Read + write of each unique row, plus
//   the ids and the deltas: 2 * U * D * 4 + nb * L * 4 + nb * D * 4 (~276
//   MB at the training slice's ~260k unique rows of 16384 x 20 lookups,
//   D=128: ~0.08 ms at 3.35 TB/s); one add per 4 bytes of delta read, far
//   below the card's 67 TFLOP/s fp32.
//   Design: the TPU kernel gets the order from its sequential grid (a
//   revisited row is re-read after the previous add); Hopper blocks run in
//   no order, and float atomics would add in a different order on every
//   run. So the flat lookup positions are first stable-sorted by slot (the
//   wrapper does it with torch.sort, a library radix sort, timed apart):
//   within a slot's segment the positions keep their flat order. Here one
//   warp owns one segment: it loads the row once, adds the segment's
//   deltas (deltas[pos / L]) in order, each lane owning a 16-byte float4
//   of the row (a D=128 row is one 512-byte warp load), and stores the row
//   once. Rows are disjoint across segments, so warps never race. A warp
//   is launched for every sorted position, and all but the segment's first
//   exit after two id loads: that needs no device-to-host count of the
//   segments. The segment's keys and positions are read 32 at a time in
//   one coalesced load, and the deltas of 8 positions are loaded before
//   they are added, so a long segment (a hot row looked up thousands of
//   times) keeps 8 row loads in flight instead of one.
//
// Launches on the caller's stream, allocates nothing, does not synchronize,
// and returns cudaGetLastError() for the wrapper to raise on. Slot ids must
// lie in [0, N): the kernel drops any other rather than write out of bounds.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr int kPrefetch = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float add(float a, float b) { return a + b; }

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// V is float4 (D % 4 == 0, 16-byte aligned rows) or float; dv = D in Vs.
// keys: the flat slot ids sorted stably; perm: their flat positions.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    scatter_add_kernel(V* __restrict__ storage, const int* __restrict__ keys,
                       const long long* __restrict__ perm,
                       const V* __restrict__ deltas, long long n, int L,
                       int dv, long long N) {
  // warp-uniform: a warp either owns a segment or leaves together, so the
  // full shuffle and ballot masks below are always exact
  const long long head =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (head >= n) return;
  const int s = __ldg(keys + head);
  if (head > 0 && __ldg(keys + head - 1) == s) return;  // not a segment head
  if (s < 0 || static_cast<long long>(s) >= N) return;
  const int lane = threadIdx.x % kWarp;
  V* row = storage + static_cast<long long>(s) * dv;
  for (int c0 = 0; c0 < dv; c0 += kWarp) {
    const int c = c0 + lane;
    const bool active = c < dv;
    V acc = active ? row[c] : V{};
    for (long long j = head;; j += kWarp) {
      // the next 32 sorted positions: which still belong to the segment
      const long long jj = j + lane;
      const bool in = jj < n && __ldg(keys + jj) == s;
      const unsigned m = __ballot_sync(kFullMask, in);
      // the segment is contiguous from j: count its leading run
      const int cnt = (m == kFullMask) ? kWarp : __ffs(~m) - 1;
      const long long my_bag = in ? __ldg(perm + jj) / L : 0;
      for (int t0 = 0; t0 < cnt; t0 += kPrefetch) {
        V buf[kPrefetch] = {};
#pragma unroll
        for (int u = 0; u < kPrefetch; ++u) {
          const long long b = __shfl_sync(kFullMask, my_bag, t0 + u);
          if (active && t0 + u < cnt) buf[u] = __ldg(deltas + b * dv + c);
        }
#pragma unroll
        for (int u = 0; u < kPrefetch; ++u) {
          if (active && t0 + u < cnt) acc = add(acc, buf[u]);
        }
      }
      if (cnt < kWarp) break;
    }
    if (active) row[c] = acc;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" int repro_scatter_add_sorted_f32(float* storage, const int* keys,
                                            const long long* perm,
                                            const float* deltas, long long n,
                                            int L, int D, long long N,
                                            void* stream) {
  if (n <= 0 || L <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && aligned16(storage) && aligned16(deltas)) {
    scatter_add_kernel<float4><<<blocks_for(n), kThreads, 0, st>>>(
        reinterpret_cast<float4*>(storage), keys, perm,
        reinterpret_cast<const float4*>(deltas), n, L, D / 4, N);
  } else {
    scatter_add_kernel<float><<<blocks_for(n), kThreads, 0, st>>>(
        storage, keys, perm, deltas, n, L, D, N);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
