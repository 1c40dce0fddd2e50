// Hand-written Hopper (sm_90a) kernels of the training backward: gradient
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
//   the ids and the deltas: 2 * U * D * 4 + nb * L * 4 + nb * D * 4 (~263
//   MB at the training slice's 247,223 unique rows of 16384 x 20 lookups,
//   D=128: ~0.08 ms at 3.35 TB/s); one add per 4 bytes of delta read, far
//   below the card's 67 TFLOP/s fp32.
//
//   The TPU kernel gets the order from its sequential grid (a revisited row
//   is re-read after the previous add); Hopper blocks run in no order, and
//   float atomics would add in a different order on every run. So the flat
//   lookup positions are first stable-sorted by slot (the wrapper does it
//   with torch.sort, a library radix sort, timed apart): within a slot's
//   segment the positions keep their flat order. The adds of one row stay
//   one chain in that order: no float atomics, no tree over a segment, no
//   reassociation. Parallelism comes from independent rows and from
//   keeping many delta loads in flight, never from reordering the adds.
//
//   The design before this one (0.405 ms of accumulate after a 0.08-0.15
//   ms sort against index_add_'s 0.338; NVIDIA H100 80GB HBM3, 700.00 W)
//   gave one warp to each segment with 8 delta rows in flight, so a hot
//   row's chain (1,759 lookups of one row at the training operands) was
//   latency-bound and set the kernel's tail; and it launched a warp for
//   every one of the 327,680 sorted positions, all but the segment heads
//   exiting at once. Now the segments go two ways, split at T lookups (the
//   caller's T):
//   * short segments (<= T): one warp per 32 sorted positions. It finds the
//     heads among them (a ballot) and takes the segments that start there,
//     8 positions at a time: the 8 delta rows and the rows of the heads
//     among them are loaded together, then added in order, each row stored
//     once when its segment ends (a segment running past the window is
//     followed to its end). Each lane owns a 16-byte float4 column of the
//     row (a D=128 row is one 512-byte warp load), or a float when D % 4 or
//     an operand's alignment rules out float4.
//   * long segments (> T): a first launch lists their heads (an integer
//     atomicAdd per warp onto a device counter: the list's order does not
//     matter, the rows are disjoint). A CTA takes one (segment, 16-column
//     slab) at a time from a second counter: the adds of one column form
//     one chain, so a row's slabs run on different CTAs without reordering
//     any add. Its 8 warps load the segment's positions (256, then up to
//     4,096 at once) and stream the slab of its delta rows through a
//     4-stage, 64 KB shared-memory ring by cp.async; one thread per column
//     adds them from shared memory in order and stores the slab once.
//   The long kernel runs on a stream of its own, of the greatest priority,
//   forked from the caller's after the listing and joined back after it
//   (two events), so it overlaps the short kernel instead of adding its
//   time to it. No count comes back to the host: the long kernel reads the
//   list's length on the device.
//   At the training operands (247,223 unique rows, 85 segments > 64, the
//   longest 1,759): sort 0.078 + accumulate 0.133 = 0.205 ms, against
//   0.335 ms for index_add_ in the same run (chip_smoke.py; NVIDIA H100
//   80GB HBM3, 700.00 W). The same lookups with no repeated id take 0.159
//   ms to accumulate: the short class, at ~2.3 TB/s of random 512-byte row
//   reads and writes, is what is left.
//
// repro_scatter_add_sorted_bf16 is the same update on a bf16 storage (the
//   fp32 path's bf16 scratchpad, ScratchPipe(storage_dtype=torch.bfloat16)):
//   what the Pallas scatter_add computes for a bf16 operand, where
//   kernels/ref.py: scatter_add_ref's storage.at[flat].add(dup) rounds
//   EACH add to bf16: row = bf16(bf16(row + d_first) + d_next) ..., with
//   the deltas bf16 already (rounded once per bag, outside the kernel).
//   Both kernels keep the segment's sum in an fp32 register and round it to
//   bf16 after every add (__float2bfloat16_rn of the exact fp32 sum of two
//   bf16 values, as torch's bf16 add and XLA's do); summing the segment in
//   fp32 and rounding once would differ in the last bit on a hot row.
//   The short kernel's lane owns 4 bf16 columns (8 bytes: a D=128 row is
//   one 256-byte warp load) or 1; the long kernel's ring holds bf16 delta
//   slabs (32 bytes a row), copied 16 bytes at a time by cp.async, or 4, or
//   with plain 2-byte loads where D or an address rules wider copies out.
//   Bound: bytes, 2 * U * D * 2 + nb * L * 4 + nb * D * 2 (half the fp32
//   form's row and delta bytes).
//
// Launches on the caller's stream (the long kernel on the side stream,
// joined back to it), allocates nothing on the device, does not synchronize,
// and returns the first CUDA error for the wrapper to raise on. Slot ids must
// lie in [0, N): the kernels drop any other rather than write out of bounds
// (the full-table DLRM masks the ids outside a rank's row shard to -1). Row
// addresses are 64-bit products (storage past 2^31 elements is addressed
// whole); the lookups are fewer than 2^31 (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr int kPrefetch = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// the long-segment CTA: a slab of kSlab columns (64 bytes of a row), a
// ring of kStages stages of kStageRows delta rows (16 KB each), fed from an
// index block of kIdx sorted positions
constexpr int kSlab = 16;
constexpr int kStages = 4;
constexpr int kStageRows = 256;
constexpr int kIdx = 4096;
constexpr int kBatch = 32;  // shared-memory loads issued ahead of their adds

__device__ __forceinline__ float add(float a, float b) { return a + b; }

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Element types of the storage and the deltas: the long kernel keeps one
// column's running sum in an fp32 register; widen() loads an element into
// it exactly, narrow() stores it back, add() is one add of the chain.
struct F32Elem {
  using T = float;
  __device__ static float widen(float x) { return x; }
  __device__ static float narrow(float x) { return x; }
  __device__ static float add(float a, float b) { return a + b; }
};
struct BF16Elem {  // each add rounded to bf16 (nearest even), as the reference's
  using T = unsigned short;
  __device__ static float widen(unsigned short x) {
    return __uint_as_float(static_cast<unsigned>(x) << 16);
  }
  __device__ static unsigned short narrow(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  __device__ static float add(float a, float b) { return widen(narrow(__fadd_rn(a, b))); }
};

// Lane chunks of the short kernel: In is what a lane loads and stores, Acc
// the fp32 values it adds (E = 4 or 1 consecutive columns).
template <typename V>
struct F32Lane {  // float4 or float
  using In = V;
  using Acc = V;
  __device__ static Acc widen(In v) { return v; }
  __device__ static In narrow(Acc a) { return a; }
  __device__ static Acc add(Acc a, Acc b) { return ::add(a, b); }
};
struct BF16Lane4 {  // 4 bf16, little-endian in two 32-bit words
  using In = uint2;
  using Acc = float4;
  __device__ static Acc widen(In v) {
    return make_float4(BF16Elem::widen(v.x & 0xffffu), BF16Elem::widen(v.x >> 16),
                       BF16Elem::widen(v.y & 0xffffu), BF16Elem::widen(v.y >> 16));
  }
  __device__ static unsigned pack(float lo, float hi) {
    return BF16Elem::narrow(lo) | (static_cast<unsigned>(BF16Elem::narrow(hi)) << 16);
  }
  __device__ static In narrow(Acc a) { return make_uint2(pack(a.x, a.y), pack(a.z, a.w)); }
  __device__ static Acc add(Acc a, Acc b) {
    return make_float4(BF16Elem::add(a.x, b.x), BF16Elem::add(a.y, b.y),
                       BF16Elem::add(a.z, b.z), BF16Elem::add(a.w, b.w));
  }
};
struct BF16Lane1 {
  using In = unsigned short;
  using Acc = float;
  __device__ static Acc widen(In v) { return BF16Elem::widen(v); }
  __device__ static In narrow(Acc a) { return BF16Elem::narrow(a); }
  __device__ static Acc add(Acc a, Acc b) { return BF16Elem::add(a, b); }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy one C (16, 4 or 2 bytes) of a delta row into the ring: by cp.async
// (16 bytes cached in L2 only, 4 through L1), or for 2 bytes a plain load
// and store, which the barrier after the cp.async wait also orders.
template <typename C>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (sizeof(C) == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
                 "l"(src) : "memory");
  } else if constexpr (sizeof(C) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
                 "l"(src) : "memory");
  } else {
    static_assert(sizeof(C) == 2, "a ring copy is 16, 4 or 2 bytes");
    *static_cast<C*>(dst) = __ldg(static_cast<const C*>(src));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// longer than T: the segment's head, an id in [0, N), and position j + T
// still holds the same key
__device__ __forceinline__ bool long_head(const int* __restrict__ keys, long long j, int s,
                                          long long n, long long N, int T) {
  return (j == 0 || __ldg(keys + j - 1) != s) && s >= 0 && static_cast<long long>(s) < N &&
         j + T < n && __ldg(keys + j + T) == s;
}

// One thread per sorted position: the heads of the long segments onto the
// worklist (work[0] counts them, work[2..] lists them), one integer atomic
// per warp that has any.
__global__ void __launch_bounds__(kThreads)
    scatter_classify_kernel(const int* __restrict__ keys, long long n, long long N, int T,
                            long long* __restrict__ work) {
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x % kWarp;
  const bool is_long = j < n && long_head(keys, j, __ldg(keys + j), n, N, T);
  const unsigned mask = __ballot_sync(kFullMask, is_long);
  if (!mask) return;
  unsigned long long base = 0;
  if (lane == 0)
    base = atomicAdd(reinterpret_cast<unsigned long long*>(work),
                     static_cast<unsigned long long>(__popc(mask)));
  base = __shfl_sync(kFullMask, base, 0);
  if (is_long) work[2 + base + __popc(mask & ((1u << lane) - 1u))] = j;
}

// S is a lane chunk (F32Lane<float4> for D % 4 == 0 and 16-byte aligned
// rows, F32Lane<float>, BF16Lane4, BF16Lane1); dv = D in chunks.
// keys: the flat slot ids sorted stably; perm: their flat positions. The
// segments longer than T are the long kernel's.
template <typename S>
__global__ void __launch_bounds__(kThreads)
    scatter_short_kernel(typename S::In* __restrict__ storage, const int* __restrict__ keys,
                         const long long* __restrict__ perm,
                         const typename S::In* __restrict__ deltas, long long n, int L,
                         int dv, long long N, int T) {
  using V = typename S::Acc;
  // every branch below is warp-uniform (on w0, ballots or shuffled values),
  // so the full shuffle and ballot masks are always exact
  const long long w0 =
      (static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp) * kWarp;
  if (w0 >= n) return;
  const int lane = threadIdx.x % kWarp;
  const long long j = w0 + lane;
  const bool in = j < n;
  const int s = in ? __ldg(keys + j) : -1;
  const bool head = in && (j == 0 || __ldg(keys + j - 1) != s);
  const bool valid = s >= 0 && static_cast<long long>(s) < N;
  const bool is_long = in && long_head(keys, j, s, n, N, T);
  const unsigned head_mask = __ballot_sync(kFullMask, head);
  const unsigned short_mask = __ballot_sync(kFullMask, head && valid && !is_long);
  // the lane of the head of this lane's segment, if the segment starts in
  // this window: the segments that start earlier belong to an earlier warp
  const unsigned upto = head_mask & (lane == kWarp - 1 ? kFullMask : (2u << lane) - 1u);
  const int hl = upto ? kWarp - 1 - __clz(upto) : -1;
  const bool mine = in && hl >= 0 && ((short_mask >> hl) & 1u);
  const unsigned mine_mask = __ballot_sync(kFullMask, mine);
  if (!mine_mask) return;
  const long long bag = mine ? static_cast<int>(__ldg(perm + j)) / L : 0;
  // the last segment runs on past the window
  const bool extend = (mine_mask >> (kWarp - 1)) & 1u;
  const int last_key = __shfl_sync(kFullMask, s, kWarp - 1);

  for (int c0 = 0; c0 < dv; c0 += kWarp) {
    const int c = c0 + lane;
    const bool active = c < dv;
    V acc{};
    long long cur = -1;  // the row being summed
    for (int u0 = 0; u0 < kWarp; u0 += kPrefetch) {
      if (((mine_mask >> u0) & ((1u << kPrefetch) - 1u)) == 0) continue;
      V dbuf[kPrefetch], rbuf[kPrefetch];
      int sk[kPrefetch];
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        const int src = u0 + u;
        const long long bu = __shfl_sync(kFullMask, bag, src);
        sk[u] = __shfl_sync(kFullMask, s, src);
        const bool mu = (mine_mask >> src) & 1u;
        const bool hu = (head_mask >> src) & 1u;
        dbuf[u] = (active && mu) ? S::widen(__ldg(deltas + bu * dv + c)) : V{};
        rbuf[u] = (active && mu && hu)
                      ? S::widen(storage[static_cast<long long>(sk[u]) * dv + c])
                      : V{};
      }
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        const int src = u0 + u;
        if (!((mine_mask >> src) & 1u)) continue;
        if ((head_mask >> src) & 1u) {  // a new segment: the last one is done
          if (cur >= 0 && active) storage[cur * dv + c] = S::narrow(acc);
          acc = rbuf[u];
          cur = sk[u];
        }
        acc = S::add(acc, dbuf[u]);
      }
    }
    if (extend) {  // at most T - 1 more positions
      for (long long jb = w0 + kWarp; jb < n; jb += kWarp) {
        const long long jj = jb + lane;
        const bool more = jj < n && __ldg(keys + jj) == last_key;
        const unsigned m = __ballot_sync(kFullMask, more);
        // the segment is contiguous from jb: its leading run
        const int cnt = (m == kFullMask) ? kWarp : __ffs(~m) - 1;
        const long long my_bag = more ? static_cast<int>(__ldg(perm + jj)) / L : 0;
        for (int t0 = 0; t0 < cnt; t0 += kPrefetch) {
          V buf[kPrefetch];
#pragma unroll
          for (int u = 0; u < kPrefetch; ++u) {
            const long long bu = __shfl_sync(kFullMask, my_bag, (t0 + u) % kWarp);
            buf[u] = (active && t0 + u < cnt) ? S::widen(__ldg(deltas + bu * dv + c)) : V{};
          }
#pragma unroll
          for (int u = 0; u < kPrefetch; ++u)
            if (t0 + u < cnt) acc = S::add(acc, buf[u]);
        }
        if (cnt < kWarp) break;
      }
    }
    if (cur >= 0 && active) storage[cur * dv + c] = S::narrow(acc);
  }
}

// One CTA per (long segment, slab of kSlab columns) at a time, the tasks
// (the worklist's segments times the row's slabs) taken from a counter in
// work[1]: the adds of one column form
// one chain, so the columns of a row can go to different CTAs without
// reordering any add. El is the element type (F32Elem, BF16Elem), C the
// ring copy (16, 4 or 2 bytes; E elements).
template <typename El, typename C>
__global__ void __launch_bounds__(kThreads)
    scatter_long_kernel(typename El::T* __restrict__ storage, const int* __restrict__ keys,
                        const long long* __restrict__ perm,
                        const typename El::T* __restrict__ deltas, long long n, int L, int D,
                        long long* __restrict__ work) {
  using T = typename El::T;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // kStages x kStageRows x kSlab
  int* sbag = reinterpret_cast<int*>(ring + kStages * kStageRows * kSlab);  // kIdx
  __shared__ int part[kWarpsPerBlock];  // per-warp counts of the index block
  constexpr int E = sizeof(C) / sizeof(T);
  __shared__ long long next;  // this CTA's next task
  const int tid = threadIdx.x;
  const int slabs = (D + kSlab - 1) / kSlab;
  const long long tasks = work[0] * slabs;
  for (;;) {
    // a task at a time from the shared counter work[1]: a CTA held up by a
    // hot row takes no more (the loop's barriers order this write after
    // every thread's read of the last task)
    if (tid == 0)
      next = static_cast<long long>(
          atomicAdd(reinterpret_cast<unsigned long long*>(work + 1), 1ull));
    __syncthreads();
    const long long task = next;
    if (task >= tasks) break;
    const long long j0 = work[2 + task / slabs];
    const int c0 = static_cast<int>(task % slabs) * kSlab;
    const int w = min(kSlab, D - c0);
    const int wv = w / E;  // copies per row
    const int s = keys[j0];
    T* row = storage + static_cast<long long>(s) * D + c0;
    // the first warp adds: lane c owns column c0 + c
    float acc = tid < w ? El::widen(row[tid]) : 0.f;
    for (long long blk = j0;; blk += kIdx) {
      __syncthreads();  // the last block's readers of sbag, part and the ring are done
      // the segment's positions in [blk, blk + kIdx) are a prefix: count the
      // first kThreads, and load the rest only if those were all the segment's
      const long long p0 = blk + tid;
      const bool ok0 = p0 < n && __ldg(keys + p0) == s;
      sbag[tid] = ok0 ? static_cast<int>(__ldg(perm + p0)) / L : 0;
      int cnt = __syncthreads_count(ok0);
      if (cnt == kThreads) {
        int mine = 0;
#pragma unroll
        for (int q = 1; q < kIdx / kThreads; ++q) {
          const long long p = blk + tid + q * kThreads;
          const bool ok = p < n && __ldg(keys + p) == s;
          sbag[tid + q * kThreads] = ok ? static_cast<int>(__ldg(perm + p)) / L : 0;
          mine += ok;
        }
        mine = __reduce_add_sync(kFullMask, mine);
        if (tid % kWarp == 0) part[tid / kWarp] = mine;
        __syncthreads();
#pragma unroll
        for (int w8 = 0; w8 < kWarpsPerBlock; ++w8) cnt += part[w8];
      }
      const int nst = (cnt + kStageRows - 1) / kStageRows;
      auto issue = [&](int i) {  // stage i of this block's rows
        T* dst = ring + (i % kStages) * kStageRows * kSlab;
        const int r0 = i * kStageRows;
        const int rows = min(kStageRows, cnt - r0);
        for (int e = tid; e < rows * wv; e += kThreads) {
          const int r = e / wv;
          const int cv = e - r * wv;
          cp_async<C>(dst + r * kSlab + cv * E,
                      deltas + static_cast<long long>(sbag[r0 + r]) * D + c0 + cv * E);
        }
      };
#pragma unroll
      for (int i = 0; i < kStages - 1; ++i) {
        if (i < nst) issue(i);
        cp_async_commit();
      }
      for (int i = 0; i < nst; ++i) {
        cp_async_wait<kStages - 2>();  // stage i has landed (this thread's copies)
        __syncthreads();               // ... and every thread's; stage i - 1 is free
        if (i + kStages - 1 < nst) issue(i + kStages - 1);
        cp_async_commit();
        if (tid < w) {
          const T* src = ring + (i % kStages) * kStageRows * kSlab + tid;
          const int rows = min(kStageRows, cnt - i * kStageRows);
          int r = 0;
          for (; r + kBatch <= rows; r += kBatch) {  // loads first, then the chain
            float x[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) x[u] = El::widen(src[(r + u) * kSlab]);
#pragma unroll
            for (int u = 0; u < kBatch; ++u) acc = El::add(acc, x[u]);
          }
          for (; r < rows; ++r) acc = El::add(acc, El::widen(src[r * kSlab]));
        }
      }
      cp_async_wait<0>();
      if (cnt < kIdx) break;
    }
    if (tid < w) row[tid] = El::narrow(acc);
  }
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<std::uintptr_t>(p) & (bytes - 1u)) == 0;
}

bool bad_args(long long n, int L, int D, int T, long long work_cap) {
  return n <= 0 || n > INT32_MAX || L <= 0 || D <= 0 || T <= 0 || work_cap < n / (T + 1LL);
}

// The long kernel's stream, forked from and joined back to the caller's by
// two events: one set per host thread and device, made at its first use
// there, so two threads that launch at once never interleave one fork's
// record and wait (nor share a join). It has the greatest priority, so a
// long CTA takes the first SM room the short blocks free.
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
  int sms = 0;  // the device's SMs
};

cudaError_t side_for_device(Side** out) {
  static thread_local Side sides[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (sides[dev].stream == nullptr) {  // kept only once all of it is made
    Side side;
    int least = 0, greatest = 0;
    if ((err = cudaDeviceGetAttribute(&side.sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaDeviceGetStreamPriorityRange(&least, &greatest)) != cudaSuccess ||
        (err = cudaEventCreateWithFlags(&side.fork, cudaEventDisableTiming)) != cudaSuccess ||
        (err = cudaEventCreateWithFlags(&side.join, cudaEventDisableTiming)) != cudaSuccess ||
        (err = cudaStreamCreateWithPriority(&side.stream, cudaStreamNonBlocking, greatest)) !=
            cudaSuccess)
      return err;
    sides[dev] = side;
  }
  *out = &sides[dev];
  return cudaSuccess;
}

// S: the short kernel's lane chunk; El, C: the long kernel's element type
// and ring copy.
template <typename S, typename El, typename C>
int launch(void* storage, const int* keys, const long long* perm, const void* deltas,
           long long n, int L, int D, long long N, int T, long long* work, long long work_cap,
           cudaStream_t st) {
  using Elem = typename El::T;
  constexpr int E = sizeof(typename S::In) / sizeof(Elem);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  Side* side = nullptr;
  cudaError_t err = cudaMemsetAsync(work, 0, 2 * sizeof(long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (work_cap > 0) {  // n > T: a long segment may exist
    constexpr size_t smem = sizeof(Elem) * kStages * kStageRows * kSlab + sizeof(int) * kIdx;
    if ((err = side_for_device(&side)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(scatter_long_kernel<El, C>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess)
      return static_cast<int>(err);
    scatter_classify_kernel<<<blocks, kThreads, 0, st>>>(keys, n, N, T, work);
    if ((err = cudaGetLastError()) != cudaSuccess ||
        (err = cudaEventRecord(side->fork, st)) != cudaSuccess ||
        (err = cudaStreamWaitEvent(side->stream, side->fork, 0)) != cudaSuccess)
      return static_cast<int>(err);
    // the long segments run beside the short ones (their rows are disjoint)
    const long long tasks = work_cap * ((D + kSlab - 1) / kSlab);  // at most
    const long long most = 2LL * side->sms;  // 2 CTAs of 80 KB (fp32) fit an SM
    scatter_long_kernel<El, C><<<static_cast<unsigned>(tasks < most ? tasks : most), kThreads,
                                 smem, side->stream>>>(
        static_cast<Elem*>(storage), keys, perm, static_cast<const Elem*>(deltas), n, L, D,
        work);
    if ((err = cudaGetLastError()) != cudaSuccess ||
        (err = cudaEventRecord(side->join, side->stream)) != cudaSuccess)
      return static_cast<int>(err);
  }
  scatter_short_kernel<S><<<blocks, kThreads, 0, st>>>(  // a warp per 32 positions
      static_cast<typename S::In*>(storage), keys, perm,
      static_cast<const typename S::In*>(deltas), n, L, D / E, N, T);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (side != nullptr) err = cudaStreamWaitEvent(st, side->join, 0);  // the join
  return static_cast<int>(err);
}

}  // namespace

// n < 2^31 lookups (their positions are divided in 32 bits). T: a segment
// longer than T lookups goes to the long-segment kernel.
// work: (2 + work_cap) int64 of scratch, work_cap >= n / (T + 1) (the most
// long segments n lookups can hold); work[0] ends as their count and
// work[2 .. count + 1] as their first sorted positions, in no fixed order
// (work[1] counts the long kernel's tasks taken).
extern "C" int repro_scatter_add_sorted_f32(float* storage, const int* keys,
                                            const long long* perm,
                                            const float* deltas, long long n,
                                            int L, int D, long long N, int T,
                                            long long* work, long long work_cap,
                                            void* stream) {
  if (bad_args(n, L, D, T, work_cap)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && aligned(storage, 16) && aligned(deltas, 16))
    return launch<F32Lane<float4>, F32Elem, float4>(storage, keys, perm, deltas, n, L, D, N, T,
                                                    work, work_cap, st);
  return launch<F32Lane<float>, F32Elem, float>(storage, keys, perm, deltas, n, L, D, N, T,
                                                work, work_cap, st);
}

// The same on a bf16 storage (N, D) with bf16 deltas, each add rounded.
extern "C" int repro_scatter_add_sorted_bf16(void* storage, const int* keys,
                                             const long long* perm, const void* deltas,
                                             long long n, int L, int D, long long N, int T,
                                             long long* work, long long work_cap,
                                             void* stream) {
  if (bad_args(n, L, D, T, work_cap)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool lane4 = D % 4 == 0 && aligned(storage, 8) && aligned(deltas, 8);
  if (D % 8 == 0 && aligned(deltas, 16)) {  // 16-byte ring copies
    return lane4 ? launch<BF16Lane4, BF16Elem, uint4>(storage, keys, perm, deltas, n, L, D, N,
                                                       T, work, work_cap, st)
                 : launch<BF16Lane1, BF16Elem, uint4>(storage, keys, perm, deltas, n, L, D, N,
                                                       T, work, work_cap, st);
  }
  if (D % 2 == 0 && aligned(deltas, 4)) {
    return lane4 ? launch<BF16Lane4, BF16Elem, unsigned>(storage, keys, perm, deltas, n, L, D,
                                                          N, T, work, work_cap, st)
                 : launch<BF16Lane1, BF16Elem, unsigned>(storage, keys, perm, deltas, n, L, D,
                                                          N, T, work, work_cap, st);
  }
  return launch<BF16Lane1, BF16Elem, unsigned short>(storage, keys, perm, deltas, n, L, D, N,
                                                     T, work, work_cap, st);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
