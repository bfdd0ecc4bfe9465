// Kernel B6: ragged sorted-run row sums.
//
// Replaces the TPU kernel nllstpu/ops/pallas/segment_sum.py:
// segment_block_sum (body _kernel).  There each grid program walked 8
// segments and DMA'd every run in 256-row chunks into VMEM, with the
// feature axis padded to 128 lanes and the data padded by a chunk of
// zero rows; none of that padding exists here.
//
//   out[l, :] = sum of data[starts[l] .. starts[l+1] - 1, :]   l < L
//
// data [N, D] row-major, starts [L+1] non-decreasing (int32 or int64).
// Run l is rows [s_l, e_l) with s_l = clamp(starts[l], 0, N) and e_l =
// max(clamp(starts[l+1], 0, N), s_l): rows before starts[0] or past
// starts[L] are never read, and a bad table cannot read out of bounds.
//
// Design: chunk-parallel segmented sum, two launches, no atomics.  The
// rows [s_0, e_{L-1}) are cut into chunks of R rows (R*D values, one
// contiguous span; R comes from the wrapper, so its plain mirror of this
// order, segment_sum.py:segment_block_sum_chunked, uses the same cut).
// The parallel work follows the number of rows, not the run lengths: a
// camera run of 3,500 rows spreads over ~70 blocks, and a chunk of short
// landmark runs keeps every thread busy.
//   pass 1, one block per chunk: cp.async copies the chunk element by
//     element (coalesced, all copies in flight at once) into shared
//     memory while two warps find the chunk's first and last run by
//     32-way searches of starts.  At D <= kStageMaxD, where a chunk holds
//     more (run, column) items than threads, the block stages the runs'
//     starts in shared memory (up to kRuns of them; wider rows get no
//     such buffer, which would only shrink L1).  Then thread (run,
//     column) items sum their rows from shared memory in row order.  A run that lies whole inside
//     the chunk is written to out; the run that holds the chunk's first
//     row and started before it (or runs past its end) leaves its partial
//     in part[2c]; the run that starts inside and runs past the end
//     leaves it in part[2c + 1].
//   pass 2, one thread per (run, column): an empty run writes zeros; a
//     run that crosses chunks adds its partials in chunk order: its first
//     chunk's (part[2c0], or part[2c0 + 1] when it does not start the
//     chunk), then part[2c] of every later chunk up to its last.
// Every addition has a fixed order, so two launches give the same bits.
// No host sync: the grid is sized from N, and blocks past e_{L-1} exit.
//
// Bound: bytes.  Each value in the runs is read once and each output
// value written once; the partials add two rows per chunk, ~2/R of the
// input (R = 4096 / D rows).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRuns = 1024;     // run bounds a chunk stages in shared memory
constexpr int kStageMaxD = 32;  // widest row that stages them
constexpr unsigned kFull = 0xffffffffu;

template <typename I>
__device__ __forceinline__ long long clamp_row(I v, long long lo, long long hi) {
  long long x = static_cast<long long>(v);
  return x < lo ? lo : (x > hi ? hi : x);
}

// First index i in [lo, hi) with starts[i] > key (strict) or >= key (not
// strict), hi if there is none, by one warp: each step probes 32 evenly
// spaced entries, so L = 226,730 runs take four dependent loads.
template <typename I>
__device__ long long warp_search(const I* __restrict__ starts, long long lo,
                                 long long hi, long long key, bool strict) {
  // Invariant: the answer lies in [lo, hi], hi meaning "none before hi".
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long idx = lo + lane * step;
    bool hit = idx >= hi;
    if (!hit) {
      const long long v = static_cast<long long>(starts[idx]);
      hit = strict ? v > key : v >= key;
    }
    const unsigned ballot = __ballot_sync(kFull, hit);
    if (ballot == 0) {  // every probe below hi and false
      lo += 31 * step + 1;
      continue;
    }
    const int f = __ffs(ballot) - 1;
    if (f == 0) return lo;
    const long long next_hi = lo + f * step;  // the first hit is in (probe f-1, probe f]
    lo += (f - 1) * step + 1;
    hi = next_hi < hi ? next_hi : hi;
  }
  return hi;
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
               "n"(sizeof(T)));
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads) segment_chunks_kernel(
    const T* __restrict__ data, const I* __restrict__ starts,
    T* __restrict__ out, T* __restrict__ part, long long n, int L, int D,
    int R, int stage_cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  // clamp(starts[run_lo + i]), stage_cap + 1 of them after the tile
  long long* bounds = reinterpret_cast<long long*>(
      smem_raw + ((sizeof(T) * static_cast<size_t>(R) * D + 15) & ~static_cast<size_t>(15)));
  __shared__ long long run_lo, run_hi;
  const long long base = clamp_row(starts[0], 0, n);
  const long long end = clamp_row(starts[L], base, n);
  const long long c = blockIdx.x;
  const long long r0 = base + c * R;
  if (r0 >= end) return;  // the whole block leaves together
  const long long r1 = r0 + R < end ? r0 + R : end;
  const int nel = static_cast<int>(r1 - r0) * D;
  const T* src = data + r0 * D;
  for (int i = threadIdx.x; i < nel; i += kThreads) cp_async(tile + i, src + i);
  asm volatile("cp.async.commit_group;\n" ::);
  // Runs meeting [r0, r1): from the first l with starts[l+1] > r0 (warp
  // 0) up to the first l with starts[l] >= r1 (warp 1).
  if (threadIdx.x < 32) {
    const long long a = warp_search(starts, 1, static_cast<long long>(L) + 1, r0, true) - 1;
    if (threadIdx.x == 0) run_lo = a;
  } else if (threadIdx.x < 64) {
    const long long b = warp_search(starts, 0, static_cast<long long>(L) + 1, r1, false);
    if (threadIdx.x == 32) run_hi = b < L ? b : L;
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  const long long a = run_lo;
  const int nruns = static_cast<int>(run_hi - a);
  const int items = nruns * D;  // L * D < 2^31: see the launcher
  // Short runs (more items than threads): stage the run bounds once, so
  // the item loop's later rounds read shared memory.  The condition is
  // the same for the whole block.
  const bool staged = items > kThreads && nruns <= stage_cap;
  if (staged) {
    for (int i = threadIdx.x; i <= nruns; i += kThreads) bounds[i] = clamp_row(starts[a + i], 0, n);
    __syncthreads();
  }
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int k = it / D;
    const int j = it % D;
    const long long l = a + k;
    const long long s = staged ? bounds[k] : clamp_row(starts[l], 0, n);
    long long e = staged ? bounds[k + 1] : clamp_row(starts[l + 1], 0, n);
    e = e > s ? e : s;
    if (e <= s) continue;  // empty: pass 2 writes its zeros
    const int lo = static_cast<int>((s > r0 ? s : r0) - r0);  // rows of the tile
    const int hi = static_cast<int>((e < r1 ? e : r1) - r0);
    T acc = T(0);
    for (int r = lo; r < hi; ++r) acc += tile[r * D + j];
    if (s >= r0 && e <= r1) {
      out[l * D + j] = acc;
    } else if (s <= r0) {
      part[(2 * c) * D + j] = acc;
    } else {
      part[(2 * c + 1) * D + j] = acc;
    }
  }
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads) segment_combine_kernel(
    const I* __restrict__ starts, const T* __restrict__ part,
    T* __restrict__ out, long long n, int L, int D, int R) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= L * D) return;
  const int l = idx / D;
  const int j = idx % D;
  const long long base = clamp_row(starts[0], 0, n);
  const long long s = clamp_row(starts[l], 0, n);
  long long e = clamp_row(starts[l + 1], 0, n);
  if (e <= s) {
    out[idx] = T(0);
    return;
  }
  // One division per thread, 32-bit where the offset allows: most runs
  // end inside their first chunk, and pass 1 wrote those.
  const long long off = s - base;
  const long long c0 = off <= INT_MAX ? static_cast<long long>(static_cast<unsigned>(off) /
                                                              static_cast<unsigned>(R))
                                      : off / R;
  if (e <= base + (c0 + 1) * R) return;
  const long long c1 = (e - 1 - base) / R;
  T acc = part[(2 * c0 + (s == base + c0 * R ? 0 : 1)) * D + j];
  for (long long c = c0 + 1; c <= c1; ++c) acc += part[(2 * c) * D + j];
  out[idx] = acc;
}

template <typename T, typename I>
int launch_segment_block_sum(const void* data, const void* starts, void* out,
                             void* part, long long n, int L, int D, int R,
                             void* stream) {
  if (L <= 0 || D <= 0) return 0;
  // 32-bit (run, column) indices; the wrapper refuses larger outputs.
  if (R <= 0 || static_cast<long long>(L) * D + kThreads > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int stage_cap = D <= kStageMaxD ? kRuns : 0;
  const size_t smem = ((sizeof(T) * static_cast<size_t>(R) * D + 15) & ~static_cast<size_t>(15)) +
                      (stage_cap ? sizeof(long long) * (stage_cap + 1) : 0);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        segment_chunks_kernel<T, I>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long chunks = n > 0 ? (n + R - 1) / R : 0;
  if (chunks > 0) {
    segment_chunks_kernel<T, I><<<static_cast<unsigned>(chunks), kThreads, smem, st>>>(
        static_cast<const T*>(data), static_cast<const I*>(starts),
        static_cast<T*>(out), static_cast<T*>(part), n, L, D, R, stage_cap);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long total = static_cast<long long>(L) * D;
  segment_combine_kernel<T, I>
      <<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0, st>>>(
          static_cast<const I*>(starts), static_cast<const T*>(part),
          static_cast<T*>(out), n, L, D, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int segment_block_sum_f32_i32(const void* data, const void* starts, void* out,
                              void* part, long long n, int l, int d, int r,
                              void* stream) {
  return launch_segment_block_sum<float, int32_t>(data, starts, out, part, n,
                                                  l, d, r, stream);
}

int segment_block_sum_f32_i64(const void* data, const void* starts, void* out,
                              void* part, long long n, int l, int d, int r,
                              void* stream) {
  return launch_segment_block_sum<float, int64_t>(data, starts, out, part, n,
                                                  l, d, r, stream);
}

int segment_block_sum_f64_i32(const void* data, const void* starts, void* out,
                              void* part, long long n, int l, int d, int r,
                              void* stream) {
  return launch_segment_block_sum<double, int32_t>(data, starts, out, part, n,
                                                   l, d, r, stream);
}

int segment_block_sum_f64_i64(const void* data, const void* starts, void* out,
                              void* part, long long n, int l, int d, int r,
                              void* stream) {
  return launch_segment_block_sum<double, int64_t>(data, starts, out, part, n,
                                                   l, d, r, stream);
}

}  // extern "C"
