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
// Rows before starts[0] or past starts[L] are never read; run ends are
// clamped to N, so a bad table cannot read out of bounds.
//
// Design: one warp per segment.  For each pass of up to kCols = 8
// columns, lane j sums rows starts[l] + j, + j + 32, ... into registers,
// then a fixed xor-shuffle tree combines the 32 partial sums, and lane 0
// writes the row of out.  The order of every addition is fixed, so the
// result is the same from run to run, and no atomics are needed.  An
// empty run writes zeros.  The work is indifferent to skew within a
// launch only as far as warps are: a long run (a camera's ~700-3,500
// costs) keeps one warp busy while short ones finish.
//
// Bound: bytes.  Each input row is read once per 8-column pass, each
// output value written once; there is one add per input value.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 8;     // columns held in registers per pass
constexpr int kWarps = 8;    // segments per 256-thread block
constexpr unsigned kFull = 0xffffffffu;

template <typename T, typename I>
__global__ void __launch_bounds__(32 * kWarps) segment_block_sum_kernel(
    const T* __restrict__ data, const I* __restrict__ starts,
    T* __restrict__ out, long long n, int L, int D) {
  const int lane = threadIdx.x & 31;
  const long long seg =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (seg >= L) return;  // whole warps leave together
  long long s = static_cast<long long>(starts[seg]);
  long long e = static_cast<long long>(starts[seg + 1]);
  s = s < 0 ? 0 : (s > n ? n : s);
  e = e > n ? n : e;
  for (int c0 = 0; c0 < D; c0 += kCols) {
    const int nc = D - c0 < kCols ? D - c0 : kCols;
    T acc[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] = T(0);
    for (long long r = s + lane; r < e; r += 32) {
      const T* row = data + r * D + c0;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (j < nc) acc[j] += row[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        acc[j] += __shfl_xor_sync(kFull, acc[j], off);
    }
    if (lane == 0) {
      T* o = out + seg * D + c0;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (j < nc) o[j] = acc[j];
    }
  }
}

template <typename T, typename I>
int launch_segment_block_sum(const void* data, const void* starts, void* out,
                             long long n, int L, int D, void* stream) {
  if (L <= 0 || D <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((L + kWarps - 1) / kWarps);
  segment_block_sum_kernel<T, I>
      <<<blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(data), static_cast<const I*>(starts),
          static_cast<T*>(out), n, L, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int segment_block_sum_f32_i32(const void* data, const void* starts, void* out,
                              long long n, int l, int d, void* stream) {
  return launch_segment_block_sum<float, int32_t>(data, starts, out, n, l, d,
                                                  stream);
}

int segment_block_sum_f32_i64(const void* data, const void* starts, void* out,
                              long long n, int l, int d, void* stream) {
  return launch_segment_block_sum<float, int64_t>(data, starts, out, n, l, d,
                                                  stream);
}

int segment_block_sum_f64_i32(const void* data, const void* starts, void* out,
                              long long n, int l, int d, void* stream) {
  return launch_segment_block_sum<double, int32_t>(data, starts, out, n, l, d,
                                                   stream);
}

int segment_block_sum_f64_i64(const void* data, const void* starts, void* out,
                              long long n, int l, int d, void* stream) {
  return launch_segment_block_sum<double, int64_t>(data, starts, out, n, l, d,
                                                   stream);
}

}  // extern "C"
