// Kernel B7: placement of the Schur coupling W for the direct solve.
//
// Replaces the TPU kernel nllstpu/ops/pallas/w_place.py:place_w_pm (body
// _kernel).  There W was p-major and landmark-minor, and each camera id was
// compared against an iota of padded camera columns (a one-hot) because
// Mosaic could not cast the standard interleave; here W stays in the
// port's standard landmark-major basis and each cost knows its column.
//
//   w[l, d, colbase[b] + p] = sum over the costs b of landmark l of
//                             we[b, d, p]
//
// we [B, dl, dr_s] (costs sorted by landmark), lstarts [L+1] (landmark l
// owns rows lstarts[l] .. lstarts[l+1] - 1), colbase [B] (the first W
// column of cost b's camera; a cost whose columns do not fit in [0, wc),
// a negative colbase among them, is dropped), w [L, dl, wc].  Run ends
// are clamped to [0, B], so a bad table cannot read out of bounds.
//
// Design: a block of 128 threads builds the rows of LPB consecutive
// landmarks (LPB = 16 KB / row bytes, at least 1: one float32 row of the
// bench-realistic adaptive W) in shared memory and writes them once, zeros
// included, as one contiguous span of W with 16-byte stores: no memset
// pass.  A row past the 227 KB a block can hold (dl * wc values, e.g. a
// float64 dl 18 row over 1,620 columns) is built in column spans of 16 KB,
// a block each, whose items add only the costs landing in their span, in
// the same run order, so every entry keeps its one adding thread.  The
// launch bounds hold a thread to 64 registers, so that eight
// blocks share an SM and one block's adds (latency-bound) overlap the
// others' stores: 256 threads without the register cap ran a third
// slower, and a persistent variant whose spans leave by double-buffered
// TMA bulk stores was no faster.  Three phases:
//   1. zero the span in shared memory (16-byte stores); the span starts
//      at W's element offset modulo 16 bytes, so the 16-byte global
//      stores read 16-byte-aligned shared words;
//   2. item (landmark, d, p) -- one thread each -- walks its landmark's
//      costs in run order, eight at a time: the eight colbase values and
//      the eight coupling values are loaded together (coalesced across
//      the item's neighbours, no chain of dependent loads), then added in
//      order into the shared row.  Two costs of one camera land on the
//      same item, so they add in run order in one thread;
//   3. write the span: a scalar head up to the first 16-byte boundary,
//      16-byte stores, a scalar tail.
// No atomics: the same bits on every run.  An empty run writes a zero
// row.  Camera column blocks must not overlap, as the reduced layout
// guarantees.
//
// Bound: bytes.  W is written once (dl * wc values per landmark, 113.5 MB
// in float32 on the bench-realistic adaptive problem) and each coupling
// block read once; there is one add per input value.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 8;           // blocks per SM: at most 64 registers
constexpr int kMaxSmem = 227 * 1024;
constexpr int kSpanBytes = 16 * 1024;  // target shared span per block
constexpr int kUnroll = 8;              // costs loaded together

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

// spans == 0: a block builds the rows of lpb landmarks from landmark
// blockIdx.x * lpb.  spans > 0 (a row past the shared memory): a block
// builds one column span of one landmark's row, span values of it from
// value (blockIdx.x % spans) * span of landmark blockIdx.x / spans; its
// items are the (d, p) whose row d meets the span, and each adds only the
// costs whose column lands inside it, still in run order.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks) place_w_kernel(
    const T* __restrict__ we, const int32_t* __restrict__ lstarts,
    const int32_t* __restrict__ colbase, T* __restrict__ w, long long n, int L,
    int dl, int dr_s, int wc, int lpb, int spans, int span) {
  using V = typename Vec16<T>::type;
  constexpr int kV = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);
  const long long width = static_cast<long long>(dl) * wc;
  const int x = dl * dr_s;
  long long l0, g0, g1;  // first landmark; W's span [g0, g1)
  int nl, d0, nd;        // landmarks; rows d0 .. d0 + nd - 1 of each
  if (spans == 0) {
    l0 = static_cast<long long>(blockIdx.x) * lpb;
    nl = static_cast<int>(L - l0 < lpb ? L - l0 : lpb);
    g0 = l0 * width;
    g1 = g0 + nl * width;
    d0 = 0;
    nd = dl;
  } else {
    l0 = blockIdx.x / spans;
    nl = 1;
    const long long o0 = static_cast<long long>(blockIdx.x % spans) * span;
    const long long o1 = o0 + span < width ? o0 + span : width;
    g0 = l0 * width + o0;
    g1 = l0 * width + o1;
    d0 = static_cast<int>(o0 / wc);
    nd = static_cast<int>((o1 - 1) / wc) - d0 + 1;
  }
  const int shift = static_cast<int>(g0 % kV);  // buf[shift] holds w[g0]
  const int len = static_cast<int>((shift + (g1 - g0) + kV - 1) / kV);
  // 1. zero the span.
  const V zero = {};
  for (int i = threadIdx.x; i < len; i += kThreads) reinterpret_cast<V*>(buf)[i] = zero;
  __syncthreads();
  // 2. add each landmark's costs in run order, one thread per (l, d, p).
  const int y = nd * dr_s;
  for (int it = threadIdx.x; it < nl * y; it += kThreads) {
    const int jl = it / y;
    const int d = d0 + (it % y) / dr_s;
    const int p = it % dr_s;
    const int i = d * dr_s + p;
    long long s = lstarts[l0 + jl];
    long long e = lstarts[l0 + jl + 1];
    s = s < 0 ? 0 : (s > n ? n : s);
    e = e > n ? n : e;
    // W's index of this item at column 0 of its row, and its place in buf.
    const long long g = (l0 + jl) * width + static_cast<long long>(d) * wc + p;
    T* row = buf + shift + (g - g0);
    for (long long b0 = s; b0 < e; b0 += kUnroll) {
      int cb[kUnroll];
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long b = b0 + u;
        cb[u] = b < e ? colbase[b] : -1;
        v[u] = b < e ? we[b * x + i] : T(0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = cb[u];
        if (c >= 0 && c <= wc - dr_s && g + c >= g0 && g + c < g1) row[c] += v[u];
      }
    }
  }
  __syncthreads();
  // 3. write the span: scalar head and tail, 16-byte stores between.
  const long long a = (g0 + kV - 1) / kV * kV;
  const long long z = g1 / kV * kV;
  if (a >= z) {
    for (long long g = g0 + threadIdx.x; g < g1; g += kThreads) w[g] = buf[g - g0 + shift];
    return;
  }
  if (threadIdx.x < a - g0) w[g0 + threadIdx.x] = buf[shift + threadIdx.x];
  if (threadIdx.x < g1 - z) w[z + threadIdx.x] = buf[z - g0 + shift + threadIdx.x];
  const V* src = reinterpret_cast<const V*>(buf + (a - g0 + shift));
  V* dst = reinterpret_cast<V*>(w + a);
  const long long nv = (z - a) / kV;
  for (long long i = threadIdx.x; i < nv; i += kThreads) dst[i] = src[i];
}

template <typename T>
int launch_place_w(const void* we, const void* lstarts, const void* colbase,
                   void* w, long long n, int L, int dl, int dr_s, int wc,
                   void* stream) {
  if (L <= 0) return 0;
  const size_t row = sizeof(T) * static_cast<size_t>(dl) * wc;
  long long lpb = row > 0 ? static_cast<long long>(kSpanBytes / row) : L;
  lpb = lpb < 1 ? 1 : (lpb > L ? L : lpb);
  size_t smem = row * lpb + 32;  // + the shift and the last 16 bytes
  long long blocks = (L + lpb - 1) / lpb;
  int spans = 0;
  const int span = kSpanBytes / static_cast<int>(sizeof(T));
  if (smem > static_cast<size_t>(kMaxSmem)) {  // a row in column spans
    spans = static_cast<int>((static_cast<long long>(dl) * wc + span - 1) / span);
    blocks = static_cast<long long>(L) * spans;
    smem = static_cast<size_t>(kSpanBytes) + 32;
  }
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        place_w_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  place_w_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(we), static_cast<const int32_t*>(lstarts),
      static_cast<const int32_t*>(colbase), static_cast<T*>(w), n, L, dl, dr_s,
      wc, static_cast<int>(lpb), spans, span);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int place_w_f32(const void* we, const void* lstarts, const void* colbase,
                void* w, long long n, int l, int dl, int dr_s, int wc,
                void* stream) {
  return launch_place_w<float>(we, lstarts, colbase, w, n, l, dl, dr_s, wc,
                               stream);
}

int place_w_f64(const void* we, const void* lstarts, const void* colbase,
                void* w, long long n, int l, int dl, int dr_s, int wc,
                void* stream) {
  return launch_place_w<double>(we, lstarts, colbase, w, n, l, dl, dr_s, wc,
                                stream);
}

}  // extern "C"
