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
// Design: one block per landmark.  It zeroes the landmark's [dl, wc] row
// in shared memory, walks the landmark's costs in order (thread i adds
// entry i of every cost, so two costs of one camera add in the same thread
// and in run order), and writes the whole row once, zeros included: no
// memset pass, no atomics, the same bits on every run.  An empty run
// writes a zero row.  Camera column blocks must not overlap, as the
// reduced layout guarantees.
//
// Bound: bytes.  W is written once (dl * wc values per landmark, ~114 MB
// in float32 on the bench-realistic adaptive problem) and each coupling
// block read once; there is one add per input value.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 227 * 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads) place_w_kernel(
    const T* __restrict__ we, const int32_t* __restrict__ lstarts,
    const int32_t* __restrict__ colbase, T* __restrict__ w, long long n,
    int dl, int dr_s, int wc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* row = reinterpret_cast<T*>(smem_raw);
  const int width = dl * wc;
  const int x = dl * dr_s;
  const long long l = blockIdx.x;
  for (int i = threadIdx.x; i < width; i += kThreads) row[i] = T(0);
  long long s = lstarts[l];
  long long e = lstarts[l + 1];
  s = s < 0 ? 0 : (s > n ? n : s);
  e = e > n ? n : e;
  __syncthreads();
  for (long long b = s; b < e; ++b) {
    const int c = colbase[b];
    if (c < 0 || c > wc - dr_s) continue;  // the same for every thread
    for (int i = threadIdx.x; i < x; i += kThreads) {
      const int d = i / dr_s;
      row[d * wc + c + i % dr_s] += we[b * x + i];
    }
  }
  __syncthreads();
  T* out = w + l * width;
  for (int i = threadIdx.x; i < width; i += kThreads) out[i] = row[i];
}

template <typename T>
int launch_place_w(const void* we, const void* lstarts, const void* colbase,
                   void* w, long long n, int L, int dl, int dr_s, int wc,
                   void* stream) {
  if (L <= 0) return 0;
  const size_t smem = sizeof(T) * static_cast<size_t>(dl) * wc;
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        place_w_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  place_w_kernel<T><<<L, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(we), static_cast<const int32_t*>(lstarts),
      static_cast<const int32_t*>(colbase), static_cast<T*>(w), n, dl, dr_s,
      wc);
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
