// Kernels B1, B2 and B8: Schur-system assembly in one pass over the
// obs-major Jacobian of a bundle-adjustment batch.
//
// B1 replaces the TPU kernel nllstpu/ops/pallas/fused_obs.py:
// fused_obs_all_pm (body _kernel_all) and takes a uniform layout: one
// bucket covering every landmark.  B2 replaces fused_obs_all_pm_into (body
// _kernel_all_accum) and takes one degree bucket of a skewed layout: the
// same pass over the bucket's L_b landmarks, whose h_ll, g_l and W rows are
// ADDED into full-size buffers at landmark l_base + l.  Chunk buckets
// revisit the heavy landmarks of a later bucket, so B2 never overwrites.
// B8 replaces fused_obs_leg_pm (body _kernel): B1 with the camera side
// compiled out (CAM = false), for the dual-sorted route, whose
// camera-major leg sums a_rr and b_r over camera runs in plain PyTorch.
// None of the three uses shared memory or atomics: every output entry is
// written by the one thread that owns its landmark or its slot, so each
// gives the same bits on every launch.
// Launches of one assembly run in order on one stream; within a launch each
// thread owns distinct landmarks, so the read-modify-write of h_ll, g_l and
// W needs no atomics.  The TPU kernel's tile-aligned left shift,
// input/output aliasing and NRp padding have no counterpart here.
//
// Same math, not the same layout: the TPU kernels keep
// W p-major and landmark-minor because of Mosaic's tiling; here W is stored
// in the standard basis, landmark-major [L, dl, n_r*dr_s], so that one
// landmark's coupling row is contiguous and owned by one thread.
//
// Inputs (K run slots per landmark, L landmarks of the bucket, row-major):
//   jac [n, S, K, L]   residual Jacobian, S = dr_s + dl tangent columns
//   g0  [S, K, L]      unweighted gradient J^T r
//   d1  [K, L]         rho' * mask
//   d2  [K, L]         2 * rho'' * mask  (pre-doubled by the caller)
//   vc  [K, L] int32   camera column per slot; n_r (the dustbin) for pad
//                      slots and fixed cameras
//   cpos [K, L] int32  (B1/B2) the slot's row in the camera-sorted order of
//                      the batch's non-dustbin slots, -1 for a dustbin slot
// Outputs (B1: L_total = L, l_base = 0, h_ll and g_l written; B2: every
// output added into):
//   h_ll [dl, dl, L_total]  sum_k rho' Je^T Je + 2 rho'' g0e g0e^T
//   g_l  [dl, L_total]      sum_k rho' g0e
//   w    [L_total, dl, n_r*dr_s]  rho' Jr^T Je + 2 rho'' g0r g0e^T added at the
//                      slot's camera column (B1: zero on entry; a landmark
//                      seen twice by one camera adds twice)
//   rows [n_rows, npairs + dr_s]  (B1/B2) row cpos of each non-dustbin
//                      slot: its a_rr upper triangle (entry idx(p, q), p <=
//                      q) then its b_r, written once (not added)
//
// Design: one thread per landmark.  The thread walks the landmark's K slots
// and keeps h_ll and g_l in registers; it owns its W row, so the W update
// is a plain read-modify-write.  The camera side (a_rr, b_r) is shared by
// many landmarks: the thread writes each slot's npairs + dr_s camera
// values to the slot's own row of `rows`, and the wrapper sums the camera
// runs of `rows` with kernel B6 (segment_sum.cu), every addition in a
// fixed order, as the TPU kernel adds its per-tile contributions in grid
// order.  So B1 and B2 give the same bits on every launch.
//
// Bound: device-memory traffic (the Jacobian read once, W's touched rows
// and the camera rows written once) and, at the bench shape, latency - one
// thread per landmark gives few warps per SM.  Slots of a dustbin camera
// (fixed camera or pad) still add to h_ll and g_l, whose weights are
// masked by the caller, but never to W or the camera side.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

template <typename T, int N, int DR, int DL, bool ACCUM, bool CAM>
__global__ void fused_obs_all_kernel(
    const T* __restrict__ jac, const T* __restrict__ g0,
    const T* __restrict__ d1, const T* __restrict__ d2,
    const int* __restrict__ vc, const int* __restrict__ cpos,
    T* __restrict__ h_ll, T* __restrict__ g_l, T* __restrict__ w,
    T* __restrict__ rows, int K, int L, int L_total, int l_base, int n_r,
    int n_rows, int e_start) {
  constexpr int S = DR + DL;
  constexpr int NP = DR * (DR + 1) / 2;
  constexpr int NAB = NP + DR;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l < L) {
    const size_t kl = static_cast<size_t>(K) * L;
    const size_t wc = static_cast<size_t>(n_r) * DR;
    T h[DL][DL];
    T g[DL];
#pragma unroll
    for (int a = 0; a < DL; ++a) {
      g[a] = T(0);
#pragma unroll
      for (int b = 0; b < DL; ++b) h[a][b] = T(0);
    }
    const size_t lg = static_cast<size_t>(l_base) + l;  // row in the buffers
    T* wrow = w + lg * DL * wc;
    for (int k = 0; k < K; ++k) {
      const size_t o = static_cast<size_t>(k) * L + l;
      const T dd1 = d1[o];
      const T dd2 = d2[o];
      const int v = vc[o];
      T je[N][DL], jr[N][DR], ge[DL], gr[DR];
#pragma unroll
      for (int d = 0; d < DL; ++d) {
        ge[d] = g0[static_cast<size_t>(e_start + d) * kl + o];
#pragma unroll
        for (int ni = 0; ni < N; ++ni)
          je[ni][d] = jac[(static_cast<size_t>(ni) * S + e_start + d) * kl + o];
      }
#pragma unroll
      for (int p = 0; p < DR; ++p) {
        const int row = p < e_start ? p : p + DL;
        gr[p] = g0[static_cast<size_t>(row) * kl + o];
#pragma unroll
        for (int ni = 0; ni < N; ++ni)
          jr[ni][p] = jac[(static_cast<size_t>(ni) * S + row) * kl + o];
      }
#pragma unroll
      for (int e1 = 0; e1 < DL; ++e1) {
        g[e1] += ge[e1] * dd1;
#pragma unroll
        for (int e2 = e1; e2 < DL; ++e2) {
          T jj = T(0);
#pragma unroll
          for (int ni = 0; ni < N; ++ni) jj += je[ni][e1] * je[ni][e2];
          h[e1][e2] += jj * dd1 + dd2 * ge[e1] * ge[e2];
        }
      }
      if (v >= 0 && v < n_r) {
        T* wv = wrow + static_cast<size_t>(v) * DR;
#pragma unroll
        for (int d = 0; d < DL; ++d) {
#pragma unroll
          for (int p = 0; p < DR; ++p) {
            T jj = T(0);
#pragma unroll
            for (int ni = 0; ni < N; ++ni) jj += jr[ni][p] * je[ni][d];
            wv[d * wc + p] += jj * dd1 + dd2 * gr[p] * ge[d];
          }
        }
      }
      if constexpr (CAM) {
        const int cp = cpos[o];
        if (cp >= 0 && cp < n_rows) {
          T* crow = rows + static_cast<size_t>(cp) * NAB;
          int idx = 0;
#pragma unroll
          for (int p = 0; p < DR; ++p) {
#pragma unroll
            for (int q = p; q < DR; ++q) {
              T jj = T(0);
#pragma unroll
              for (int ni = 0; ni < N; ++ni) jj += jr[ni][p] * jr[ni][q];
              crow[idx] = jj * dd1 + dd2 * gr[p] * gr[q];
              ++idx;
            }
          }
#pragma unroll
          for (int p = 0; p < DR; ++p) crow[NP + p] = gr[p] * dd1;
        }
      }
    }
    const size_t lt = static_cast<size_t>(L_total);
#pragma unroll
    for (int e1 = 0; e1 < DL; ++e1) {
      const size_t ig = e1 * lt + lg;
      g_l[ig] = ACCUM ? g_l[ig] + g[e1] : g[e1];
#pragma unroll
      for (int e2 = e1; e2 < DL; ++e2) {
        const size_t i12 = (e1 * DL + e2) * lt + lg;
        const T hv = ACCUM ? h_ll[i12] + h[e1][e2] : h[e1][e2];
        h_ll[i12] = hv;
        h_ll[(e2 * DL + e1) * lt + lg] = hv;
      }
    }
  }
}

template <typename T, bool ACCUM, bool CAM>
int launch_fused_obs_all(const void* jac, const void* g0, const void* d1,
                         const void* d2, const void* vc, const void* cpos,
                         void* h_ll, void* g_l, void* w, void* rows, int n,
                         int s, int k, int l, int l_total, int l_base, int n_r,
                         int n_rows, int dr_s, int dl, int e_start,
                         void* stream) {
  if (l == 0) return 0;
  constexpr int kThreads = 64;
  const int blocks = (l + kThreads - 1) / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* jac_t = static_cast<const T*>(jac);
  const T* g0_t = static_cast<const T*>(g0);
  const T* d1_t = static_cast<const T*>(d1);
  const T* d2_t = static_cast<const T*>(d2);
  const int* vc_t = static_cast<const int*>(vc);
  const int* cp_t = static_cast<const int*>(cpos);
  T* h_t = static_cast<T*>(h_ll);
  T* g_t = static_cast<T*>(g_l);
  T* w_t = static_cast<T*>(w);
  T* r_t = static_cast<T*>(rows);
  if (n == 2 && dr_s == 6 && dl == 3 && s == 9) {
    fused_obs_all_kernel<T, 2, 6, 3, ACCUM, CAM><<<blocks, kThreads, 0, st>>>(
        jac_t, g0_t, d1_t, d2_t, vc_t, cp_t, h_t, g_t, w_t, r_t, k, l, l_total,
        l_base, n_r, n_rows, e_start);
  } else if (n == 2 && dr_s == 9 && dl == 3 && s == 12) {
    fused_obs_all_kernel<T, 2, 9, 3, ACCUM, CAM><<<blocks, kThreads, 0, st>>>(
        jac_t, g0_t, d1_t, d2_t, vc_t, cp_t, h_t, g_t, w_t, r_t, k, l, l_total,
        l_base, n_r, n_rows, e_start);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fused_obs_all_f32(const void* jac, const void* g0, const void* d1,
                      const void* d2, const void* vc, const void* cpos,
                      void* h_ll, void* g_l, void* w, void* rows, int n, int s,
                      int k, int l, int n_r, int n_rows, int dr_s, int dl,
                      int e_start, void* stream) {
  return launch_fused_obs_all<float, false, true>(
      jac, g0, d1, d2, vc, cpos, h_ll, g_l, w, rows, n, s, k, l, l, 0, n_r,
      n_rows, dr_s, dl, e_start, stream);
}

int fused_obs_all_f64(const void* jac, const void* g0, const void* d1,
                      const void* d2, const void* vc, const void* cpos,
                      void* h_ll, void* g_l, void* w, void* rows, int n, int s,
                      int k, int l, int n_r, int n_rows, int dr_s, int dl,
                      int e_start, void* stream) {
  return launch_fused_obs_all<double, false, true>(
      jac, g0, d1, d2, vc, cpos, h_ll, g_l, w, rows, n, s, k, l, l, 0, n_r,
      n_rows, dr_s, dl, e_start, stream);
}

int fused_obs_all_into_f32(const void* jac, const void* g0, const void* d1,
                           const void* d2, const void* vc, const void* cpos,
                           void* h_ll, void* g_l, void* w, void* rows, int n,
                           int s, int k, int l, int l_total, int l_base,
                           int n_r, int n_rows, int dr_s, int dl, int e_start,
                           void* stream) {
  return launch_fused_obs_all<float, true, true>(
      jac, g0, d1, d2, vc, cpos, h_ll, g_l, w, rows, n, s, k, l, l_total,
      l_base, n_r, n_rows, dr_s, dl, e_start, stream);
}

int fused_obs_all_into_f64(const void* jac, const void* g0, const void* d1,
                           const void* d2, const void* vc, const void* cpos,
                           void* h_ll, void* g_l, void* w, void* rows, int n,
                           int s, int k, int l, int l_total, int l_base,
                           int n_r, int n_rows, int dr_s, int dl, int e_start,
                           void* stream) {
  return launch_fused_obs_all<double, true, true>(
      jac, g0, d1, d2, vc, cpos, h_ll, g_l, w, rows, n, s, k, l, l_total,
      l_base, n_r, n_rows, dr_s, dl, e_start, stream);
}

int fused_obs_leg_f32(const void* jac, const void* g0, const void* d1,
                      const void* d2, const void* vc, void* h_ll, void* g_l,
                      void* w, int n, int s, int k, int l, int n_r, int dr_s,
                      int dl, int e_start, void* stream) {
  return launch_fused_obs_all<float, false, false>(
      jac, g0, d1, d2, vc, nullptr, h_ll, g_l, w, nullptr, n, s, k, l, l, 0,
      n_r, 0, dr_s, dl, e_start, stream);
}

int fused_obs_leg_f64(const void* jac, const void* g0, const void* d1,
                      const void* d2, const void* vc, void* h_ll, void* g_l,
                      void* w, int n, int s, int k, int l, int n_r, int dr_s,
                      int dl, int e_start, void* stream) {
  return launch_fused_obs_all<double, false, false>(
      jac, g0, d1, d2, vc, nullptr, h_ll, g_l, w, nullptr, n, s, k, l, l, 0,
      n_r, 0, dr_s, dl, e_start, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
