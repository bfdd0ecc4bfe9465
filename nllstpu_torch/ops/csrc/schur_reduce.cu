// Kernels B3, B4 and B5: the Schur reductions of the direct solve, one
// structured body.
//
// B3 replaces the TPU kernel
// nllstpu/ops/pallas/schur_reduce.py:reduce_s_lm_damped (body
// _kernel_lm_damped -> _lm_reduce_body / _lm_reduce_body_panels), B4
// nllstpu/ops/pallas/schur_reduce.py:reduce_s_lm (body _kernel_lm) and B5
// nllstpu/ops/pallas/schur_reduce.py:reduce_s (body _kernel).  B3 and B4
// reduce the obs-major assemblies' W, B3 forming the damped inverses itself
// (float32, dl <= 3), B4 over inverses formed outside (float64, or dl > 3,
// up to kMaxDl = 16: dl <= 6 unrolled, 7..16 through one instance whose
// loops over dl run at run time);
// B5 reduces the generic assembly's W (the adaptive kernel's batch) over
// inverses formed outside.  B4 and B5 are the same instance (EXTERNAL).
// The TPU kernels' components-major W, bf16x3 products and landmark
// padding are not carried over; rhs is full precision, as there.
//
// Outputs: s_sum [wc, wc] = sum_l W_l^T (h_ll,l + lambda I)^-1 W_l
//          rhs   [wc]     = sum_l W_l^T (h_ll,l + lambda I)^-1 g_l,l
//          B3 only: h_inv [dl, dl, L], the damped inverses the
//          back-substitution needs.
//
// W [L, dl, wc] is nonzero only in each landmark's column blocks (an
// obs-major W's camera blocks; the generic W's camera blocks and its
// kernel block): 4-15 MB of blocks on the main paths against 41-149 MB of
// dense rows, and 44-90x less work than the dense product Y^T W.  The
// tables (schur_reduce.row_tables, built at compile time) give the blocks
// (first column, width <= kMaxWidth), every landmark's incidences
// (landmark, block), and for every block pair i <= j the landmarks holding
// both, as pairs of incidences ("links") in landmark order, cut into items
// of at most kLinkChunk.  Three launches:
//   1. incidence_kernel, kIncBlock incidences per block: one thread per
//      incidence brings its landmark's inverse to shared memory (B3: the
//      closed form of h_ll + lambda I in double, cast to float, written to
//      h_inv by the landmark's first incidence - a landmark without a
//      block keeps one incidence for that; lambda read from device memory
//      once per block, so that a CUDA graph that captured the launch takes
//      the lambda written before each replay; B4/B5: read); then the block's
//      threads copy the W_l[:, b] entries to shared memory and to a compact
//      incidence-major array wb, and form Y = H^-1 W_l[:, b] once per
//      (landmark, block) into another, yc (each block padded to 16 bytes),
//      consecutive threads writing consecutive entries;
//   2. reduce_links_kernel, one warp per item: the item's links staged in
//      shared memory; lane a of a group of w_i lanes owns row a of the
//      pair's block and adds, link after link, Y_l[:, a] . W_l[:, j]
//      (16-byte loads of the compact block, broadcast over the group; two
//      links' loads in flight before their products where both blocks
//      have the instance's unrolled width); the groups take interleaved
//      links and are added in group order; diagonal items also sum rhs in
//      double;
//   3. sum_links_kernel, one thread per entry of every block pair i <= j:
//      its items' partials in item order, written at (i, j) and at its
//      mirror (j, i) - on a diagonal block by the owner of the upper
//      entry - so every entry of s_sum inside the blocks has exactly one
//      writer, s_sum is symmetric bit for bit, and a pair without a
//      landmark writes zeros (no mirror pass; the caller zeroes the
//      outputs only where the blocks leave columns of W uncovered).
// No atomics: two launches give the same bits.  What bounds it on the
// H100: the links pass, most of the time, reads each link's Y rows and W
// block (~150 bytes in float32, ~290 in float64) from L2, about 2.9-3.6
// TB/s on the pinhole shapes: L2 traffic, not the FP32/FP64 rate (the
// structural work is 0.1-0.75 GFLOP, ~10 us at the CUDA-core rate) and not
// HBM (the compact arrays are 4-15 MB each and stay in L2).  The design
// answers with Y formed once, aligned vector loads of a block that a group
// of lanes shares, and one write of S; reusing Y_li across a camera row
// from shared memory is the next step.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxWidth = 16;  // widest column block
constexpr int kMaxDl = 16;     // widest landmark block of B4 and B5
constexpr int kUnrolledDl = 6;  // widest landmark block of an unrolled instance
constexpr int kSmemCap = 48 * 1024;  // shared memory of a block without an opt-in
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kIncThreads = 128;  // incidence_kernel
constexpr int kIncBlock = 32;     // incidences per incidence_kernel block
constexpr int kLinkWarps = 4;     // reduce_links_kernel
constexpr int kLinkChunk = 64;    // links per item (schur_reduce.LINK_CHUNK)

// The closed-form inverse of a symmetric DL x DL block, in double: the
// cofactor arithmetic of core/linearsolver.batched_inv_spd_cm (and of the
// JAX package).
template <int DL>
__device__ void closed_form_inverse(const double* h, double* out) {
  if constexpr (DL == 1) {
    out[0] = 1.0 / h[0];
  } else if constexpr (DL == 2) {
    const double a = h[0], b = h[1], c = h[2], e = h[3];
    const double inv_det = 1.0 / (a * e - b * c);
    out[0] = e * inv_det;
    out[1] = -b * inv_det;
    out[2] = -c * inv_det;
    out[3] = a * inv_det;
  } else {
    const double a = h[0], b = h[1], c = h[2];
    const double e = h[4], f = h[5], g = h[8];
    const double c00 = e * g - f * f;
    const double c01 = c * f - b * g;
    const double c02 = b * f - c * e;
    const double c11 = a * g - c * c;
    const double c12 = b * c - a * f;
    const double c22 = a * e - b * b;
    const double inv_det = 1.0 / (a * c00 + b * c01 + c * c02);
    out[0] = c00 * inv_det;
    out[1] = c01 * inv_det;
    out[2] = c02 * inv_det;
    out[3] = c01 * inv_det;
    out[4] = c11 * inv_det;
    out[5] = c12 * inv_det;
    out[6] = c02 * inv_det;
    out[7] = c12 * inv_det;
    out[8] = c22 * inv_det;
  }
}

// One block takes kIncBlock consecutive incidences.  EXTERNAL = false:
// B3, h_in holds h_ll, and the damped inverses are formed here;
// EXTERNAL = true: B4 and B5, h_in holds the inverses; lam and h_inv are
// unused (NULL).  B3's block reads lam (one double in device memory) once
// into shared memory.  First one thread per incidence brings its landmark's inverse to
// shared memory (B3: written to h_inv by the landmark's first incidence);
// then the threads copy the blocks' W entries, element by element, to
// shared memory and to wb; then form Y element by element: consecutive
// threads write consecutive entries of the compact arrays.  Each incidence
// has DL * mw slots; a block of width w_b uses its first DL * w_b, [d][c]
// in wb and ws, [c][e] in yc.  UNIFORM: every block is mw wide and block b
// starts at column b * mw (an obs-major W), so the block tables are not
// read.
template <typename T, int DL, bool EXTERNAL, bool UNIFORM>
__global__ void __launch_bounds__(kIncThreads) incidence_kernel(
    const T* __restrict__ w, const T* __restrict__ h_in, const double* __restrict__ lam,
    const int* __restrict__ lmk, const int* __restrict__ blk,
    const int* __restrict__ bcol, const int* __restrict__ bwidth, T* __restrict__ yc,
    T* __restrict__ wb, T* __restrict__ h_inv, int L, int wc, int mw, int bs, int n_inc) {
  __shared__ T hs[kIncBlock][DL * DL];
  __shared__ T ws[kIncBlock * DL * kMaxWidth];
  __shared__ double lam_s;
  const int s0 = blockIdx.x * kIncBlock;
  const int n = min(kIncBlock, n_inc - s0);
  const int t = threadIdx.x;
  if constexpr (!EXTERNAL) {
    if (t == 0) lam_s = *lam;
    __syncthreads();
  }
  if (t < n) {
    const int s = s0 + t;
    const int l = lmk[s];
    if constexpr (EXTERNAL) {
#pragma unroll
      for (int c = 0; c < DL * DL; ++c) hs[t][c] = h_in[static_cast<size_t>(c) * L + l];
    } else {
      double h[DL * DL], inv[DL * DL];
#pragma unroll
      for (int c = 0; c < DL * DL; ++c)
        h[c] = static_cast<double>(h_in[static_cast<size_t>(c) * L + l]);
#pragma unroll
      for (int d = 0; d < DL; ++d) h[d * DL + d] += lam_s;
      closed_form_inverse<DL>(h, inv);
      const bool first = s == 0 || lmk[s - 1] != l;
#pragma unroll
      for (int c = 0; c < DL * DL; ++c) {
        hs[t][c] = static_cast<T>(inv[c]);
        if (first) h_inv[static_cast<size_t>(c) * L + l] = hs[t][c];
      }
    }
  }
  // W_l[:, b] of each incidence, [d][c] (a landmark without a block: none).
  const int per = DL * mw;
  for (int q = t; q < n * per; q += kIncThreads) {
    const int sl = q / per;
    const int r = q - sl * per;
    const int s = s0 + sl;
    const int b = blk[s];
    if (b < 0) continue;
    const int width = UNIFORM ? mw : bwidth[b];
    if (r >= DL * width) continue;
    const int d = r / width;
    const int col = UNIFORM ? b * mw : bcol[b];
    const T v = w[(static_cast<size_t>(lmk[s]) * DL + d) * wc + col + (r - d * width)];
    ws[q] = v;
    wb[static_cast<size_t>(s) * bs + r] = v;
  }
  __syncthreads();
  // Y = H^-1 W_l[:, b], [c][e].
  for (int q = t; q < n * per; q += kIncThreads) {
    const int sl = q / per;
    const int b = blk[s0 + sl];
    if (b < 0) continue;
    const int width = UNIFORM ? mw : bwidth[b];
    const int r = q - sl * per;
    if (r >= DL * width) continue;
    const int c = r / DL;
    const int e = r - c * DL;
    T y = T(0);
#pragma unroll
    for (int d = 0; d < DL; ++d) y += hs[sl][e * DL + d] * ws[sl * per + d * width + c];
    yc[static_cast<size_t>(s0 + sl) * bs + r] = y;
  }
}

// N values of a compact block (16-byte aligned) in 16-byte loads.
template <int N>
__device__ __forceinline__ void load_block(const float* __restrict__ p, float (&out)[N]) {
  const float4* v = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int k = 0; k < (N + 3) / 4; ++k) {
    const float4 x = __ldg(v + k);
    if (4 * k + 0 < N) out[4 * k + 0] = x.x;
    if (4 * k + 1 < N) out[4 * k + 1] = x.y;
    if (4 * k + 2 < N) out[4 * k + 2] = x.z;
    if (4 * k + 3 < N) out[4 * k + 3] = x.w;
  }
}

template <int N>
__device__ __forceinline__ void load_block(const double* __restrict__ p, double (&out)[N]) {
  const double2* v = reinterpret_cast<const double2*>(p);
#pragma unroll
  for (int k = 0; k < (N + 1) / 2; ++k) {
    const double2 x = __ldg(v + k);
    if (2 * k + 0 < N) out[2 * k + 0] = x.x;
    if (2 * k + 1 < N) out[2 * k + 1] = x.y;
  }
}

// Lane a's row of one link's block, Y_l[:, a] . W_l[:, c] for every
// column c, added into acc in column order.
template <typename T, int DL, int NB>
__device__ __forceinline__ void add_block(const T (&ya)[DL], const T (&blk)[NB], int width,
                                          T* acc) {
#pragma unroll
  for (int c = 0; c < NB / DL; ++c) {
    if (c < width) {
      T t = T(0);
#pragma unroll
      for (int e = 0; e < DL; ++e) t += ya[e] * blk[e * width + c];
      acc[c] += t;
    }
  }
}

template <typename T, int DL>
__device__ __forceinline__ void add_rhs(const T (&ya)[DL], const T* __restrict__ g_l, int L,
                                        long long l, double& racc) {
#pragma unroll
  for (int e = 0; e < DL; ++e)
    racc += static_cast<double>(ya[e]) * static_cast<double>(g_l[e * static_cast<long long>(L) + l]);
}

// WID: the block width this instance is unrolled for (the cameras' 6 and
// 9 at dl = 3; every block is at most WID wide), or 0 for any width up to
// kMaxWidth.  UNIFORM (with WID > 0): every block is WID wide, and the
// block tables are not read.  The item's links are staged in shared memory
// first; on a pair whose two blocks are WID wide, each group then takes
// its links two at a time (both blocks' loads issued before either's
// products), added in link order; any other pair (the generic W's kernel
// block) one at a time.
template <typename T, int DL, int WID, bool UNIFORM>
__global__ void __launch_bounds__(kLinkWarps * 32) reduce_links_kernel(
    const T* __restrict__ yc, const T* __restrict__ wb, const T* __restrict__ g_l,
    const int* __restrict__ lmk, const int* __restrict__ bwidth,
    const int* __restrict__ items, const int* __restrict__ pairs,
    const int* __restrict__ links, T* __restrict__ part, double* __restrict__ rpart, int L,
    int mw, int bs, int n_items) {
  constexpr int MW = WID > 0 ? WID : kMaxWidth;
  __shared__ int2 ls[kLinkWarps][kLinkChunk];
  const int warp = threadIdx.x >> 5;
  const int it = blockIdx.x * kLinkWarps + warp;
  if (it >= n_items) return;
  const int lane = threadIdx.x & 31;
  const int pr = items[3 * it];
  const int p0 = items[3 * it + 1];
  const int n = items[3 * it + 2] - p0;
  const int bi = pairs[2 * pr], bj = pairs[2 * pr + 1];
  const int wi = UNIFORM ? WID : bwidth[bi];
  const int wj = UNIFORM ? WID : bwidth[bj];
  const bool diag = bi == bj;
  const int2* lk = reinterpret_cast<const int2*>(links) + p0;
  for (int k = lane; k < n; k += 32) ls[warp][k] = lk[k];
  __syncwarp();
  const int groups = 32 / wi;
  const int grp = lane / wi;
  const int a = lane - grp * wi;
  T acc[MW];
#pragma unroll
  for (int c = 0; c < MW; ++c) acc[c] = T(0);
  double racc = 0.0;
  if (grp < groups) {
    if (WID > 0 && (UNIFORM || (wi == WID && wj == WID))) {
      // Two links in flight: both blocks' loads issued before either's
      // products, which are added in link order.
      constexpr int NB = DL * (WID > 0 ? WID : 1);
      for (int k = grp; k < n; k += 2 * groups) {
        const bool two = k + groups < n;
        const int2 l0 = ls[warp][k];
        const int2 l1 = ls[warp][two ? k + groups : k];
        T y0[DL], y1[DL], b0[NB], b1[NB];
#pragma unroll
        for (int e = 0; e < DL; ++e) {
          y0[e] = yc[static_cast<size_t>(l0.x) * bs + a * DL + e];
          y1[e] = yc[static_cast<size_t>(l1.x) * bs + a * DL + e];
        }
        load_block<NB>(wb + static_cast<size_t>(l0.y) * bs, b0);
        load_block<NB>(wb + static_cast<size_t>(l1.y) * bs, b1);
        add_block<T, DL, NB>(y0, b0, WID, acc);
        if (two) add_block<T, DL, NB>(y1, b1, WID, acc);
        if (diag) {
          add_rhs<T, DL>(y0, g_l, L, lmk[l0.x], racc);
          if (two) add_rhs<T, DL>(y1, g_l, L, lmk[l1.x], racc);
        }
      }
    } else if constexpr (!UNIFORM) {
      for (int k = grp; k < n; k += groups) {
        const int2 l0 = ls[warp][k];
        T y0[DL], b0[DL * MW];
#pragma unroll
        for (int e = 0; e < DL; ++e) y0[e] = yc[static_cast<size_t>(l0.x) * bs + a * DL + e];
        const T* wp = wb + static_cast<size_t>(l0.y) * bs;
#pragma unroll
        for (int q = 0; q < DL * MW; ++q)
          if (q < DL * wj) b0[q] = wp[q];
        add_block<T, DL, DL * MW>(y0, b0, wj, acc);
        if (diag) add_rhs<T, DL>(y0, g_l, L, lmk[l0.x], racc);
      }
    }
  }
  // The groups' partials, added in group order into group 0.
  for (int g = 1; g < groups; ++g) {
    const int src = g * wi + a;
#pragma unroll
    for (int c = 0; c < MW; ++c) {
      if (c < wj) {
        const T v = __shfl_sync(kFullMask, acc[c], src & 31);
        if (grp == 0) acc[c] += v;
      }
    }
    const double r = __shfl_sync(kFullMask, racc, src & 31);
    if (grp == 0) racc += r;
  }
  if (grp == 0) {
    T* out = part + static_cast<long long>(it) * mw * mw + a * wj;
#pragma unroll
    for (int c = 0; c < MW; ++c)
      if (c < wj) out[c] = acc[c];
    if (diag) rpart[static_cast<long long>(it) * mw + a] = racc;
  }
}

// incidence_kernel's external instance for any dl up to kMaxDl (B4 and
// B5 past the unrolled dl <= kUnrolledDl): per_block incidences a block,
// as many as fit kSmemCap of dynamic shared memory (their inverses and W
// blocks), every loop over dl at run time.  The same entries as the
// unrolled instance, in the same order.
template <typename T, bool UNIFORM>
__global__ void __launch_bounds__(kIncThreads) incidence_any_kernel(
    const T* __restrict__ w, const T* __restrict__ h_in, const int* __restrict__ lmk,
    const int* __restrict__ blk, const int* __restrict__ bcol, const int* __restrict__ bwidth,
    T* __restrict__ yc, T* __restrict__ wb, int L, int dl, int wc, int mw, int bs, int n_inc,
    int per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dd = dl * dl;
  const int per = dl * mw;
  T* hs = reinterpret_cast<T*>(smem);  // [per_block][dl * dl]
  T* ws = hs + per_block * dd;         // [per_block][dl * mw]
  const int s0 = blockIdx.x * per_block;
  const int n = min(per_block, n_inc - s0);
  const int t = threadIdx.x;
  for (int q = t; q < n * dd; q += kIncThreads) {
    const int sl = q / dd;
    hs[q] = h_in[static_cast<size_t>(q - sl * dd) * L + lmk[s0 + sl]];
  }
  for (int q = t; q < n * per; q += kIncThreads) {
    const int sl = q / per;
    const int r = q - sl * per;
    const int s = s0 + sl;
    const int b = blk[s];
    if (b < 0) continue;
    const int width = UNIFORM ? mw : bwidth[b];
    if (r >= dl * width) continue;
    const int d = r / width;
    const int col = UNIFORM ? b * mw : bcol[b];
    const T v = w[(static_cast<size_t>(lmk[s]) * dl + d) * wc + col + (r - d * width)];
    ws[q] = v;
    wb[static_cast<size_t>(s) * bs + r] = v;
  }
  __syncthreads();
  for (int q = t; q < n * per; q += kIncThreads) {
    const int sl = q / per;
    const int b = blk[s0 + sl];
    if (b < 0) continue;
    const int width = UNIFORM ? mw : bwidth[b];
    const int r = q - sl * per;
    if (r >= dl * width) continue;
    const int c = r / dl;
    const int e = r - c * dl;
    T y = T(0);
    for (int d = 0; d < dl; ++d) y += hs[sl * dd + e * dl + d] * ws[sl * per + d * width + c];
    yc[static_cast<size_t>(s0 + sl) * bs + r] = y;
  }
}

// reduce_links_kernel for any dl up to kMaxDl and any block widths: lane
// a of a group holds Y_l[:, a] in registers (unrolled to kMaxDl, the rows
// past dl skipped) and reads each link's W block from the compact array,
// one link at a time; the groups' partials added in group order, as
// there.
template <typename T>
__global__ void __launch_bounds__(kLinkWarps * 32) reduce_links_any_kernel(
    const T* __restrict__ yc, const T* __restrict__ wb, const T* __restrict__ g_l,
    const int* __restrict__ lmk, const int* __restrict__ bwidth,
    const int* __restrict__ items, const int* __restrict__ pairs,
    const int* __restrict__ links, T* __restrict__ part, double* __restrict__ rpart, int L,
    int dl, int mw, int bs, int n_items) {
  __shared__ int2 ls[kLinkWarps][kLinkChunk];
  const int warp = threadIdx.x >> 5;
  const int it = blockIdx.x * kLinkWarps + warp;
  if (it >= n_items) return;
  const int lane = threadIdx.x & 31;
  const int pr = items[3 * it];
  const int p0 = items[3 * it + 1];
  const int n = items[3 * it + 2] - p0;
  const int bi = pairs[2 * pr], bj = pairs[2 * pr + 1];
  const int wi = bwidth[bi];
  const int wj = bwidth[bj];
  const bool diag = bi == bj;
  const int2* lk = reinterpret_cast<const int2*>(links) + p0;
  for (int k = lane; k < n; k += 32) ls[warp][k] = lk[k];
  __syncwarp();
  const int groups = 32 / wi;
  const int grp = lane / wi;
  const int a = lane - grp * wi;
  T acc[kMaxWidth];
#pragma unroll
  for (int c = 0; c < kMaxWidth; ++c) acc[c] = T(0);
  double racc = 0.0;
  if (grp < groups) {
    for (int k = grp; k < n; k += groups) {
      const int2 l0 = ls[warp][k];
      T y0[kMaxDl];
#pragma unroll
      for (int e = 0; e < kMaxDl; ++e)
        y0[e] = e < dl ? yc[static_cast<size_t>(l0.x) * bs + a * dl + e] : T(0);
      const T* wp = wb + static_cast<size_t>(l0.y) * bs;
#pragma unroll
      for (int c = 0; c < kMaxWidth; ++c) {
        if (c < wj) {
          T t = T(0);
#pragma unroll
          for (int e = 0; e < kMaxDl; ++e)
            if (e < dl) t += y0[e] * __ldg(wp + e * wj + c);
          acc[c] += t;
        }
      }
      if (diag) {
        const long long l = lmk[l0.x];
#pragma unroll
        for (int e = 0; e < kMaxDl; ++e)
          if (e < dl)
            racc += static_cast<double>(y0[e]) *
                    static_cast<double>(g_l[e * static_cast<long long>(L) + l]);
      }
    }
  }
  for (int g = 1; g < groups; ++g) {
    const int src = g * wi + a;
#pragma unroll
    for (int c = 0; c < kMaxWidth; ++c) {
      if (c < wj) {
        const T v = __shfl_sync(kFullMask, acc[c], src & 31);
        if (grp == 0) acc[c] += v;
      }
    }
    const double r = __shfl_sync(kFullMask, racc, src & 31);
    if (grp == 0) racc += r;
  }
  if (grp == 0) {
    T* out = part + static_cast<long long>(it) * mw * mw + a * wj;
#pragma unroll
    for (int c = 0; c < kMaxWidth; ++c)
      if (c < wj) out[c] = acc[c];
    if (diag) rpart[static_cast<long long>(it) * mw + a] = racc;
  }
}

// One thread per entry (a, c) of every block pair i <= j (mw x mw slots,
// the first w_i x w_j used): the pair's item partials in item order,
// written at (i, j) and (j, i); on a diagonal block only the owner of the
// upper entry writes (both places), and the row a = 0 also writes rhs from
// the items' double partials.  UNIFORM: as incidence_kernel's.
template <typename T, bool UNIFORM>
__global__ void sum_links_kernel(const T* __restrict__ part,
                                 const double* __restrict__ rpart,
                                 const int* __restrict__ pairs,
                                 const int* __restrict__ istarts,
                                 const int* __restrict__ bcol,
                                 const int* __restrict__ bwidth,
                                 T* __restrict__ s_sum, T* __restrict__ rhs, int wc,
                                 int mw, int n_pairs) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int m2 = mw * mw;
  const long long pr = idx / m2;
  if (pr >= n_pairs) return;
  const int e = static_cast<int>(idx - pr * m2);
  const int bi = pairs[2 * pr], bj = pairs[2 * pr + 1];
  const int wi = UNIFORM ? mw : bwidth[bi];
  const int wj = UNIFORM ? mw : bwidth[bj];
  if (e >= wi * wj) return;
  const int a = e / wj;
  const int c = e - a * wj;
  const int i0 = istarts[pr], i1 = istarts[pr + 1];
  if (bi == bj) {
    if (e < wi) {
      double racc = 0.0;
      for (int it = i0; it < i1; ++it) racc += rpart[static_cast<long long>(it) * mw + e];
      rhs[(UNIFORM ? bi * mw : bcol[bi]) + e] = static_cast<T>(racc);
    }
    if (a > c) return;
  }
  T acc = T(0);
  for (int it = i0; it < i1; ++it) acc += part[static_cast<long long>(it) * m2 + e];
  const long long r = (UNIFORM ? bi * mw : bcol[bi]) + a;
  const long long col = (UNIFORM ? bj * mw : bcol[bj]) + c;
  s_sum[r * wc + col] = acc;
  s_sum[col * wc + r] = acc;
}

template <typename T, bool EXTERNAL>
int launch_reduce_rows(const void* w, const void* h_in, const void* g_l, const void* lam,
                       const void* lmk, const void* blk, const void* bcol,
                       const void* bwidth, const void* pairs, const void* links,
                       const void* items, const void* istarts, void* yc, void* wb,
                       void* part, void* rpart, void* s_sum, void* rhs, void* h_inv, int l,
                       int dl, int wc, int mw, int bs, int n_inc, int n_items, int n_pairs,
                       int uniform, void* stream) {
  if (mw < 1 || mw > kMaxWidth || dl < 1 || dl > (EXTERNAL ? kMaxDl : 3) ||
      (!EXTERNAL && lam == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* w_t = static_cast<const T*>(w);
  const T* h_t = static_cast<const T*>(h_in);
  const T* g_t = static_cast<const T*>(g_l);
  const double* lam_t = static_cast<const double*>(lam);
  const int* lmk_t = static_cast<const int*>(lmk);
  const int* bc_t = static_cast<const int*>(bcol);
  const int* bw_t = static_cast<const int*>(bwidth);
  T* yc_t = static_cast<T*>(yc);
  T* wb_t = static_cast<T*>(wb);
  T* part_t = static_cast<T*>(part);
  double* rp_t = static_cast<double*>(rpart);
  const unsigned inc_blocks = static_cast<unsigned>((n_inc + kIncBlock - 1) / kIncBlock);
#define NLLSTPU_INC_U(D, U)                                                      \
  incidence_kernel<T, D, EXTERNAL, U><<<inc_blocks, kIncThreads, 0, st>>>(       \
      w_t, h_t, lam_t, lmk_t, static_cast<const int*>(blk), bc_t, bw_t, yc_t, wb_t, \
      static_cast<T*>(h_inv), l, wc, mw, bs, n_inc)
#define NLLSTPU_INC(D)            \
  if (uniform) {                  \
    NLLSTPU_INC_U(D, true);       \
  } else {                        \
    NLLSTPU_INC_U(D, false);      \
  }
  const bool any_dl = dl > kUnrolledDl;
  if (n_inc > 0 && any_dl) {
    if constexpr (EXTERNAL) {
      const int per_inc = (dl * dl + dl * mw) * static_cast<int>(sizeof(T));
      const int per_block = kSmemCap / per_inc < kIncBlock ? kSmemCap / per_inc : kIncBlock;
      const unsigned blocks = static_cast<unsigned>((n_inc + per_block - 1) / per_block);
      const size_t smem = static_cast<size_t>(per_block) * per_inc;
      if (uniform)
        incidence_any_kernel<T, true><<<blocks, kIncThreads, smem, st>>>(
            w_t, h_t, lmk_t, static_cast<const int*>(blk), bc_t, bw_t, yc_t, wb_t, l, dl, wc,
            mw, bs, n_inc, per_block);
      else
        incidence_any_kernel<T, false><<<blocks, kIncThreads, smem, st>>>(
            w_t, h_t, lmk_t, static_cast<const int*>(blk), bc_t, bw_t, yc_t, wb_t, l, dl, wc,
            mw, bs, n_inc, per_block);
    }
  } else if (n_inc > 0) {
    switch (dl) {
      case 1: NLLSTPU_INC(1); break;
      case 2: NLLSTPU_INC(2); break;
      case 3: NLLSTPU_INC(3); break;
      default:
        if constexpr (EXTERNAL) {
          if (dl == 4) { NLLSTPU_INC(4); break; }
          if (dl == 5) { NLLSTPU_INC(5); break; }
          if (dl == 6) { NLLSTPU_INC(6); break; }
        }
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef NLLSTPU_INC
#undef NLLSTPU_INC_U
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* it_t = static_cast<const int*>(items);
  const int* pr_t = static_cast<const int*>(pairs);
  const int* ln_t = static_cast<const int*>(links);
  const unsigned link_blocks = static_cast<unsigned>((n_items + kLinkWarps - 1) / kLinkWarps);
#define NLLSTPU_LINKS(D, WID, U)                                                 \
  reduce_links_kernel<T, D, WID, U><<<link_blocks, kLinkWarps * 32, 0, st>>>(   \
      yc_t, wb_t, g_t, lmk_t, bw_t, it_t, pr_t, ln_t, part_t, rp_t, l, mw, bs, n_items)
  if (n_items > 0 && any_dl) {
    reduce_links_any_kernel<T><<<link_blocks, kLinkWarps * 32, 0, st>>>(
        yc_t, wb_t, g_t, lmk_t, bw_t, it_t, pr_t, ln_t, part_t, rp_t, l, dl, mw, bs, n_items);
  } else if (n_items > 0) {
    if (dl == 3 && mw == 6 && uniform) {
      NLLSTPU_LINKS(3, 6, true);
    } else if (dl == 3 && mw == 6) {
      NLLSTPU_LINKS(3, 6, false);
    } else if (dl == 3 && mw == 9 && uniform) {
      NLLSTPU_LINKS(3, 9, true);
    } else if (dl == 3 && mw == 9) {
      NLLSTPU_LINKS(3, 9, false);
    } else {
      switch (dl) {
        case 1: NLLSTPU_LINKS(1, 0, false); break;
        case 2: NLLSTPU_LINKS(2, 0, false); break;
        case 3: NLLSTPU_LINKS(3, 0, false); break;
        case 4: NLLSTPU_LINKS(4, 0, false); break;
        case 5: NLLSTPU_LINKS(5, 0, false); break;
        case 6: NLLSTPU_LINKS(6, 0, false); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    }
  }
#undef NLLSTPU_LINKS
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(n_pairs) * mw * mw;
  if (n > 0) {
    const int threads = 256;
    const unsigned grid = static_cast<unsigned>((n + threads - 1) / threads);
    const int* is_t = static_cast<const int*>(istarts);
    if (uniform)
      sum_links_kernel<T, true><<<grid, threads, 0, st>>>(
          part_t, rp_t, pr_t, is_t, bc_t, bw_t, static_cast<T*>(s_sum), static_cast<T*>(rhs),
          wc, mw, n_pairs);
    else
      sum_links_kernel<T, false><<<grid, threads, 0, st>>>(
          part_t, rp_t, pr_t, is_t, bc_t, bw_t, static_cast<T*>(s_sum), static_cast<T*>(rhs),
          wc, mw, n_pairs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define NLLSTPU_ROWS_EXPORT(NAME, T, EXTERNAL)                                   \
  int NAME(const void* w, const void* h_in, const void* g_l, const void* lam,    \
           const void* lmk, const void* blk, const void* bcol, const void* bwidth, \
           const void* pairs, const void* links, const void* items,              \
           const void* istarts, void* yc, void* wb, void* part, void* rpart,     \
           void* s_sum, void* rhs, void* h_inv, int l, int dl, int wc, int mw,   \
           int bs, int n_inc, int n_items, int n_pairs, int uniform,             \
           void* stream) {                                                       \
    return launch_reduce_rows<T, EXTERNAL>(                                      \
        w, h_in, g_l, lam, lmk, blk, bcol, bwidth, pairs, links, items, istarts, \
        yc, wb, part, rpart, s_sum, rhs, h_inv, l, dl, wc, mw, bs, n_inc,        \
        n_items, n_pairs, uniform, stream);                                      \
  }
// B3 in float32 only: a float64 solve takes damped_inverse, then B4.  B4
// and B5 are the external instance.
NLLSTPU_ROWS_EXPORT(reduce_s_damped_f32, float, false)
NLLSTPU_ROWS_EXPORT(reduce_s_external_f32, float, true)
NLLSTPU_ROWS_EXPORT(reduce_s_external_f64, double, true)
#undef NLLSTPU_ROWS_EXPORT

}  // extern "C"
