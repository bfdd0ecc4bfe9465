// Kernels B3, B4 and B5: the Schur reductions of the direct solve.
//
// B3 replaces the TPU kernel
// nllstpu/ops/pallas/schur_reduce.py:reduce_s_lm_damped (body
// _kernel_lm_damped -> _lm_reduce_body / _lm_reduce_body_panels).  One
// kernel covers every reduced width: the TPU split into a narrow and a
// column-panel body existed only to fit its scoped VMEM.
// B4 replaces nllstpu/ops/pallas/schur_reduce.py:reduce_s_lm (body
// _kernel_lm), the reduction over external inverses for the TPU's p-major
// W of the obs-major assemblies.  Here that W is landmark-major, and B4 is
// B3's dense body in its external mode, for dl = 1 .. 6: the float64
// direct solve runs through it.
// B5 replaces nllstpu/ops/pallas/schur_reduce.py:reduce_s (body _kernel),
// the same reduction over the generic assembly's W (the adaptive kernel's
// batch).  Its W is sparse by structure - a landmark's row holds its
// cameras' column blocks and the kernel block, ~100 of 1155 columns on the
// adaptive BAL path - so B5 reduces over the structure instead (below).
// The TPU kernels' components-major W, bf16x3 products and landmark
// padding are not carried over; rhs is full precision, as there.
//
// Inputs:  w [L, dl, wc] (landmark-major coupling, standard basis),
//          B3: h_ll [dl, dl, L] (undamped) and lambda;
//          B4: h_inv [dl, dl, L] (the damped inverses, formed outside);
//          B5: h_inv [L, dl, dl] and g_l [L, dl] (landmark-major) and the
//          structure tables;
//          g_l [dl, L].
// Outputs: s_sum [wc, wc] = sum_l W_l^T (h_ll,l + lambda I)^-1 W_l
//          rhs   [wc]     = sum_l W_l^T (h_ll,l + lambda I)^-1 g_l,l
//          B3 only: h_inv [dl, dl, L], the damped inverses the
//          back-substitution needs.
//
// B3 and B4, the dense body.  With Y = H^-1 W (never stored), s_sum =
// Y^T W is a [wc, K] x [K, wc] product over K = L * dl, both operands
// being the row-major [K, wc] matrices Y and W.  The contraction is this
// kernel's own tiled FP32 (or FP64) FMA loop:
//   * a block owns one 64 x 64 tile of s_sum and one slice of the
//     landmarks (split-K); only tiles on or above the diagonal run, and
//     the lower triangle is mirrored when the partials are reduced;
//   * per step it stages LB landmarks (8, or 24 / dl past dl = 3, so the
//     staged depth never passes 24 rows): their closed-form damped
//     inverses (the cofactor arithmetic of the JAX package) or the
//     external ones, the W rows at the tile's row and column ranges, and
//     Y for the row range, in shared memory; 256 threads then each
//     accumulate a 4 x 4 register tile;
//   * each step adds into a partial register tile that folds into the
//     tile's sum every 8 steps (two-level sums: no float32 chain runs
//     past 8 * 24 products plus one add per 64 landmarks);
//   * diagonal tiles also accumulate rhs, its products in double, and
//     the (0, 0) tiles write h_inv once per landmark;
//   * a second small kernel sums the split-K partials in a fixed order,
//     so the result is deterministic.
// Bound: the FMA rate out of shared memory - about 2 FMAs per shared load
// with this register tile.  wgmma, TMA and 3xTF32 are later work.
//
// B5, the structured body.  W's columns fall into blocks (a camera's
// dr_s columns, the kernel's k columns); the tables list, for every block
// pair i <= j that some landmark holds both of, those landmarks in
// ascending order, cut into items of at most a few dozen landmarks.  One
// warp takes one item: lane a of a group of w_i lanes owns row a of the
// output block, forms Y_l[:, a] = H_l^-1 W_l[:, i_a] from the landmark's
// inverse, and adds Y_l[:, a] . W_l[:, j_b] for every column b of block j;
// 32 / w_i groups take interleaved landmarks of the item, and the groups'
// partials are added in group order.  Diagonal items (i = j) also sum rhs
// in double.  A second kernel adds each pair's item partials in item order
// and writes the block and, below the diagonal, its mirror; every other
// entry of s_sum stays zero.  No atomics: two launches give the same bits.
// It reads only W's nonzero blocks (about 10 MB on the adaptive path, which
// stays in L2 across the pairs that reread them) and does the structural
// work, ~40x less than the dense product.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBM = 64;       // s_sum tile edge
constexpr int kTile = 16;     // threads per tile edge (16 x 16 = 256)
constexpr int kT = kBM / kTile;  // register tile edge (4)
constexpr int kFlush = 8;     // steps summed in a partial tile


template <typename T, int DL>
__device__ void damped_inverse(const T* __restrict__ h_ll, int L, int l,
                               T lam, T* out) {
  auto h = [&](int a, int b) { return h_ll[static_cast<size_t>(a * DL + b) * L + l]; };
  if constexpr (DL == 1) {
    out[0] = T(1) / (h(0, 0) + lam);
  } else if constexpr (DL == 2) {
    const T a = h(0, 0) + lam, b = h(0, 1), e = h(1, 1) + lam;
    const T inv_det = T(1) / (a * e - b * b);
    out[0] = e * inv_det;
    out[1] = -b * inv_det;
    out[2] = -b * inv_det;
    out[3] = a * inv_det;
  } else {
    const T a = h(0, 0) + lam, b = h(0, 1), c = h(0, 2);
    const T e = h(1, 1) + lam, f = h(1, 2), g = h(2, 2) + lam;
    const T c00 = e * g - f * f;
    const T c01 = c * f - b * g;
    const T c02 = b * f - c * e;
    const T c11 = a * g - c * c;
    const T c12 = b * c - a * f;
    const T c22 = a * e - b * b;
    const T inv_det = T(1) / (a * c00 + b * c01 + c * c02);
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

// EXTERNAL = false: B3, h_in holds h_ll and the damped inverses are formed
// here (and written to h_inv by the (0, 0) tiles).  EXTERNAL = true: B4,
// h_in holds the inverses; lam and h_inv are unused.
template <typename T, int DL, bool EXTERNAL>
__global__ void __launch_bounds__(kTile * kTile) reduce_s_kernel(
    const T* __restrict__ w, const T* __restrict__ h_in,
    const T* __restrict__ g_l, T lam, T* __restrict__ s_part,
    T* __restrict__ r_part, T* __restrict__ h_inv, int L, int wc,
    int l_per_split) {
  const int bj = blockIdx.x;  // column tile
  const int bi = blockIdx.y;  // row tile
  if (bi > bj) return;        // lower tiles are mirrored afterwards
  // Landmarks staged per step: 8 up to dl = 3, then as many as keep the
  // staged depth dl * LB at most 24 (the shared memory of the dl = 3 body).
  constexpr int kLB = DL <= 3 ? 8 : 24 / DL;
  constexpr int BK = DL * kLB;
  __shared__ T hs[kLB][DL * DL];
  __shared__ T gs[BK];
  __shared__ T wr[BK][kBM];  // W at the tile's rows
  __shared__ T ws[BK][kBM];  // W at the tile's columns (off-diagonal tiles)
  __shared__ T ys[BK][kBM];  // Y = H^-1 W at the tile's rows
  const int split = blockIdx.z;
  const int l_begin = split * l_per_split;
  const int l_end = min(L, l_begin + l_per_split);
  const int r0 = bi * kBM;
  const int s0 = bj * kBM;
  const bool diag = bi == bj;
  const bool write_hinv = !EXTERNAL && bi == 0 && bj == 0;
  const int tid = threadIdx.x;
  const int tx = tid % kTile;
  const int ty = tid / kTile;
  // Two-level sums: a step's products add into part, which folds into acc
  // every kFlush steps, so no float32 chain runs past a few hundred terms.
  T acc[kT][kT], part[kT][kT];
#pragma unroll
  for (int i = 0; i < kT; ++i)
#pragma unroll
    for (int j = 0; j < kT; ++j) acc[i][j] = part[i][j] = T(0);
  double racc = 0.0;  // rhs: exact products, a double chain
  int step = 0;
  const T (*bmat)[kBM] = diag ? wr : ws;

  for (int lc = l_begin; lc < l_end; lc += kLB) {
    if constexpr (EXTERNAL) {
      for (int i = tid; i < kLB * DL * DL; i += kTile * kTile) {
        const int l = lc + i / (DL * DL);
        const int c = i % (DL * DL);
        hs[i / (DL * DL)][c] = l < l_end ? h_in[static_cast<size_t>(c) * L + l] : T(0);
      }
    } else if (tid < kLB) {
      const int l = lc + tid;
      T inv[DL * DL];
      if (l < l_end) {
        damped_inverse<T, DL>(h_in, L, l, lam, inv);
        if (write_hinv) {
#pragma unroll
          for (int c = 0; c < DL * DL; ++c)
            h_inv[static_cast<size_t>(c) * L + l] = inv[c];
        }
      } else {
#pragma unroll
        for (int c = 0; c < DL * DL; ++c) inv[c] = T(0);
      }
#pragma unroll
      for (int c = 0; c < DL * DL; ++c) hs[tid][c] = inv[c];
    }
    if (tid < BK) {
      const int l = lc + tid / DL;
      gs[tid] = l < l_end ? g_l[static_cast<size_t>(tid % DL) * L + l] : T(0);
    }
    for (int i = tid; i < BK * kBM; i += kTile * kTile) {
      const int kk = i / kBM;
      const int c = i % kBM;
      const int l = lc + kk / DL;
      const bool l_ok = l < l_end;
      const size_t row = (static_cast<size_t>(l) * DL + kk % DL) * wc;
      wr[kk][c] = (l_ok && r0 + c < wc) ? w[row + r0 + c] : T(0);
      if (!diag) ws[kk][c] = (l_ok && s0 + c < wc) ? w[row + s0 + c] : T(0);
    }
    __syncthreads();
    for (int i = tid; i < BK * kBM; i += kTile * kTile) {
      const int kk = i / kBM;
      const int c = i % kBM;
      const int ll = kk / DL;
      const int e = kk % DL;
      T y = T(0);
#pragma unroll
      for (int d = 0; d < DL; ++d) y += hs[ll][e * DL + d] * wr[ll * DL + d][c];
      ys[kk][c] = y;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      T a[kT], b[kT];
#pragma unroll
      for (int i = 0; i < kT; ++i) a[i] = ys[kk][ty + kTile * i];
#pragma unroll
      for (int j = 0; j < kT; ++j) b[j] = bmat[kk][tx + kTile * j];
#pragma unroll
      for (int i = 0; i < kT; ++i)
#pragma unroll
        for (int j = 0; j < kT; ++j) part[i][j] += a[i] * b[j];
    }
    if (diag && tid < kBM) {
      for (int kk = 0; kk < BK; ++kk)
        racc += static_cast<double>(ys[kk][tid]) * static_cast<double>(gs[kk]);
    }
    if (++step == kFlush) {
      step = 0;
#pragma unroll
      for (int i = 0; i < kT; ++i)
#pragma unroll
        for (int j = 0; j < kT; ++j) {
          acc[i][j] += part[i][j];
          part[i][j] = T(0);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kT; ++i)
#pragma unroll
    for (int j = 0; j < kT; ++j) acc[i][j] += part[i][j];

  T* sp = s_part + static_cast<size_t>(split) * wc * wc;
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const int r = r0 + ty + kTile * i;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const int s = s0 + tx + kTile * j;
      if (r < wc && s < wc) sp[static_cast<size_t>(r) * wc + s] = acc[i][j];
    }
  }
  if (diag && tid < kBM && r0 + tid < wc)
    r_part[static_cast<size_t>(split) * wc + r0 + tid] = static_cast<T>(racc);
}

// s_sum[r, s] = sum over splits of the partial tile that holds (r, s) or,
// below the diagonal tiles, its mirror (s, r); rhs likewise.
template <typename T>
__global__ void sum_partials_kernel(const T* __restrict__ s_part,
                                    const T* __restrict__ r_part,
                                    T* __restrict__ s_sum, T* __restrict__ rhs,
                                    int wc, int splits) {
  const size_t n = static_cast<size_t>(wc) * wc;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int r = static_cast<int>(idx / wc);
  const int s = static_cast<int>(idx % wc);
  const size_t src = (r / kBM <= s / kBM) ? idx : static_cast<size_t>(s) * wc + r;
  T acc = T(0);
  for (int sp = 0; sp < splits; ++sp) acc += s_part[sp * n + src];
  s_sum[idx] = acc;
  if (idx < static_cast<size_t>(wc)) {
    T racc = T(0);
    for (int sp = 0; sp < splits; ++sp) racc += r_part[static_cast<size_t>(sp) * wc + idx];
    rhs[idx] = racc;
  }
}

template <typename T, int DL, bool EXTERNAL>
void launch_body(dim3 grid, cudaStream_t st, const T* w, const T* h_in,
                 const T* g_l, T lam, T* s_part, T* r_part, T* h_inv, int l,
                 int wc, int l_per_split) {
  reduce_s_kernel<T, DL, EXTERNAL><<<grid, kTile * kTile, 0, st>>>(
      w, h_in, g_l, lam, s_part, r_part, h_inv, l, wc, l_per_split);
}

template <typename T, bool EXTERNAL>
int launch_reduce_s(const void* w, const void* h_in, const void* g_l,
                    double lam, void* s_part, void* r_part, void* s_sum,
                    void* rhs, void* h_inv, int l, int dl, int wc, int splits,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = (wc + kBM - 1) / kBM;
  const int l_per_split = (l + splits - 1) / splits;
  const dim3 grid(nt, nt, splits);
  const T* w_t = static_cast<const T*>(w);
  const T* h_t = static_cast<const T*>(h_in);
  const T* g_t = static_cast<const T*>(g_l);
  T* sp_t = static_cast<T*>(s_part);
  T* rp_t = static_cast<T*>(r_part);
  T* hi_t = static_cast<T*>(h_inv);
  const T lam_t = static_cast<T>(lam);
#define NLLSTPU_BODY(D)                                                      \
  launch_body<T, D, EXTERNAL>(grid, st, w_t, h_t, g_t, lam_t, sp_t, rp_t, \
                              hi_t, l, wc, l_per_split)
  // B3 forms the closed-form inverse, dl <= 3; B4 takes dl up to 6.
  switch (dl) {
    case 1: NLLSTPU_BODY(1); break;
    case 2: NLLSTPU_BODY(2); break;
    case 3: NLLSTPU_BODY(3); break;
    default:
      if constexpr (EXTERNAL) {
        if (dl == 4) { NLLSTPU_BODY(4); break; }
        if (dl == 5) { NLLSTPU_BODY(5); break; }
        if (dl == 6) { NLLSTPU_BODY(6); break; }
      }
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NLLSTPU_BODY
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(wc) * wc;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  sum_partials_kernel<T><<<blocks, threads, 0, st>>>(
      sp_t, rp_t, static_cast<T*>(s_sum), static_cast<T*>(rhs), wc, splits);
  return static_cast<int>(cudaGetLastError());
}

// B5: one warp per item of the pair tables (see the header).
constexpr int kPairWarps = 4;
constexpr int kMaxWidth = 16;  // widest column block
constexpr unsigned kFullMask = 0xffffffffu;

template <typename T, int DL>
__global__ void __launch_bounds__(kPairWarps * 32) reduce_pairs_kernel(
    const T* __restrict__ w, const T* __restrict__ h_inv,
    const T* __restrict__ g_l, const int* __restrict__ items,
    const int* __restrict__ pairs, const int* __restrict__ bcol,
    const int* __restrict__ bwidth, const int* __restrict__ lmk,
    T* __restrict__ part, double* __restrict__ rpart, int wc, int n_items,
    int mw) {
  const int it = blockIdx.x * kPairWarps + (threadIdx.x >> 5);
  if (it >= n_items) return;
  const int lane = threadIdx.x & 31;
  const int pr = items[3 * it];
  const int p0 = items[3 * it + 1];
  const int p1 = items[3 * it + 2];
  const int bi = pairs[2 * pr];
  const int bj = pairs[2 * pr + 1];
  const int ci = bcol[bi], wi = bwidth[bi];
  const int cj = bcol[bj], wj = bwidth[bj];
  const bool diag = bi == bj;
  const int groups = 32 / wi;
  const int grp = lane / wi;
  const int a = lane - grp * wi;
  T acc[kMaxWidth];
#pragma unroll
  for (int b = 0; b < kMaxWidth; ++b) acc[b] = T(0);
  double racc = 0.0;
  if (grp < groups) {
    for (int p = p0 + grp; p < p1; p += groups) {
      const long long l = lmk[p];
      const T* wl = w + l * DL * wc;
      const T* hl = h_inv + l * DL * DL;
      T wa[DL], y[DL];
#pragma unroll
      for (int d = 0; d < DL; ++d) wa[d] = wl[d * static_cast<long long>(wc) + ci + a];
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        T t = T(0);
#pragma unroll
        for (int d = 0; d < DL; ++d) t += hl[e * DL + d] * wa[d];
        y[e] = t;
      }
#pragma unroll
      for (int b = 0; b < kMaxWidth; ++b) {
        if (b < wj) {
          T t = T(0);
#pragma unroll
          for (int e = 0; e < DL; ++e) t += y[e] * wl[e * static_cast<long long>(wc) + cj + b];
          acc[b] += t;
        }
      }
      if (diag) {
#pragma unroll
        for (int e = 0; e < DL; ++e)
          racc += static_cast<double>(y[e]) * static_cast<double>(g_l[l * DL + e]);
      }
    }
  }
  // The groups' partials, added in group order into group 0.
  for (int g = 1; g < groups; ++g) {
    const int src = g * wi + a;
#pragma unroll
    for (int b = 0; b < kMaxWidth; ++b) {
      if (b < wj) {
        const T v = __shfl_sync(kFullMask, acc[b], src & 31);
        if (grp == 0) acc[b] += v;
      }
    }
    const double r = __shfl_sync(kFullMask, racc, src & 31);
    if (grp == 0) racc += r;
  }
  if (grp == 0) {
    T* out = part + static_cast<long long>(it) * mw * mw + a * wj;
#pragma unroll
    for (int b = 0; b < kMaxWidth; ++b)
      if (b < wj) out[b] = acc[b];
    if (diag) rpart[static_cast<long long>(it) * mw + a] = racc;
  }
}

// Each pair's block: its items' partials in item order, written at (i, j)
// and mirrored at (j, i); rhs from the diagonal pairs, in double.
template <typename T>
__global__ void sum_pairs_kernel(const T* __restrict__ part,
                                 const double* __restrict__ rpart,
                                 const int* __restrict__ pairs,
                                 const int* __restrict__ istarts,
                                 const int* __restrict__ bcol,
                                 const int* __restrict__ bwidth,
                                 T* __restrict__ s_sum, T* __restrict__ rhs,
                                 int wc, int n_pairs, int mw) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int mw2 = mw * mw;
  const long long pr = idx / mw2;
  if (pr >= n_pairs) return;
  const int e = static_cast<int>(idx - pr * mw2);
  const int bi = pairs[2 * pr], bj = pairs[2 * pr + 1];
  const int wi = bwidth[bi], wj = bwidth[bj];
  if (e >= wi * wj) return;
  const int a = e / wj, b = e % wj;
  const long long r = bcol[bi] + a, c = bcol[bj] + b;
  const int i0 = istarts[pr], i1 = istarts[pr + 1];
  T acc = T(0);
  for (int it = i0; it < i1; ++it) acc += part[static_cast<long long>(it) * mw2 + e];
  s_sum[r * wc + c] = acc;
  if (bi != bj) s_sum[c * wc + r] = acc;
  if (bi == bj && e < wi) {
    double racc = 0.0;
    for (int it = i0; it < i1; ++it) racc += rpart[static_cast<long long>(it) * mw + e];
    rhs[bcol[bi] + e] = static_cast<T>(racc);
  }
}

template <typename T>
int launch_reduce_pairs(const void* w, const void* h_inv, const void* g_l,
                        const void* items, const void* pairs, const void* bcol,
                        const void* bwidth, const void* lmk,
                        const void* istarts, void* part, void* rpart,
                        void* s_sum, void* rhs, int dl, int wc, int n_items,
                        int n_pairs, int mw, void* stream) {
  if (mw > kMaxWidth || mw < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* w_t = static_cast<const T*>(w);
  const T* h_t = static_cast<const T*>(h_inv);
  const T* g_t = static_cast<const T*>(g_l);
  const int* it_t = static_cast<const int*>(items);
  const int* pr_t = static_cast<const int*>(pairs);
  const int* bc_t = static_cast<const int*>(bcol);
  const int* bw_t = static_cast<const int*>(bwidth);
  const int* lm_t = static_cast<const int*>(lmk);
  T* part_t = static_cast<T*>(part);
  double* rp_t = static_cast<double*>(rpart);
  const int blocks = (n_items + kPairWarps - 1) / kPairWarps;
#define NLLSTPU_PAIRS(D)                                                     \
  reduce_pairs_kernel<T, D><<<blocks, kPairWarps * 32, 0, st>>>(            \
      w_t, h_t, g_t, it_t, pr_t, bc_t, bw_t, lm_t, part_t, rp_t, wc, n_items, mw)
  switch (dl) {
    case 1: NLLSTPU_PAIRS(1); break;
    case 2: NLLSTPU_PAIRS(2); break;
    case 3: NLLSTPU_PAIRS(3); break;
    case 4: NLLSTPU_PAIRS(4); break;
    case 5: NLLSTPU_PAIRS(5); break;
    case 6: NLLSTPU_PAIRS(6); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NLLSTPU_PAIRS
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(n_pairs) * mw * mw;
  const int threads = 256;
  sum_pairs_kernel<T><<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0, st>>>(
      part_t, rp_t, pr_t, static_cast<const int*>(istarts), bc_t, bw_t,
      static_cast<T*>(s_sum), static_cast<T*>(rhs), wc, n_pairs, mw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int reduce_s_damped_f32(const void* w, const void* h_ll, const void* g_l,
                        double lam, void* s_part, void* r_part, void* s_sum,
                        void* rhs, void* h_inv, int l, int dl, int wc,
                        int splits, void* stream) {
  return launch_reduce_s<float, false>(w, h_ll, g_l, lam, s_part, r_part,
                                       s_sum, rhs, h_inv, l, dl, wc, splits,
                                       stream);
}

int reduce_s_damped_f64(const void* w, const void* h_ll, const void* g_l,
                        double lam, void* s_part, void* r_part, void* s_sum,
                        void* rhs, void* h_inv, int l, int dl, int wc,
                        int splits, void* stream) {
  return launch_reduce_s<double, false>(w, h_ll, g_l, lam, s_part, r_part,
                                        s_sum, rhs, h_inv, l, dl, wc, splits,
                                        stream);
}

int reduce_s_lm_f32(const void* w, const void* h_inv, const void* g_l,
                    void* s_part, void* r_part, void* s_sum, void* rhs, int l,
                    int dl, int wc, int splits, void* stream) {
  return launch_reduce_s<float, true>(w, h_inv, g_l, 0.0, s_part, r_part,
                                      s_sum, rhs, nullptr, l, dl, wc, splits,
                                      stream);
}

int reduce_s_lm_f64(const void* w, const void* h_inv, const void* g_l,
                    void* s_part, void* r_part, void* s_sum, void* rhs, int l,
                    int dl, int wc, int splits, void* stream) {
  return launch_reduce_s<double, true>(w, h_inv, g_l, 0.0, s_part, r_part,
                                       s_sum, rhs, nullptr, l, dl, wc, splits,
                                       stream);
}

#define NLLSTPU_PAIRS_EXPORT(NAME, T)                                          \
  int NAME(const void* w, const void* h_inv, const void* g_l,                  \
           const void* items, const void* pairs, const void* bcol,             \
           const void* bwidth, const void* lmk, const void* istarts,           \
           void* part, void* rpart, void* s_sum, void* rhs, int dl, int wc,    \
           int n_items, int n_pairs, int mw, void* stream) {                   \
    return launch_reduce_pairs<T>(w, h_inv, g_l, items, pairs, bcol, bwidth,   \
                                  lmk, istarts, part, rpart, s_sum, rhs, dl,   \
                                  wc, n_items, n_pairs, mw, stream);           \
  }
NLLSTPU_PAIRS_EXPORT(reduce_s_pairs_f32, float)
NLLSTPU_PAIRS_EXPORT(reduce_s_pairs_f64, double)
#undef NLLSTPU_PAIRS_EXPORT

}  // extern "C"
