// Kernels B3, B4 and B5: the Schur reductions of the direct solve, one
// structured body.
//
// B3 replaces the TPU kernel
// nllstpu/ops/pallas/schur_reduce.py:reduce_s_lm_damped (body
// _kernel_lm_damped -> _lm_reduce_body / _lm_reduce_body_panels), B4
// nllstpu/ops/pallas/schur_reduce.py:reduce_s_lm (body _kernel_lm) and B5
// nllstpu/ops/pallas/schur_reduce.py:reduce_s (body _kernel).  B3 and B4
// reduce the obs-major assemblies' W, B3 forming the damped inverses itself
// (float32, dl <= 3), B4 over inverses formed outside (float64, or dl > 3:
// dl <= 6 unrolled, any wider dl through the tiled instance below, as the
// TPU kernels take any dl);
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
//
// Past dl = kUnrolledDl the tiled instance (incidence_tiled_kernel,
// reduce_links_tiled_kernel) takes both passes, with nothing sized by dl:
// Y from register tiles over panels of H^-1 rows staged in shared memory
// (H^-1 landmark-major there), and per item the stream of its links' rows
// through a ring of shared-memory stages that TMA bulk copies fill
// (cp.async.bulk, completion on an mbarrier per stage), each lane owning a
// register tile of the pair's block.  What bounds it is the same as
// above, grown with dl: every link brings its two blocks, dl (w_i + w_j)
// values, from L2 (627 MB a call on the float32 dl = 18 NRSfM system,
// where the structural bound reads each block once); the tiles keep the
// shared-memory reads at TR + TC per TR * TC FMAs, the ring keeps
// kTiledWarps stages in flight per block.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxWidth = 16;  // widest column block
constexpr int kUnrolledDl = 6;  // widest landmark block of an unrolled instance
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kIncThreads = 128;  // incidence_kernel
constexpr int kIncBlock = 32;     // incidences per incidence_kernel block
constexpr int kLinkWarps = 4;     // reduce_links_kernel
constexpr int kLinkChunk = 64;    // links per item (schur_reduce.LINK_CHUNK)
// The tiled instance (dl > kUnrolledDl):
constexpr int kTiledIncThreads = 128;  // incidence_tiled_kernel
constexpr int kTiledIncChunk = 32;     // columns of H^-1 a staged chunk
constexpr int kTiledWarps = 8;         // reduce_links_tiled_kernel
constexpr int kStages = 2;             // ring depth of its warps
constexpr int kStageBytes = 4 * 1024;  // one warp's stage
// The links pass's per-warp tables: links (int2) and landmarks (int).
constexpr int kLinkTables = kTiledWarps * kLinkChunk * (8 + 4);
// Bytes past the last ring that a tile over a block's edge may read.
constexpr int kRingSlack = 32;

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
// 9 at dl 1-3; every block is at most WID wide), or 0 for any width up to
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

// The tiled instance of B4 and B5 for any dl past kUnrolledDl: no array
// is sized by dl, so any dl runs.  Its Y is laid out [e][c] (dl x w_b
// rows, each block padded to 16 bytes), so that a run of rows e of one
// block is contiguous in yc and in wb alike.
//
// incidence_tiled_kernel: a block takes ib consecutive incidences
// (blockIdx.x) and one panel of pe rows e of their Y (blockIdx.y).  Its
// threads own TI x TI tiles (rows e, columns c) of the incidences' Y (TI =
// 3, or 4 for blocks wider than 9), ib * ceil(pe / TI) * ceil(mw / TI) <=
// kTiledIncThreads of them.  For each chunk of dc columns d, the block
// stages in shared memory the panel of H^-1 rows of each of its landmarks
// (H^-1 landmark-major, [L][dl][dl], so that a row's chunk is one
// coalesced read) and each incidence's W rows d (the panel-0 blocks also
// write them to wb); then each thread adds the chunk's products into its
// tile in d order, 2 TI shared loads for TI^2 FMAs.  A tile past the panel
// or the block reads on into the staged neighbours or the slack, and its
// extra sums are not written.  Dynamic shared memory, opted in past 48
// KB; ib, pe and dc are chosen at launch (launch_incidence_tiled).
template <typename T, int TI>
__global__ void __launch_bounds__(kTiledIncThreads) incidence_tiled_kernel(
    const T* __restrict__ w, const T* __restrict__ h_in, const int* __restrict__ lmk,
    const int* __restrict__ blk, const int* __restrict__ bcol, const int* __restrict__ bwidth,
    T* __restrict__ yc, T* __restrict__ wb, int L, int dl, int wc, int mw, int bs, int n_inc,
    int ib, int pe, int dc) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* hs = reinterpret_cast<T*>(smem);  // [ib][pe][dc]: each landmark's H^-1 panel chunk
  T* ws = hs + ib * pe * dc;           // [ib][dc][mw]: each incidence's W rows d
  const int s0 = blockIdx.x * ib;
  const int n = min(ib, n_inc - s0);
  const int lf = lmk[s0];
  const int nlm = lmk[s0 + n - 1] - lf + 1;  // landmarks of the block, consecutive
  const int e0 = blockIdx.y * pe;
  const int ne = min(pe, dl - e0);
  const int t = threadIdx.x;
  // This thread's tile: incidence sl, rows ea.., columns ca.. .
  const int ct = (mw + TI - 1) / TI;
  const int tpi = (pe + TI - 1) / TI * ct;
  const int sl = t / tpi;
  const int tile = t - sl * tpi;
  const int ea = tile / ct * TI;
  const int ca = (tile % ct) * TI;
  int b = -1, width = 0, lm = 0;
  if (sl < n) {
    b = blk[s0 + sl];
    lm = lmk[s0 + sl] - lf;
    if (b >= 0) width = bwidth[b];
  }
  const bool mine = b >= 0 && ea < ne && ca < width;
  T acc[TI][TI];
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TI; ++j) acc[i][j] = T(0);
  for (int d0 = 0; d0 < dl; d0 += dc) {
    const int nd = min(dc, dl - d0);
    if (d0 > 0) __syncthreads();  // the previous chunk's products are done
    for (int q = t; q < nlm * ne * nd; q += kTiledIncThreads) {
      const int d = q % nd;
      const int r = q / nd;
      const int e = r % ne;
      const int j = r / ne;
      hs[(j * pe + e) * dc + d] = h_in[(static_cast<size_t>(lf + j) * dl + e0 + e) * dl + d0 + d];
    }
    for (int q = t; q < n * mw; q += kTiledIncThreads) {
      const int sq = q / mw;
      const int c = q - sq * mw;
      const int s = s0 + sq;
      const int bq = blk[s];
      if (bq < 0) continue;
      const int wq = bwidth[bq];
      if (c >= wq) continue;
      const T* src = w + (static_cast<size_t>(lmk[s]) * dl + d0) * wc + bcol[bq] + c;
      T* dst = ws + sq * dc * mw + c;
      T* out = wb + static_cast<size_t>(s) * bs + d0 * wq + c;
      for (int d = 0; d < nd; ++d) {
        const T v = src[static_cast<size_t>(d) * wc];
        dst[d * mw] = v;
        if (blockIdx.y == 0) out[d * wq] = v;
      }
    }
    __syncthreads();
    if (mine) {
      const T* hp = hs + (lm * pe + ea) * dc;
      const T* wp = ws + sl * dc * mw + ca;
      for (int d = 0; d < nd; ++d, wp += mw) {
        T hv[TI], wv[TI];
#pragma unroll
        for (int i = 0; i < TI; ++i) hv[i] = hp[i * dc + d];
#pragma unroll
        for (int j = 0; j < TI; ++j) wv[j] = wp[j];
#pragma unroll
        for (int i = 0; i < TI; ++i)
#pragma unroll
          for (int j = 0; j < TI; ++j) acc[i][j] += hv[i] * wv[j];
      }
    }
  }
  if (!mine) return;
  T* out = yc + static_cast<size_t>(s0 + sl) * bs + (e0 + ea) * width + ca;
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TI; ++j)
      if (ea + i < ne && ca + j < width) out[i * width + j] = acc[i][j];
}

__device__ __forceinline__ int round_up(int x, int v) { return (x + v - 1) / v * v; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One item of reduce_links_tiled_kernel, by one warp: the item's K stream
// (its links in order, each link's rows e = 0..dl-1: row e of Y_i [e][a]
// and of W_j [e][c]) passes through a ring of kStages buffers of
// stage_elems values, each filled by TMA bulk copies (one per block, lanes
// in turn) that complete on the stage's mbarrier (lane 0 arms it with the
// stage's bytes; its phase parity counts the stage's turns): a stage holds
// whole links when one fits (both blocks padded to 16 bytes), else a chunk
// of ec rows of one link (ec a multiple of 4, so every copy stays 16-byte
// aligned).  The
// pair's w_i x w_j block is cut into tiles of TR x TC entries; lane
// (group, tile) owns a tile's sums in registers and the groups take the
// stream's rows in turn (row r to group r mod G), each adding its rows in
// order; then group 0 adds the others' tiles in group order.  A diagonal
// item also sums rhs_a += Y[e][a] g_l[e] in double, by the lanes of tile
// column 0.  The same order on every launch: the same bits.
template <typename T, int TR, int TC>
__device__ __forceinline__ void links_item(
    const T* __restrict__ yc, const T* __restrict__ wb, const T* __restrict__ g_l,
    const int2* ls, const int* lm, int n, int wi, int wj, bool diag, int dl, int L, int bs,
    T* ring, int stage_elems, T* __restrict__ out, double* __restrict__ rout, int lane,
    unsigned long long* bars) {
  constexpr int V = 16 / sizeof(T);
  const int tj_n = (wj + TC - 1) / TC;
  const int tiles = (wi + TR - 1) / TR * tj_n;
  const int groups = 32 / tiles;
  const int grp = lane / tiles;
  const int tile = lane - grp * tiles;
  const int ti = tile / tj_n;
  const int tj = tile - ti * tj_n;
  // The tile's first entry.  A tile past the block's edge reads on into
  // the next row (or the ring's slack): its extra sums are never written.
  const int a0 = ti * TR, c0 = tj * TC;
  // The stage plan: whole links (lps a stage) or chunks of ec rows.
  const int y_full = round_up(dl * wi, V), w_full = round_up(dl * wj, V);
  const bool whole = y_full + w_full <= stage_elems;
  const int lps = whole ? min(n, stage_elems / (y_full + w_full)) : 1;
  const int ec = whole ? dl : (stage_elems / (wi + wj)) / 4 * 4;
  const int nch = (dl + ec - 1) / ec;
  const int n_stages = whole ? (n + lps - 1) / lps : n * nch;
  auto plan = [&](int k, int& q0, int& nl, int& e0, int& ne) {
    if (whole) {
      q0 = k * lps;
      nl = min(lps, n - q0);
      e0 = 0;
      ne = dl;
    } else {
      q0 = k / nch;
      nl = 1;
      e0 = (k - q0 * nch) * ec;
      ne = min(ec, dl - e0);
    }
  };
  auto fetch = [&](int k) {
    int q0, nl, e0, ne;
    plan(k, q0, nl, e0, ne);
    const int yst = round_up(ne * wi, V), wst = round_up(ne * wj, V);
    T* ybuf = ring + (k % kStages) * stage_elems;
    T* wbuf = ybuf + nl * yst;
    unsigned long long* bar = bars + k % kStages;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (lane == 0) mbar_expect_tx(bar, static_cast<unsigned>(nl * (yst + wst) * sizeof(T)));
    for (int x = lane; x < 2 * nl; x += 32) {
      const int q = x >> 1;
      const int2 lk = ls[q0 + q];
      if (x & 1)
        bulk_copy(wbuf + q * wst, wb + static_cast<size_t>(lk.y) * bs + e0 * wj,
                  static_cast<unsigned>(wst * sizeof(T)), bar);
      else
        bulk_copy(ybuf + q * yst, yc + static_cast<size_t>(lk.x) * bs + e0 * wi,
                  static_cast<unsigned>(yst * sizeof(T)), bar);
    }
  };
  T acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = T(0);
  double racc[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) racc[i] = 0.0;
  const bool rhs = diag && tj == 0;
  for (int k = 0; k < kStages - 1 && k < n_stages; ++k) fetch(k);
  int next = grp;  // this group's next row of the item's stream
  int base = 0;    // the stream's rows before stage k
  for (int k = 0; k < n_stages; ++k) {
    if (k + kStages - 1 < n_stages) fetch(k + kStages - 1);
    mbar_wait(bars + k % kStages, static_cast<unsigned>((k / kStages) & 1));
    __syncwarp();
    int q0, nl, e0, ne;
    plan(k, q0, nl, e0, ne);
    const int yst = round_up(ne * wi, V), wst = round_up(ne * wj, V);
    const T* ybuf = ring + (k % kStages) * stage_elems;
    const T* wbuf = ybuf + nl * yst;
    if (grp < groups) {
      // This group's rows of the stage: the item's stream rows r, r + G,
      // ... (consecutive groups on consecutive rows, so that their loads
      // fall in distinct banks), row e of link q at yr and wr.
      int local = next - base;
      int q = local / ne, e = local - q * ne;
      const T* yr = ybuf + q * yst + e * wi + a0;
      const T* wr = wbuf + q * wst + e * wj + c0;
      // The row after (q, e) of this group: (q2, e2) at yr2, wr2.
      auto step = [&](int q1, int e1, const T* y1, const T* w1, int& q2, int& e2,
                      const T*& y2, const T*& w2) {
        q2 = q1;
        e2 = e1 + groups;
        if (e2 < ne) {
          y2 = y1 + groups * wi;
          w2 = w1 + groups * wj;
        } else {
          do e2 -= ne, ++q2; while (e2 >= ne);
          y2 = ybuf + q2 * yst + e2 * wi + a0;
          w2 = wbuf + q2 * wst + e2 * wj + c0;
        }
      };
      auto add = [&](const T (&yv)[TR], const T (&wv)[TC], int qr, int er) {
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < TC; ++j) acc[i][j] += yv[i] * wv[j];
        if (rhs) {
          const double g =
              static_cast<double>(g_l[static_cast<long long>(e0 + er) * L + lm[q0 + qr]]);
#pragma unroll
          for (int i = 0; i < TR; ++i) racc[i] += static_cast<double>(yv[i]) * g;
        }
      };
      // Two rows a turn, both rows' loads before their products.
      while (q < nl) {
        int q2, e2;
        const T *yr2, *wr2;
        step(q, e, yr, wr, q2, e2, yr2, wr2);
        const bool two = q2 < nl;
        T yv[TR], wv[TC], yv2[TR], wv2[TC];
#pragma unroll
        for (int i = 0; i < TR; ++i) yv[i] = yr[i];
#pragma unroll
        for (int j = 0; j < TC; ++j) wv[j] = wr[j];
        if (two) {
#pragma unroll
          for (int i = 0; i < TR; ++i) yv2[i] = yr2[i];
#pragma unroll
          for (int j = 0; j < TC; ++j) wv2[j] = wr2[j];
        }
        add(yv, wv, q, e);
        if (!two) {
          q = q2, e = e2;
          break;
        }
        add(yv2, wv2, q2, e2);
        step(q2, e2, yr2, wr2, q, e, yr, wr);
      }
      next = base + q * ne + e;
    }
    base += nl * ne;
    __syncwarp();  // the stage is read before the ring refills it
  }
  // The groups' tiles, added in group order into group 0.
  for (int g = 1; g < groups; ++g) {
    const int src = g * tiles + tile;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const T v = __shfl_sync(kFullMask, acc[i][j], src & 31);
        if (grp == 0) acc[i][j] += v;
      }
      const double r = __shfl_sync(kFullMask, racc[i], src & 31);
      if (grp == 0) racc[i] += r;
    }
  }
  if (grp != 0) return;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int a = a0 + i;
    if (a >= wi) continue;
#pragma unroll
    for (int j = 0; j < TC; ++j)
      if (c0 + j < wj) out[a * wj + c0 + j] = acc[i][j];
    if (rhs) rout[a] = racc[i];
  }
}

// reduce_links_kernel's tiled instance for any dl past kUnrolledDl and
// any block widths: one warp per item (links_item), the item's links (and,
// on a diagonal pair, their landmarks) staged in shared memory first; the
// tile (TR, TC) of a pair is the smallest tiling of its w_i x w_j block
// by at most 4 x 4 (so 2 to 32 groups of lanes).
template <typename T>
__global__ void __launch_bounds__(kTiledWarps * 32) reduce_links_tiled_kernel(
    const T* __restrict__ yc, const T* __restrict__ wb, const T* __restrict__ g_l,
    const int* __restrict__ lmk, const int* __restrict__ bwidth,
    const int* __restrict__ items, const int* __restrict__ pairs,
    const int* __restrict__ links, T* __restrict__ part, double* __restrict__ rpart, int L,
    int dl, int mw, int bs, int n_items) {
  constexpr int stage_elems = kStageBytes / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int2* ls = reinterpret_cast<int2*>(smem) + warp * kLinkChunk;
  int* lm = reinterpret_cast<int*>(smem + kTiledWarps * kLinkChunk * sizeof(int2)) +
            warp * kLinkChunk;
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(smem + kLinkTables) + warp * kStages;
  T* ring = reinterpret_cast<T*>(smem + kLinkTables + kTiledWarps * kStages * 8) +
            warp * kStages * stage_elems;
  const int it = blockIdx.x * kTiledWarps + warp;
  if (it >= n_items) return;
  const int pr = items[3 * it];
  const int p0 = items[3 * it + 1];
  const int n = items[3 * it + 2] - p0;
  const int bi = pairs[2 * pr], bj = pairs[2 * pr + 1];
  const int wi = bwidth[bi];
  const int wj = bwidth[bj];
  const bool diag = bi == bj;
  const int2* lk = reinterpret_cast<const int2*>(links) + p0;
  for (int k = lane; k < n; k += 32) {
    const int2 v = lk[k];
    ls[k] = v;
    if (diag) lm[k] = lmk[v.x];
  }
  if (lane < kStages) mbar_init(bars + lane, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncwarp();
  const int tr = (wi + (wi + 3) / 4 - 1) / ((wi + 3) / 4);
  const int tc = (wj + (wj + 3) / 4 - 1) / ((wj + 3) / 4);
  T* out = part + static_cast<long long>(it) * mw * mw;
  double* rout = rpart + static_cast<long long>(it) * mw;
#define NLLSTPU_ITEM(R, C)                                                                   \
  case (R - 1) * 4 + C - 1:                                                                  \
    links_item<T, R, C>(yc, wb, g_l, ls, lm, n, wi, wj, diag, dl, L, bs, ring, stage_elems, \
                        out, rout, lane, bars);                                              \
    break;
  switch ((tr - 1) * 4 + tc - 1) {
    NLLSTPU_ITEM(1, 1) NLLSTPU_ITEM(1, 2) NLLSTPU_ITEM(1, 3) NLLSTPU_ITEM(1, 4)
    NLLSTPU_ITEM(2, 1) NLLSTPU_ITEM(2, 2) NLLSTPU_ITEM(2, 3) NLLSTPU_ITEM(2, 4)
    NLLSTPU_ITEM(3, 1) NLLSTPU_ITEM(3, 2) NLLSTPU_ITEM(3, 3) NLLSTPU_ITEM(3, 4)
    NLLSTPU_ITEM(4, 1) NLLSTPU_ITEM(4, 2) NLLSTPU_ITEM(4, 3) NLLSTPU_ITEM(4, 4)
    default: break;
  }
#undef NLLSTPU_ITEM
}

// incidence_tiled_kernel's launch: pe rows a panel (all dl, or as many
// TI-row tiles as one incidence's tiles fit the block's threads), ib
// incidences a block (as many as their tiles fit the threads), dc =
// min(dl, kTiledIncChunk).  Each tiled kernel's dynamic shared memory is
// opted in on every launch (the call is cheap and permitted under stream
// capture).
template <typename T, int TI>
int launch_incidence_tiled(const T* w, const T* h_in, const int* lmk, const int* blk,
                           const int* bcol, const int* bwidth, T* yc, T* wb, int L, int dl,
                           int wc, int mw, int bs, int n_inc, cudaStream_t st) {
  const int ct = (mw + TI - 1) / TI;
  int pe = TI * (kTiledIncThreads / ct);
  pe = pe > dl ? dl : pe;
  const int tpi = (pe + TI - 1) / TI * ct;
  const int ib = kTiledIncThreads / tpi;
  const int dc = dl < kTiledIncChunk ? dl : kTiledIncChunk;
  // + the rows and columns a tile past the edge reads
  const size_t smem = sizeof(T) * (static_cast<size_t>(ib) * pe * dc +
                                   static_cast<size_t>(ib) * dc * mw + TI * (dc + mw));
  cudaError_t err = cudaFuncSetAttribute(incidence_tiled_kernel<T, TI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n_inc + ib - 1) / ib),
                  static_cast<unsigned>((dl + pe - 1) / pe));
  incidence_tiled_kernel<T, TI><<<grid, kTiledIncThreads, smem, st>>>(
      w, h_in, lmk, blk, bcol, bwidth, yc, wb, L, dl, wc, mw, bs, n_inc, ib, pe, dc);
  return static_cast<int>(cudaGetLastError());
}

// Launch the tiled instance's two passes: the incidence pass (TI = 4 on
// blocks wider than 9), then the links pass with its ring.
template <typename T>
int launch_tiled(const T* w, const T* h_in, const T* g_l, const int* lmk, const int* blk,
                 const int* bcol, const int* bwidth, const int* items, const int* pairs,
                 const int* links, T* yc, T* wb, T* part, double* rpart, int L, int dl, int wc,
                 int mw, int bs, int n_inc, int n_items, cudaStream_t st) {
  if (n_inc > 0) {
    const int code = mw > 9 ? launch_incidence_tiled<T, 4>(w, h_in, lmk, blk, bcol, bwidth, yc,
                                                          wb, L, dl, wc, mw, bs, n_inc, st)
                            : launch_incidence_tiled<T, 3>(w, h_in, lmk, blk, bcol, bwidth, yc,
                                                          wb, L, dl, wc, mw, bs, n_inc, st);
    if (code != 0) return code;
  }
  if (n_items > 0) {
    const size_t smem =
        kLinkTables + kTiledWarps * kStages * 8 +
        static_cast<size_t>(kTiledWarps) * kStages * kStageBytes + kRingSlack;
    cudaError_t err = cudaFuncSetAttribute(
        reduce_links_tiled_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned blocks = static_cast<unsigned>((n_items + kTiledWarps - 1) / kTiledWarps);
    reduce_links_tiled_kernel<T><<<blocks, kTiledWarps * 32, smem, st>>>(
        yc, wb, g_l, lmk, bwidth, items, pairs, links, part, rpart, L, dl, mw, bs, n_items);
  }
  return static_cast<int>(cudaGetLastError());
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
  if (mw < 1 || mw > kMaxWidth || dl < 1 || (!EXTERNAL && (dl > 3 || lam == nullptr)))
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
  const int* it_t = static_cast<const int*>(items);
  const int* pr_t = static_cast<const int*>(pairs);
  const int* ln_t = static_cast<const int*>(links);
  const bool tiled = dl > kUnrolledDl;
  if (tiled) {
    if constexpr (EXTERNAL) {
      const int code = launch_tiled<T>(w_t, h_t, g_t, lmk_t, static_cast<const int*>(blk), bc_t,
                                       bw_t, it_t, pr_t, ln_t, yc_t, wb_t, part_t, rp_t, l, dl,
                                       wc, mw, bs, n_inc, n_items, st);
      if (code != 0) return code;
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
  const unsigned link_blocks = static_cast<unsigned>((n_items + kLinkWarps - 1) / kLinkWarps);
#define NLLSTPU_LINKS(D, WID, U)                                                 \
  reduce_links_kernel<T, D, WID, U><<<link_blocks, kLinkWarps * 32, 0, st>>>(   \
      yc_t, wb_t, g_t, lmk_t, bw_t, it_t, pr_t, ln_t, part_t, rp_t, l, mw, bs, n_items)
  // dl 1-3 at the cameras' widths 6 and 9 (uniform W first): the unrolled
  // two-link instances; any other width or dl 4-6, the any-width instance.
#define NLLSTPU_LINKS_DL(D)                    \
  if (mw == 6 && uniform) {                    \
    NLLSTPU_LINKS(D, 6, true);                 \
  } else if (mw == 6) {                        \
    NLLSTPU_LINKS(D, 6, false);                \
  } else if (mw == 9 && uniform) {             \
    NLLSTPU_LINKS(D, 9, true);                 \
  } else if (mw == 9) {                        \
    NLLSTPU_LINKS(D, 9, false);                \
  } else {                                     \
    NLLSTPU_LINKS(D, 0, false);                \
  }
  if (n_items > 0 && !tiled) {
    switch (dl) {
      case 1: NLLSTPU_LINKS_DL(1); break;
      case 2: NLLSTPU_LINKS_DL(2); break;
      case 3: NLLSTPU_LINKS_DL(3); break;
      case 4: NLLSTPU_LINKS(4, 0, false); break;
      case 5: NLLSTPU_LINKS(5, 0, false); break;
      case 6: NLLSTPU_LINKS(6, 0, false); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef NLLSTPU_LINKS_DL
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
