// Kernels B1, B2 and B8: Schur-system assembly in one pass over the
// obs-major Jacobian of a bundle-adjustment batch.
//
// B1 replaces the TPU kernel nllstpu/ops/pallas/fused_obs.py:
// fused_obs_all_pm (body _kernel_all) and takes a uniform layout: one
// bucket covering every landmark, K slots each.  B2 replaces
// fused_obs_all_pm_into (body _kernel_all_accum), which the TPU launches
// once per degree bucket of a skewed layout; here ONE launch covers the
// whole batch: a compile-time list gives each landmark its real slots,
// the chunk bucket's and its class bucket's together, so no two work
// items of the launch touch one landmark.  B2 adds h_ll and g_l into
// full-size buffers.  B8 replaces fused_obs_leg_pm (body _kernel): B1 with
// the camera side compiled out (CAM = false), for the dual-sorted route,
// whose camera-major leg sums a_rr and b_r over camera runs in plain
// PyTorch.  None of the three uses atomics, so each gives the same bits
// on every launch.  The TPU kernel's tile-aligned left shift,
// input/output aliasing and NRp padding have no counterpart here.
//
// Same math, not the same layout: the TPU kernels keep
// W p-major and landmark-minor because of Mosaic's tiling; here W is stored
// in the standard basis, landmark-major [L, dl, n_r*dr_s].
//
// Inputs (element offset o of a slot, og in g0; o indexes every input
// but g0):
//   jac  [n, S, .]  residual Jacobian, S = dr_s + dl tangent columns, at
//                   o + ni*jsn + row*jss
//   g0   [S, .]     unweighted gradient J^T r, at og + row*gss
//   d1, d2          rho' * mask and 2 * rho'' * mask (pre-doubled)
//   vc   int32      camera column; n_r (the dustbin) for pad slots and
//                   fixed cameras
//   cpos int32      (B1/B2) the slot's row in the camera-sorted order of
//                   the batch's non-dustbin slots, -1 for a dustbin slot
// B1/B8 (UNIFORM): slot k of landmark l of a [K, L] tile sits at o = k*sk
// + l*sl and og = k*gk + l*gl, the strides of the caller's tensors
// (K-major from the tests, landmark-major views of the batch on the main
// path).  B2 (TABLE): landmark l owns slots starts[l] .. starts[l+1]-1 of
// `slots`, each the batch column o of one real observation (og = o*gk),
// or ~o when the slot's camera already appeared earlier in the
// landmark's list.
// Outputs:
//   h_ll [dl, dl, L_total]  sum rho' Je^T Je + 2 rho'' g0e g0e^T (B2: added)
//   g_l  [dl, L_total]      sum rho' g0e (B2: added)
//   w    [L_total, dl, n_r*dr_s]  each (landmark, camera) block written
//                   once with the sum of its slots' rho' Jr^T Je + 2 rho''
//                   g0r g0e^T; B1/B8 write the rest of W as zeros, B2's
//                   caller zeroes W
//   rows [n_rows, npairs + dr_s]  (B1/B2) row cpos of each non-dustbin
//                   slot: its a_rr upper triangle (entry idx(p, q), p <=
//                   q) then its b_r, written once
//
// Design: slots in parallel.  A warp takes 32 / G landmarks and gives
// each a group of G lanes (G the power of two at or above its slot count,
// at most 32; B2's work list groups landmarks of one G, B1/B8 take G from
// K); a lane takes slots j, j + G, ... of its landmark, keeping h_ll and
// g_l terms in registers, and the group sums them by a fixed xor
// butterfly.  The W block (dl x dr_s) and the camera row of each slot go
// through shared memory and are written slot by slot with neighbouring
// columns on neighbouring lanes, so lane i always writes entry i of a
// block: a slot whose camera repeats one of an earlier slot adds to the
// block after that slot stored it (the same lane, in program order), and
// every other slot stores.  B2 takes the repeats from its table; B1/B8
// find them in the warp (__match_any_sync) when the tile's K fits one
// group, and otherwise add every slot into the W rows the warp zeroed
// first.  The camera side
// (a_rr, b_r) is shared by many landmarks: each slot writes its row of
// `rows`, and kernel B6 (segment_sum.cu) sums the camera runs, every
// addition in a fixed order, as the TPU kernel adds its per-tile
// contributions in grid order.
//
// Shapes: the JAX kernels take any (n residual rows, dr_s, dl).  Two
// instances are unrolled for the hot shapes, (2, 6, 3) and (2, 9, 3); one
// more takes any shape within n <= 4, dr_s <= 16, dl <= 6, its loops
// unrolled to those caps with the entries past the shape skipped, so that
// its register arrays keep constant indices (what does not fit spills: the
// same values, slower).  One instance rather than one per shape compiled
// at first use: the library stays one build of fixed sources, and no new
// shape compiles anything inside a timed run or a graph capture.  The
// staged rows take dynamic shared memory sized to the shape, with as many
// warps a block as fit 48 KB (one warp of float64 at dr_s = 16).  The host
// sends a batch outside the caps to the generic route at compile time
// (fused_obs.kernel_takes).
//
// Bound: device-memory traffic (the Jacobian read once, W's touched
// blocks and the camera rows written once).  Slots of a dustbin camera
// (fixed camera or pad) still add to h_ll and g_l, whose weights are
// masked by the caller, but never to W or the camera side.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// The any-shape instance's caps (fused_obs.kernel_takes on the host).
constexpr int kMaxN = 4;
constexpr int kMaxDr = 16;
constexpr int kMaxDl = 6;
// Static shared memory a block may take without an opt-in attribute.
constexpr int kSmemCap = 48 * 1024;

// Warps per block of the two unrolled instances: the shared staging is
// 32 rows of up to 55 values per warp, about 28 KB a block in either float
// type.  The any-shape instance takes at most as many, fewer where its
// rows are wider (staging_warps).
template <typename T>
__host__ __device__ constexpr int warps_per_block() {
  return sizeof(T) == 8 ? 2 : 4;
}

// Values per staged row (odd: lanes writing their own rows hit distinct
// banks): a slot's W block, or its camera row where that is wider.
__host__ __device__ constexpr int staging_row(int dr, int dl, bool cam) {
  return ((cam && dr * (dr + 3) / 2 > dl * dr) ? dr * (dr + 3) / 2 : dl * dr) | 1;
}

// Dynamic shared memory of one warp: its 32 destinations, repeat marks
// and staged rows.
template <typename T>
__host__ __device__ constexpr int staging_bytes(int row) {
  return 32 * (static_cast<int>(sizeof(long long)) + static_cast<int>(sizeof(int)) +
               row * static_cast<int>(sizeof(T)));
}

template <typename T>
struct AsmArgs {
  const T* jac;
  const T* g0;
  const T* d1;
  const T* d2;
  const int* vc;
  const int* cpos;
  const int* slots;   // TABLE
  const int* starts;  // TABLE: [L_total + 1]
  const int* work;    // TABLE: [n_work, 3] (first landmark, landmarks, log2 G)
  T* h_ll;
  T* g_l;
  T* w;
  T* rows;
  long long jsn, jss, gss;  // strides of jac's n and S axes, g0's S axis
  long long sk, sl;         // UNIFORM: slot and landmark strides of the tile
  long long gk, gl;         // g0's slot and landmark strides (TABLE: gk only)
  int K, L, lg2;            // UNIFORM: slots per landmark, landmarks, log2 G
  int n_work;               // TABLE
  int L_total, n_r, n_rows, e_start;
  int n, dr, dl;            // residual rows, camera and landmark dof
};

// EXACT: the instance is unrolled for (N, DR, DL) itself.  Otherwise
// (N, DR, DL) are the caps kMaxN, kMaxDr, kMaxDl and the shape is read
// from the arguments: every loop still runs to its cap, unrolled, with the
// entries past the shape skipped, so the register arrays keep constant
// indices (the compiler spills what does not fit; the values are the
// exact instance's, only slower).
template <typename T, int N, int DR, int DL, bool EXACT, bool ACCUM, bool CAM, bool TABLE>
__global__ void __launch_bounds__(warps_per_block<T>() * 32)
    assemble_kernel(const AsmArgs<T> a) {
  constexpr int NH = DL * (DL + 1) / 2;
  const int n = EXACT ? N : a.n;
  const int dr = EXACT ? DR : a.dr;
  const int dl = EXACT ? DL : a.dl;
  const int np = dr * (dr + 1) / 2;
  const int nab = np + dr;
  const int nw = dl * dr;
  const int buf_row = staging_row(dr, dl, CAM);
  const int warps = blockDim.x >> 5;
  extern __shared__ __align__(16) unsigned char smem[];
  // Per warp: dst (W: block offset; camera: row; -1 none), rep (W: the
  // slot repeats a camera), then 32 staged rows.
  long long* dst_all = reinterpret_cast<long long*>(smem);
  int* rep_all = reinterpret_cast<int*>(dst_all + warps * 32);
  T* buf_all = reinterpret_cast<T*>(rep_all + warps * 32);
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  long long* dst = dst_all + wib * 32;
  int* rep = rep_all + wib * 32;
  T* buf = buf_all + static_cast<long long>(wib) * 32 * buf_row;
  const int warp = blockIdx.x * warps + wib;
  int l_first, n_l, lg2;
  if constexpr (TABLE) {
    if (warp >= a.n_work) return;
    l_first = a.work[3 * warp];
    n_l = a.work[3 * warp + 1];
    lg2 = a.work[3 * warp + 2];
  } else {
    lg2 = a.lg2;
    l_first = warp << (5 - lg2);
    if (l_first >= a.L) return;
    n_l = min(32 >> lg2, a.L - l_first);
  }
  const long long wc = static_cast<long long>(a.n_r) * dr;
  if constexpr (!TABLE) {
    // B1/B8 write W whole: the warp zeroes its landmarks' rows (contiguous)
    // before any block lands in them.
    T* rows0 = a.w + static_cast<long long>(l_first) * dl * wc;
    const long long n_zero = static_cast<long long>(n_l) * dl * wc;
    for (long long i = lane; i < n_zero; i += 32) rows0[i] = T(0);
    __syncwarp();
  }
  const int G = 1 << lg2;
  const int grp = lane >> lg2;
  const int j = lane & (G - 1);
  const bool live = grp < n_l;
  const int l = l_first + grp;
  int s0 = 0, ns = 0;
  if (live) {
    if constexpr (TABLE) {
      s0 = a.starts[l];
      ns = a.starts[l + 1] - s0;
    } else {
      ns = a.K;
    }
  }
  int rounds = (ns + G - 1) >> lg2;
#pragma unroll
  for (int off = 16; off; off >>= 1)
    rounds = max(rounds, __shfl_xor_sync(kFull, rounds, off));
  T h[NH];
  T g[DL];
#pragma unroll
  for (int i = 0; i < NH; ++i) h[i] = T(0);
#pragma unroll
  for (int i = 0; i < DL; ++i) g[i] = T(0);

  for (int r = 0; r < rounds; ++r) {
    const int k = (r << lg2) + j;
    const bool has = live && k < ns;
    long long o = 0, og = 0;
    bool repeat = false;
    if (has) {
      if constexpr (TABLE) {
        const int e = a.slots[s0 + k];
        repeat = e < 0;
        o = repeat ? ~e : e;
        og = o * a.gk;
      } else {
        o = k * a.sk + l * a.sl;
        og = k * a.gk + l * a.gl;
      }
    }
    T dd1 = T(0), dd2 = T(0);
    int v = a.n_r;
    T je[N][DL], jr[N][DR], ge[DL], gr[DR];
#pragma unroll
    for (int d = 0; d < DL; ++d) {
      ge[d] = T(0);
#pragma unroll
      for (int ni = 0; ni < N; ++ni) je[ni][d] = T(0);
    }
#pragma unroll
    for (int p = 0; p < DR; ++p) {
      gr[p] = T(0);
#pragma unroll
      for (int ni = 0; ni < N; ++ni) jr[ni][p] = T(0);
    }
    if (has) {
      dd1 = a.d1[o];
      dd2 = a.d2[o];
      v = a.vc[o];
#pragma unroll
      for (int d = 0; d < DL; ++d) {
        if (d < dl) {
          const int row = a.e_start + d;
          ge[d] = a.g0[og + row * a.gss];
#pragma unroll
          for (int ni = 0; ni < N; ++ni)
            if (ni < n) je[ni][d] = a.jac[o + ni * a.jsn + row * a.jss];
        }
      }
#pragma unroll
      for (int p = 0; p < DR; ++p) {
        if (p < dr) {
          const int row = p < a.e_start ? p : p + dl;
          gr[p] = a.g0[og + row * a.gss];
#pragma unroll
          for (int ni = 0; ni < N; ++ni)
            if (ni < n) jr[ni][p] = a.jac[o + ni * a.jsn + row * a.jss];
        }
      }
      int idx = 0;
#pragma unroll
      for (int e1 = 0; e1 < DL; ++e1) {
        if (e1 < dl) g[e1] += ge[e1] * dd1;
#pragma unroll
        for (int e2 = e1; e2 < DL; ++e2) {
          if (e2 < dl) {
            T jj = T(0);
#pragma unroll
            for (int ni = 0; ni < N; ++ni)
              if (ni < n) jj += je[ni][e1] * je[ni][e2];
            h[idx] += jj * dd1 + dd2 * ge[e1] * ge[e2];
          }
          ++idx;
        }
      }
    }
    const bool wv = has && v >= 0 && v < a.n_r;
    if constexpr (!TABLE) {
      if (a.K <= 32) {
        // One round: the earlier slots of the landmark are the lower lanes
        // of its group.
        const unsigned long long key =
            wv ? (static_cast<unsigned long long>(v) << 6) | grp
               : ~static_cast<unsigned long long>(lane);
        repeat = (__match_any_sync(kFull, key) & ((1u << lane) - 1u)) != 0u;
      } else {
        repeat = true;  // several rounds: every slot adds into the zeroed W
      }
    }
    if (wv) {
      T* row = buf + lane * buf_row;
#pragma unroll
      for (int d = 0; d < DL; ++d) {
#pragma unroll
        for (int p = 0; p < DR; ++p) {
          if (d < dl && p < dr) {
            T jj = T(0);
#pragma unroll
            for (int ni = 0; ni < N; ++ni)
              if (ni < n) jj += jr[ni][p] * je[ni][d];
            row[d * dr + p] = jj * dd1 + dd2 * gr[p] * ge[d];
          }
        }
      }
    }
    dst[lane] = wv ? (static_cast<long long>(l) * dl * wc + static_cast<long long>(v) * dr) : -1;
    rep[lane] = repeat;
    __syncwarp();
    // Entry i of every block is written by lane i % 32, so a repeated
    // camera's slot adds after the slot that stored the block.
    for (int i = lane; i < nw; i += 32) {
      const long long off = (i / dr) * wc + i % dr;
      for (int src = 0; src < 32; ++src) {
        const long long base = dst[src];
        if (base < 0) continue;
        T* dp = a.w + base + off;
        const T val = buf[src * buf_row + i];
        if (rep[src]) {
          *dp += val;
        } else {
          *dp = val;
        }
      }
    }
    __syncwarp();
    if constexpr (CAM) {
      const int cp = has ? a.cpos[o] : -1;
      const bool cv = cp >= 0 && cp < a.n_rows;
      if (cv) {
        T* row = buf + lane * buf_row;
        int idx = 0;
#pragma unroll
        for (int p = 0; p < DR; ++p) {
#pragma unroll
          for (int q = p; q < DR; ++q) {
            if (q < dr) {
              T jj = T(0);
#pragma unroll
              for (int ni = 0; ni < N; ++ni)
                if (ni < n) jj += jr[ni][p] * jr[ni][q];
              row[idx] = jj * dd1 + dd2 * gr[p] * gr[q];
              ++idx;
            }
          }
        }
#pragma unroll
        for (int p = 0; p < DR; ++p)
          if (p < dr) row[np + p] = gr[p] * dd1;
      }
      dst[lane] = cv ? cp : -1;
      __syncwarp();
      for (int src = 0; src < 32; ++src) {
        const long long rw = dst[src];
        if (rw < 0) continue;
        T* rp = a.rows + rw * nab;
        for (int i = lane; i < nab; i += 32) rp[i] = buf[src * buf_row + i];
      }
      __syncwarp();
    }
  }
  // The group's sums, by a fixed butterfly: every lane of the group ends
  // with the same bits.
  for (int off = G >> 1; off; off >>= 1) {
#pragma unroll
    for (int i = 0; i < NH; ++i) h[i] += __shfl_xor_sync(kFull, h[i], off);
#pragma unroll
    for (int i = 0; i < DL; ++i) g[i] += __shfl_xor_sync(kFull, g[i], off);
  }
  if (live && j == 0) {
    const long long lt = a.L_total;
    int idx = 0;
#pragma unroll
    for (int e1 = 0; e1 < DL; ++e1) {
      if (e1 < dl) {
        const long long ig = e1 * lt + l;
        a.g_l[ig] = ACCUM ? a.g_l[ig] + g[e1] : g[e1];
      }
#pragma unroll
      for (int e2 = e1; e2 < DL; ++e2) {
        if (e2 < dl) {
          const long long i12 = (e1 * dl + e2) * lt + l;
          const T hv = ACCUM ? a.h_ll[i12] + h[idx] : h[idx];
          a.h_ll[i12] = hv;
          a.h_ll[(e2 * dl + e1) * lt + l] = hv;
        }
        ++idx;
      }
    }
  }
}

// One launch over n_warps warp items: the unrolled instance of the two
// hot shapes (the pinhole and the Snavely camera with a point), else the
// any-shape instance within the caps (n <= kMaxN, dr_s <= kMaxDr, dl <=
// kMaxDl), with as many warps a block as fit kSmemCap.
template <typename T, bool ACCUM, bool CAM, bool TABLE>
int launch(AsmArgs<T>& args, int n, int s, int dr_s, int dl, int n_warps, void* stream) {
  if (n < 1 || n > kMaxN || dr_s < 1 || dr_s > kMaxDr || dl < 1 || dl > kMaxDl ||
      s != dr_s + dl)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_warps <= 0) return 0;
  args.n = n;
  args.dr = dr_s;
  args.dl = dl;
  const int per_warp = staging_bytes<T>(staging_row(dr_s, dl, CAM));
  int warps = warps_per_block<T>();
  while (warps > 1 && warps * per_warp > kSmemCap) --warps;
  const int blocks = (n_warps + warps - 1) / warps;
  const size_t smem = static_cast<size_t>(warps) * per_warp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 2 && dr_s == 6 && dl == 3) {
    assemble_kernel<T, 2, 6, 3, true, ACCUM, CAM, TABLE><<<blocks, warps * 32, smem, st>>>(args);
  } else if (n == 2 && dr_s == 9 && dl == 3) {
    assemble_kernel<T, 2, 9, 3, true, ACCUM, CAM, TABLE><<<blocks, warps * 32, smem, st>>>(args);
  } else {
    assemble_kernel<T, kMaxN, kMaxDr, kMaxDl, false, ACCUM, CAM, TABLE>
        <<<blocks, warps * 32, smem, st>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

// B1 and B8: one [K, L] tile, G from K.
template <typename T, bool CAM>
int launch_uniform(const void* jac, const void* g0, const void* d1,
                   const void* d2, const void* vc, const void* cpos,
                   void* h_ll, void* g_l, void* w, void* rows, int n, int s,
                   int k, int l, int n_r, int n_rows, int dr_s, int dl,
                   int e_start, long long jsn, long long jss, long long gss,
                   long long sk, long long sl, long long gk, long long gl,
                   void* stream) {
  if (l == 0) return 0;
  int lg2 = 0;
  while (lg2 < 5 && (1 << lg2) < k) ++lg2;
  AsmArgs<T> a{};
  a.jac = static_cast<const T*>(jac);
  a.g0 = static_cast<const T*>(g0);
  a.d1 = static_cast<const T*>(d1);
  a.d2 = static_cast<const T*>(d2);
  a.vc = static_cast<const int*>(vc);
  a.cpos = static_cast<const int*>(cpos);
  a.h_ll = static_cast<T*>(h_ll);
  a.g_l = static_cast<T*>(g_l);
  a.w = static_cast<T*>(w);
  a.rows = static_cast<T*>(rows);
  a.jsn = jsn;
  a.jss = jss;
  a.gss = gss;
  a.sk = sk;
  a.sl = sl;
  a.gk = gk;
  a.gl = gl;
  a.K = k;
  a.L = l;
  a.lg2 = lg2;
  a.L_total = l;
  a.n_r = n_r;
  a.n_rows = n_rows;
  a.e_start = e_start;
  const int per = 32 >> lg2;
  return launch<T, false, CAM, false>(a, n, s, dr_s, dl, (l + per - 1) / per, stream);
}

// B2: the whole batch, one launch over the work list.
template <typename T>
int launch_table(const void* jac, const void* g0, const void* d1,
                 const void* d2, const void* vc, const void* cpos,
                 const void* slots, const void* starts, const void* work,
                 void* h_ll, void* g_l, void* w, void* rows, int n, int s,
                 int n_work, int l_total, int n_r, int n_rows, int dr_s,
                 int dl, int e_start, long long jsn, long long jss,
                 long long gss, long long gk, void* stream) {
  AsmArgs<T> a{};
  a.jac = static_cast<const T*>(jac);
  a.g0 = static_cast<const T*>(g0);
  a.d1 = static_cast<const T*>(d1);
  a.d2 = static_cast<const T*>(d2);
  a.vc = static_cast<const int*>(vc);
  a.cpos = static_cast<const int*>(cpos);
  a.slots = static_cast<const int*>(slots);
  a.starts = static_cast<const int*>(starts);
  a.work = static_cast<const int*>(work);
  a.h_ll = static_cast<T*>(h_ll);
  a.g_l = static_cast<T*>(g_l);
  a.w = static_cast<T*>(w);
  a.rows = static_cast<T*>(rows);
  a.jsn = jsn;
  a.jss = jss;
  a.gss = gss;
  a.gk = gk;
  a.n_work = n_work;
  a.L_total = l_total;
  a.n_r = n_r;
  a.n_rows = n_rows;
  a.e_start = e_start;
  return launch<T, true, true, true>(a, n, s, dr_s, dl, n_work, stream);
}

}  // namespace

extern "C" {

#define NLLSTPU_UNIFORM(NAME, T, CAM)                                          \
  int NAME(const void* jac, const void* g0, const void* d1, const void* d2,    \
           const void* vc, const void* cpos, void* h_ll, void* g_l, void* w,   \
           void* rows, int n, int s, int k, int l, int n_r, int n_rows,        \
           int dr_s, int dl, int e_start, long long jsn, long long jss,        \
           long long gss, long long sk, long long sl, long long gk,            \
           long long gl, void* stream) {                                       \
    return launch_uniform<T, CAM>(jac, g0, d1, d2, vc, cpos, h_ll, g_l, w,     \
                                  rows, n, s, k, l, n_r, n_rows, dr_s, dl,     \
                                  e_start, jsn, jss, gss, sk, sl, gk, gl,      \
                                  stream);                                     \
  }
NLLSTPU_UNIFORM(fused_obs_all_f32, float, true)
NLLSTPU_UNIFORM(fused_obs_all_f64, double, true)
NLLSTPU_UNIFORM(fused_obs_leg_f32, float, false)
NLLSTPU_UNIFORM(fused_obs_leg_f64, double, false)
#undef NLLSTPU_UNIFORM

int fused_obs_all_into_f32(const void* jac, const void* g0, const void* d1,
                           const void* d2, const void* vc, const void* cpos,
                           const void* slots, const void* starts,
                           const void* work, void* h_ll, void* g_l, void* w,
                           void* rows, int n, int s, int n_work, int l_total,
                           int n_r, int n_rows, int dr_s, int dl, int e_start,
                           long long jsn, long long jss, long long gss,
                           long long gk, void* stream) {
  return launch_table<float>(jac, g0, d1, d2, vc, cpos, slots, starts, work,
                             h_ll, g_l, w, rows, n, s, n_work, l_total, n_r,
                             n_rows, dr_s, dl, e_start, jsn, jss, gss, gk,
                             stream);
}

int fused_obs_all_into_f64(const void* jac, const void* g0, const void* d1,
                           const void* d2, const void* vc, const void* cpos,
                           const void* slots, const void* starts,
                           const void* work, void* h_ll, void* g_l, void* w,
                           void* rows, int n, int s, int n_work, int l_total,
                           int n_r, int n_rows, int dr_s, int dl, int e_start,
                           long long jsn, long long jss, long long gss,
                           long long gk, void* stream) {
  return launch_table<double>(jac, g0, d1, d2, vc, cpos, slots, starts, work,
                              h_ll, g_l, w, rows, n, s, n_work, l_total, n_r,
                              n_rows, dr_s, dl, e_start, jsn, jss, gss, gk,
                              stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
