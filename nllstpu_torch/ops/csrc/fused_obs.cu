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
// Design of the two unrolled instances: slots in parallel.  A warp takes 32 / G landmarks and gives
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
// more, assemble_any_kernel, takes any shape within n <= 4, dr_s <= 16, dl
// <= 6 with nothing in a lane sized by those caps: each round the warp
// stages its 32 slots in dynamic shared memory sized to the real shape
// (each lane copies its own slot by cp.async: its n x S Jacobian columns,
// g0, rho' and 2 rho''), then reads them back from shared memory, a lane
// holding a few values whatever the shape:
//   - h_ll and g_l entry by entry: each lane its own slot's term, summed
//     over the landmark's lane group by a fixed xor butterfly and added to
//     a shared accumulator (so over the rounds too);
//   - W by items (block, camera column p), 32 at a time, neighbouring
//     lanes on neighbouring columns: over the round's first slot of each
//     (landmark, camera) (__match_any_sync), that slot and the later slots
//     of the round with its camera summed in slot order for each of the
//     column's dl rows, then stored, or added where an earlier round
//     stored the block (B2: the table's ~o mark on that first slot;
//     B1/B8: a tile of more than 32 slots, whose W rows the warp zeroed);
//   - the camera rows by items (slot, column q) of the non-dustbin slots:
//     the a_rr entries (p, q), p <= q, and b_r's entry q.
// One instance rather than one per shape compiled at first use: the
// library stays one build of fixed sources, and no new shape compiles
// anything inside a timed run or a graph capture.  Its shared memory
// (any_bytes) is opted in once per device, at the caps, before its first
// launch.  The host sends a batch outside the caps to the generic route at
// compile time (fused_obs.kernel_takes).
//
// Bound: device-memory traffic (the Jacobian read once, W's touched
// blocks and the camera rows written once; B1/B8 also write W's zeros,
// most of their bytes).  Slots of a dustbin camera
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
// Warps per block of the any-shape instance (fused_obs.ANY_WARPS).
constexpr int kAnyWarps = 4;

// Warps per block of the two unrolled instances: the shared staging is
// 32 rows of up to 55 values per warp, about 28 KB a block in either float
// type.
template <typename T>
__host__ __device__ constexpr int warps_per_block() {
  return sizeof(T) == 8 ? 2 : 4;
}

// Values per staged row of the unrolled instances (odd: lanes writing
// their own rows hit distinct banks): a slot's W block, or its camera row
// where that is wider.
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

// The instance unrolled for the shape (N, DR, DL).
template <typename T, int N, int DR, int DL, bool ACCUM, bool CAM, bool TABLE>
__global__ void __launch_bounds__(warps_per_block<T>() * 32)
    assemble_kernel(const AsmArgs<T> a) {
  constexpr int NH = DL * (DL + 1) / 2;
  constexpr int n = N;
  constexpr int dr = DR;
  constexpr int dl = DL;
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

// The any-shape instance's shared memory (fused_obs.any_shape_plan on the
// host mirrors these).  A staged slot holds its Jacobian columns J[ni][row]
// (n x S), g0 (S), rho' and 2 rho'': an odd count, so that lanes on
// distinct slots hit distinct banks.
__host__ __device__ constexpr int any_stride(int n, int s) { return (n * s + s + 2) | 1; }
// Entries of a landmark's h_ll upper triangle and g_l.
__host__ __device__ constexpr int any_hg(int dl) { return dl * (dl + 1) / 2 + dl; }
// The block's h_ll / g_l entry table, one int each, padded to 16 bytes.
__host__ __device__ constexpr int any_table_bytes(int dl) { return (4 * any_hg(dl) + 15) / 16 * 16; }
// One warp's region: 32 staged slots, the h_ll / g_l accumulators of up to
// 32 landmarks, the round's W leaders (block offset and mask) and camera
// rows (row, slot).
template <typename T>
__host__ __device__ constexpr int any_warp_bytes(int n, int dr, int dl) {
  return 32 * (any_stride(n, dr + dl) + any_hg(dl)) * static_cast<int>(sizeof(T)) +
         32 * (8 + 4 + 8);
}
template <typename T>
__host__ __device__ constexpr int any_bytes(int n, int dr, int dl) {
  return any_table_bytes(dl) + kAnyWarps * any_warp_bytes<T>(n, dr, dl);
}

// Lane q's items of a flat list of (a, b) pairs, b fastest (nb to an a),
// 32 items apart.
struct Walk {
  int a, b, da, db, nb;
  __device__ Walk(int q, int nb_) : nb(nb_) {
    a = q / nb;
    b = q - a * nb;
    da = 32 / nb;
    db = 32 - da * nb;
  }
  __device__ void next() {
    a += da;
    b += db;
    if (b >= nb) {
      b -= nb;
      ++a;
    }
  }
};

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(sizeof(T))
               : "memory");
}

// Row of S holding camera dof p (the landmark's dl rows start at e_start).
__device__ __forceinline__ int camera_row(int p, int e_start, int dl) {
  return p < e_start ? p : p + dl;
}

// Column b of a staged slot sp (n Jacobian rows, then g0, rho', 2 rho''):
// its Jacobian entries into jb[0..n) (kMaxN registers, constant indices).
template <typename T>
__device__ __forceinline__ void load_column(const T* sp, int n, int s, int b, T (&jb)[kMaxN]) {
#pragma unroll
  for (int ni = 0; ni < kMaxN; ++ni) jb[ni] = ni < n ? sp[ni * s + b] : T(0);
}

// One entry from a staged slot: sum_ni J[ni][a] jb[ni] rho' + 2 rho'' g0[a]
// gb, the unrolled instances' arithmetic, column b held in registers.
template <typename T>
__device__ __forceinline__ T pair_value(const T* sp, int n, int s, int a, const T (&jb)[kMaxN],
                                        T gb) {
  const T* g = sp + n * s;
  T jj = T(0);
#pragma unroll
  for (int ni = 0; ni < kMaxN; ++ni)
    if (ni < n) jj += sp[ni * s + a] * jb[ni];
  return jj * g[s] + g[s + 1] * g[a] * gb;
}

// The any-shape instance (see the header): the same work items as
// assemble_kernel, the shape read from the arguments.  The bound's one
// block an SM lets ptxas take the registers it needs: without it ptxas
// held the instance to 56-72 registers and spilled 16-44 bytes, 10-25%
// slower.
template <typename T, bool ACCUM, bool CAM, bool TABLE>
__global__ void __launch_bounds__(kAnyWarps * 32, 1) assemble_any_kernel(const AsmArgs<T> a) {
  const int n = a.n, dr = a.dr, dl = a.dl, s = dr + dl, e_start = a.e_start;
  const int nh = any_hg(dl), nhp = dl * (dl + 1) / 2;
  const int stride = any_stride(n, s);
  extern __shared__ __align__(16) unsigned char smem[];
  // h_ll entry (e1, e2) -> their rows | e1 << 16 | e2 << 24; g_l entry
  // e -> its row | 0xff << 8 | e << 16.
  int* htab = reinterpret_cast<int*>(smem);
  for (int t = threadIdx.x; t < nh; t += blockDim.x) {
    int code;
    if (t < nhp) {
      int e1 = 0, q = t;
      while (q >= dl - e1) {
        q -= dl - e1;
        ++e1;
      }
      code = (e_start + e1) | (e_start + e1 + q) << 8 | e1 << 16 | (e1 + q) << 24;
    } else {
      code = (e_start + t - nhp) | 0xff << 8 | (t - nhp) << 16;
    }
    htab[t] = code;
  }
  __syncthreads();
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* region = smem + any_table_bytes(dl) + wib * any_warp_bytes<T>(n, dr, dl);
  T* stage = reinterpret_cast<T*>(region);  // [32][stride]
  T* acc = stage + 32 * stride;             // [nh][32]: entry t of landmark li
  long long* lead = reinterpret_cast<long long*>(acc + 32 * nh);  // block offset << 1 | add
  unsigned* lmask = reinterpret_cast<unsigned*>(lead + 32);       // the block's slots
  int2* cams = reinterpret_cast<int2*>(lmask + 32);                // (row, slot)
  const int warp = blockIdx.x * kAnyWarps + wib;
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
  for (int i = lane; i < 32 * nh; i += 32) acc[i] = T(0);
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  T* const own = stage + lane * stride;  // this lane's staged slot

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
      for (int ni = 0; ni < n; ++ni) {
        const T* src = a.jac + o + ni * a.jsn;
        for (int row = 0; row < s; ++row) copy_async(own + ni * s + row, src + row * a.jss);
      }
      for (int row = 0; row < s; ++row) copy_async(own + n * s + row, a.g0 + og + row * a.gss);
      copy_async(own + (n + 1) * s, a.d1 + o);
      copy_async(own + (n + 1) * s + 1, a.d2 + o);
    }
    if constexpr (!TABLE) {
      if (r == 0) {
        // B1/B8 write W whole: the warp zeroes its landmarks' rows
        // (contiguous) while its first round's copies are in flight.
        T* rows0 = a.w + static_cast<long long>(l_first) * dl * wc;
        const long long n_zero = static_cast<long long>(n_l) * dl * wc;
        long long i0 = 0;
        if ((reinterpret_cast<size_t>(rows0) & 15) == 0) {
          const long long n16 = n_zero * static_cast<long long>(sizeof(T)) / 16;
          int4* z = reinterpret_cast<int4*>(rows0);
          for (long long i = lane; i < n16; i += 32) z[i] = make_int4(0, 0, 0, 0);
          i0 = n16 * (16 / static_cast<long long>(sizeof(T)));
        }
        for (long long i = i0 + lane; i < n_zero; i += 32) rows0[i] = T(0);
      }
    }
    const int v = has ? a.vc[o] : a.n_r;
    // The round's first slot of each (landmark, camera) leads its block.
    const bool wv = has && v >= 0 && v < a.n_r;
    const unsigned long long key =
        wv ? (static_cast<unsigned long long>(v) << 6) | grp : ~static_cast<unsigned long long>(lane);
    const unsigned same = __match_any_sync(kFull, key);
    const bool first = wv && (same & below) == 0u;
    const unsigned firsts = __ballot_sync(kFull, first);
    if (first) {
      bool add;
      if constexpr (TABLE) {
        add = repeat;  // an earlier round stored the block
      } else {
        add = a.K > 32;  // several rounds add into the zeroed rows
      }
      const int at = __popc(firsts & below);
      lead[at] = (static_cast<long long>(l) * dl * wc + static_cast<long long>(v) * dr) * 2 + add;
      lmask[at] = same;
    }
    unsigned cmask = 0u;
    if constexpr (CAM) {
      const int cp = has ? a.cpos[o] : -1;
      const bool cv = cp >= 0 && cp < a.n_rows;
      cmask = __ballot_sync(kFull, cv);
      if (cv) cams[__popc(cmask & below)] = make_int2(cp, lane);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    // h_ll and g_l: each lane its own slot's term, the group's by a fixed
    // butterfly, added to the landmark's accumulator.
    for (int t = 0; t < nh; ++t) {
      const int code = htab[t];
      T c = T(0);
      if (has) {
        const int ra = code & 0xff, rb = (code >> 8) & 0xff;
        const T* g = own + n * s;
        if (rb == 0xff) {
          c = g[ra] * g[s];
        } else {
          T jb[kMaxN];
          load_column(own, n, s, rb, jb);
          c = pair_value(own, n, s, ra, jb, g[rb]);
        }
      }
      for (int off = G >> 1; off; off >>= 1) c += __shfl_xor_sync(kFull, c, off);
      if (live && j == 0) acc[t * 32 + grp] += c;
    }
    // W: items (leader, camera column p), each the column's dl rows over
    // the leader's slots in slot order.
    const int n_first = __popc(firsts);
    for (Walk q(lane, dr); q.a < n_first; q.next()) {
      const long long code = lead[q.a];
      const int rp = camera_row(q.b, e_start, dl);
      unsigned m = lmask[q.a];
      T col[kMaxDl];
      bool head = true;
      while (m) {
        const T* sp = stage + (__ffs(m) - 1) * stride;
        m &= m - 1u;
        T jb[kMaxN];
        load_column(sp, n, s, rp, jb);
        const T gb = sp[n * s + rp];
#pragma unroll
        for (int d = 0; d < kMaxDl; ++d) {
          if (d < dl) {
            const T val = pair_value(sp, n, s, e_start + d, jb, gb);
            col[d] = head ? val : col[d] + val;
          }
        }
        head = false;
      }
      T* dp = a.w + (code >> 1) + q.b;
#pragma unroll
      for (int d = 0; d < kMaxDl; ++d) {
        if (d < dl) {
          if (code & 1) {
            dp[d * wc] += col[d];
          } else {
            dp[d * wc] = col[d];
          }
        }
      }
    }
    if constexpr (CAM) {
      // Each non-dustbin slot's camera row, written once: item (slot,
      // column q) writes a_rr's (p, q), p <= q, and b_r's q.
      const int n_c = __popc(cmask), nab = dr * (dr + 3) / 2;
      for (Walk q(lane, dr); q.a < n_c; q.next()) {
        const int2 c = cams[q.a];
        const T* sp = stage + c.y * stride;
        const int rq = camera_row(q.b, e_start, dl);
        T jb[kMaxN];
        load_column(sp, n, s, rq, jb);
        const T gq = sp[n * s + rq];
        T* row = a.rows + static_cast<long long>(c.x) * nab;
        int at = q.b;  // a_rr entry (p, q): row p starts at p dr - p (p - 1) / 2
        for (int p = 0; p <= q.b; ++p) {
          row[at] = pair_value(sp, n, s, camera_row(p, e_start, dl), jb, gq);
          at += dr - p - 1;
        }
        row[dr * (dr + 1) / 2 + q.b] = gq * sp[(n + 1) * s];
      }
    }
    __syncwarp();  // the stage and the lists are read before the next round
  }
  const long long lt = a.L_total;
  for (Walk q(lane, n_l); q.a < nh; q.next()) {
    const int code = htab[q.a];
    const T val = acc[q.a * 32 + q.b];
    const long long lm = l_first + q.b;
    const int e1 = (code >> 16) & 0xff;
    if (((code >> 8) & 0xff) == 0xff) {
      const long long ig = e1 * lt + lm;
      a.g_l[ig] = ACCUM ? a.g_l[ig] + val : val;
    } else {
      const int e2 = (code >> 24) & 0xff;
      const long long i12 = (e1 * dl + e2) * lt + lm;
      const T hv = ACCUM ? a.h_ll[i12] + val : val;
      a.h_ll[i12] = hv;
      a.h_ll[(e2 * dl + e1) * lt + lm] = hv;
    }
  }
}

// One launch over n_warps warp items: the unrolled instance of the two
// hot shapes (the pinhole and the Snavely camera with a point), else the
// any-shape instance within the caps (n <= kMaxN, dr_s <= kMaxDr, dl <=
// kMaxDl), whose shared memory is opted in at the caps on the first launch
// on each device.
template <typename T, bool ACCUM, bool CAM, bool TABLE>
int launch(AsmArgs<T>& args, int n, int s, int dr_s, int dl, int n_warps, void* stream) {
  if (n < 1 || n > kMaxN || dr_s < 1 || dr_s > kMaxDr || dl < 1 || dl > kMaxDl ||
      s != dr_s + dl)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_warps <= 0) return 0;
  args.n = n;
  args.dr = dr_s;
  args.dl = dl;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pinhole = n == 2 && dr_s == 6 && dl == 3;
  if (pinhole || (n == 2 && dr_s == 9 && dl == 3)) {
    const int warps = warps_per_block<T>();
    const int blocks = (n_warps + warps - 1) / warps;
    const size_t smem =
        static_cast<size_t>(warps) * staging_bytes<T>(staging_row(dr_s, dl, CAM));
    if (pinhole)
      assemble_kernel<T, 2, 6, 3, ACCUM, CAM, TABLE><<<blocks, warps * 32, smem, st>>>(args);
    else
      assemble_kernel<T, 2, 9, 3, ACCUM, CAM, TABLE><<<blocks, warps * 32, smem, st>>>(args);
    return static_cast<int>(cudaGetLastError());
  }
  static unsigned long long configured = 0;  // devices whose attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !((configured >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(assemble_any_kernel<T, ACCUM, CAM, TABLE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               any_bytes<T>(kMaxN, kMaxDr, kMaxDl));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) configured |= 1ull << dev;
  }
  const int blocks = (n_warps + kAnyWarps - 1) / kAnyWarps;
  assemble_any_kernel<T, ACCUM, CAM, TABLE>
      <<<blocks, kAnyWarps * 32, any_bytes<T>(n, dr_s, dl), st>>>(args);
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

// The any-shape instance's dynamic shared memory for one block, bytes (the
// host mirror: fused_obs.any_shape_plan).
int fused_obs_any_bytes(int n, int dr_s, int dl, int f64) {
  return f64 ? any_bytes<double>(n, dr_s, dl) : any_bytes<float>(n, dr_s, dl);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
