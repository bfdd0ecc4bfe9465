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
// Shapes: the JAX kernels take any (n residual rows, dr_s, dl), and so do
// these.  Two instances are unrolled for the hot shapes, (2, 6, 3) and
// (2, 9, 3); one more, assemble_any_kernel, takes every other shape with
// nothing in a lane sized by the shape: each round the warp stages its 32
// slots in dynamic shared memory sized to the real shape (each lane copies
// its own slot by cp.async: its n x S Jacobian columns, g0, rho' and
// 2 rho''), then reads them back from shared memory, a lane holding a few
// values whatever the shape (kHeldRows Jacobian rows of one column, the
// later ones read in place; kColRows rows of a W column):
//   - h_ll and g_l in chunks of 32 entries: each lane its own slot's term,
//     summed over the landmark's lane group by a fixed xor butterfly into
//     the chunk's sums, written by items (entry, landmark), neighbouring
//     lanes on neighbouring landmarks (B2 adds them to its buffers): at dl
//     <= 6 one chunk kept over the rounds and written after the last, past
//     it each chunk every round, stored on a B1/B8 warp's first round and
//     added on its later ones (only a warp of one landmark has more than
//     one);
//   - W by items (block, camera column p), 32 at a time, neighbouring
//     lanes on neighbouring columns: over the round's first slot of each
//     (landmark, camera) (__match_any_sync), that slot and the later slots
//     of the round with its camera summed in slot order for each of the
//     column's dl rows, kColRows rows at a time, then stored, or added
//     where an earlier round stored the block (B2: the table's ~o mark on
//     that first slot; B1/B8: a tile of more than 32 slots, whose W rows
//     the warp zeroed);
//   - the camera rows by items (slot, column q) of the non-dustbin slots:
//     the a_rr entries (p, q), p <= q, and b_r's entry q.
// The one limit is the hardware's: a warp's region (32 staged slots of
// n S + S + 2 values, a chunk's sums, 768 bytes of lists) must fit the
// 227 KB of shared memory a block opts in to; a block takes up to four
// warps, as many as fit (any_warps).  The host sends a batch past that to
// the generic route at compile time (fused_obs.kernel_takes), the
// counterpart of the JAX route's VMEM fit.  The entry codes keep e1 and
// e2 in 16 bits, far past any dl that fits.
// One instance rather than one per shape compiled at first use: the
// library stays one build of fixed sources, and no new shape compiles
// anything inside a timed run or a graph capture; it is built four times,
// with and without the code that only n > kHeldRows (WIDE_N) and dl >
// kColRows (WIDE_DL) need, so that the other shapes keep their registers.
// Its shared memory is opted in once per device, at kSmemLimit, before its
// first launch.
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
// Warps per block of the any-shape instance where its shared memory holds
// them (fused_obs.ANY_WARPS).
constexpr int kAnyWarps = 4;
// Shared memory a block of the any-shape instance may take, bytes: the
// 227 KB a block of an sm_90 card opts in to (fused_obs.SMEM_LIMIT).
constexpr int kSmemLimit = 232448;
// The any-shape instance's registers: the Jacobian rows of one column it
// holds (later rows are read from shared memory in place), and the rows
// of one W column it sums at a time.
constexpr int kHeldRows = 4;
constexpr int kColRows = 6;

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
// h_ll / g_l entries summed per chunk (a landmark holds dl(dl+1)/2 + dl).
__host__ __device__ constexpr int any_chunk(int dl) {
  return dl * (dl + 1) / 2 + dl < 32 ? dl * (dl + 1) / 2 + dl : 32;
}
// One warp's region: 32 staged slots; a chunk's group sums, one per entry
// and landmark; the round's W leaders (block offset, mask), camera rows
// (row, slot) and the chunk's entry codes.
template <typename T>
__host__ __device__ constexpr int any_warp_bytes(int n, int dr, int dl) {
  return 32 * (any_stride(n, dr + dl) + any_chunk(dl)) * static_cast<int>(sizeof(T)) +
         32 * (8 + 4 + 8 + 4);
}
// Warps a block: kAnyWarps, or as many as a block's shared memory holds
// (0: the shape does not fit one warp).
template <typename T>
__host__ __device__ constexpr int any_warps(int n, int dr, int dl) {
  return kSmemLimit / any_warp_bytes<T>(n, dr, dl) < kAnyWarps
             ? kSmemLimit / any_warp_bytes<T>(n, dr, dl)
             : kAnyWarps;
}
template <typename T>
__host__ __device__ constexpr int any_bytes(int n, int dr, int dl) {
  return any_warps<T>(n, dr, dl) * any_warp_bytes<T>(n, dr, dl);
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
// its first kHeldRows Jacobian entries into registers (constant indices).
template <typename T>
__device__ __forceinline__ void load_column(const T* sp, int n, int s, int b,
                                            T (&jb)[kHeldRows]) {
#pragma unroll
  for (int ni = 0; ni < kHeldRows; ++ni) jb[ni] = ni < n ? sp[ni * s + b] : T(0);
}

// One entry from a staged slot: sum_ni J[ni][a] J[ni][b] rho' + 2 rho''
// g0[a] gb, the unrolled instances' arithmetic in the same order, column
// b's first kHeldRows rows held in registers and (WIDE_N) its later ones
// read in place.
template <bool WIDE_N, typename T>
__device__ __forceinline__ T pair_value(const T* sp, int n, int s, int a, int b,
                                        const T (&jb)[kHeldRows], T gb) {
  const T* g = sp + n * s;
  T jj = T(0);
#pragma unroll
  for (int ni = 0; ni < kHeldRows; ++ni)
    if (ni < n) jj += sp[ni * s + a] * jb[ni];
  if constexpr (WIDE_N) {
    for (int ni = kHeldRows; ni < n; ++ni) jj += sp[ni * s + a] * sp[ni * s + b];
  }
  return jj * g[s] + g[s + 1] * g[a] * gb;
}

// The any-shape instance's h_ll / g_l writes: a chunk's nt sums (entry u
// of landmark li at hsum[u * 32 + li], its code tcode[u]: e1 | e2 << 16 of
// h_ll, e | 0xffff << 16 of g_l) out by items (entry, landmark),
// neighbouring lanes on neighbouring landmarks; stored, or added to what the
// buffers hold.
template <typename T>
__device__ __forceinline__ void write_hg(T* h_ll, T* g_l, const unsigned* tcode, const T* hsum,
                                         int nt, int n_l, int lane, long long l_first,
                                         long long lt, int dl, bool add) {
  for (Walk q(lane, n_l); q.a < nt; q.next()) {
    const unsigned code = tcode[q.a];
    const T val = hsum[q.a * 32 + q.b];
    const long long lm = l_first + q.b;
    const int c1 = static_cast<int>(code & 0xffffu), c2 = static_cast<int>(code >> 16);
    if (c2 == 0xffff) {
      const long long ig = c1 * lt + lm;
      g_l[ig] = add ? g_l[ig] + val : val;
    } else {
      const long long i12 = (static_cast<long long>(c1) * dl + c2) * lt + lm;
      const T hv = add ? h_ll[i12] + val : val;
      h_ll[i12] = hv;
      h_ll[(static_cast<long long>(c2) * dl + c1) * lt + lm] = hv;
    }
  }
}

// The any-shape instance (see the header): the same work items as
// assemble_kernel, the shape read from the arguments, the warps a block
// from the plan (blockDim).  The bound's one block an SM lets ptxas take
// the registers it needs: without it ptxas held the instance to 56-72
// registers and spilled 16-44 bytes, 10-25% slower.  WIDE_N (n >
// kHeldRows) reads a column's later rows in place, WIDE_DL (dl > kColRows)
// walks a W column in pieces and writes h_ll / g_l out by chunks every
// round.  The in-place reads inside the unrolled products cost 11-50
// registers and up to 19% on the shapes that need neither, the pieces a
// few percent more (measured on the card, PERF.md §6), so those shapes
// keep an instance without them.
template <typename T, bool ACCUM, bool CAM, bool TABLE, bool WIDE_N, bool WIDE_DL>
__global__ void __launch_bounds__(kAnyWarps * 32, 1) assemble_any_kernel(const AsmArgs<T> a) {
  const int n = a.n, dr = a.dr, dl = a.dl, s = dr + dl, e_start = a.e_start;
  const int nhp = dl * (dl + 1) / 2, nh = nhp + dl;
  const int stride = any_stride(n, s);
  extern __shared__ __align__(16) unsigned char smem[];
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* region = smem + wib * any_warp_bytes<T>(n, dr, dl);
  T* stage = reinterpret_cast<T*>(region);  // [32][stride]
  T* hsum = stage + 32 * stride;            // [chunk][32]: entry u of landmark li
  long long* lead = reinterpret_cast<long long*>(hsum + 32 * any_chunk(dl));  // offset << 1 | add
  unsigned* lmask = reinterpret_cast<unsigned*>(lead + 32);  // the block's slots
  int2* cams = reinterpret_cast<int2*>(lmask + 32);          // (row, slot)
  // Entry u of the chunk: e1 | e2 << 16 of h_ll, e | 0xffff << 16 of g_l.
  unsigned* tcode = reinterpret_cast<unsigned*>(cams + 32);
  const int warp = blockIdx.x * (blockDim.x >> 5) + wib;
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
  const long long lt = a.L_total;
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
  const unsigned below = (1u << lane) - 1u;
  T* const own = stage + lane * stride;  // this lane's staged slot
  // dl <= kColRows: at most 27 entries, one chunk kept over the rounds.
  constexpr bool one_chunk = !WIDE_DL;

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
    // W: items (leader, camera column p), each the column's dl rows, kColRows
    // at a time, over the leader's slots in slot order.
    const int n_first = __popc(firsts);
    for (Walk q(lane, dr); q.a < n_first; q.next()) {
      const long long code = lead[q.a];
      const int rp = camera_row(q.b, e_start, dl);
      T* dp = a.w + (code >> 1) + q.b;
      for (int d0 = 0; d0 < (WIDE_DL ? dl : 1); d0 += kColRows) {
        T col[kColRows];
        bool head = true;
        for (unsigned m = lmask[q.a]; m; m &= m - 1u) {
          const T* sp = stage + (__ffs(m) - 1) * stride;
          T jb[kHeldRows];
          load_column(sp, n, s, rp, jb);
          const T gb = sp[n * s + rp];
#pragma unroll
          for (int d = 0; d < kColRows; ++d) {
            if (d0 + d < dl) {
              const T val = pair_value<WIDE_N>(sp, n, s, e_start + d0 + d, rp, jb, gb);
              col[d] = head ? val : col[d] + val;
            }
          }
          head = false;
        }
#pragma unroll
        for (int d = 0; d < kColRows; ++d) {
          if (d0 + d < dl) {
            if (code & 1) {
              dp[(d0 + d) * wc] += col[d];
            } else {
              dp[(d0 + d) * wc] = col[d];
            }
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
        T jb[kHeldRows];
        load_column(sp, n, s, rq, jb);
        const T gq = sp[n * s + rq];
        T* row = a.rows + static_cast<long long>(c.x) * nab;
        int at = q.b;  // a_rr entry (p, q): row p starts at p dr - p (p - 1) / 2
        for (int p = 0; p <= q.b; ++p) {
          row[at] = pair_value<WIDE_N>(sp, n, s, camera_row(p, e_start, dl), rq, jb, gq);
          at += dr - p - 1;
        }
        row[dr * (dr + 1) / 2 + q.b] = gq * sp[(n + 1) * s];
      }
    }
    // h_ll and g_l, 32 entries a chunk, after the W and camera phases (their
    // lists are dead here): each lane its own slot's term, the group's by a
    // fixed butterfly, into the chunk's sums.  At dl <= kColRows (at most
    // 27 entries, one chunk) the sums stay over the rounds and go out once
    // after the last; past it each chunk goes out every round, stored on the
    // first round (B1/B8) and added on the later ones, so over the rounds in
    // round order.  Only a warp of one landmark (G = 32) takes more than one
    // round.
    int e1 = 0, e2 = 0;  // the h_ll entry (e1, e2) of the loop
    for (int t0 = 0; t0 < nh; t0 += 32) {
      const int nt = min(32, nh - t0);
      for (int u = 0; u < nt; ++u) {
        const bool is_g = t0 + u >= nhp;
        T c = T(0);
        if (has) {
          const T* g = own + n * s;
          if (is_g) {
            c = g[e_start + t0 + u - nhp] * g[s];
          } else {
            T jb[kHeldRows];
            load_column(own, n, s, e_start + e2, jb);
            c = pair_value<WIDE_N>(own, n, s, e_start + e1, e_start + e2, jb, g[e_start + e2]);
          }
        }
        for (int off = G >> 1; off; off >>= 1) c += __shfl_xor_sync(kFull, c, off);
        if (live && j == 0) hsum[u * 32 + grp] = one_chunk && r > 0 ? hsum[u * 32 + grp] + c : c;
        if (lane == 0)
          tcode[u] = is_g ? static_cast<unsigned>(t0 + u - nhp) | 0xffff0000u
                          : static_cast<unsigned>(e1) | static_cast<unsigned>(e2) << 16;
        if (!is_g && ++e2 == dl) e2 = ++e1;
      }
      if constexpr (!one_chunk) {
        __syncwarp();
        write_hg(a.h_ll, a.g_l, tcode, hsum, nt, n_l, lane, l_first, lt, dl, ACCUM || r > 0);
        __syncwarp();  // the chunk's sums are read before the next chunk
      }
    }
    __syncwarp();  // the stage and the lists are read before the next round
  }
  if constexpr (one_chunk) {
    __syncwarp();
    write_hg(a.h_ll, a.g_l, tcode, hsum, nh, n_l, lane, l_first, lt, dl, ACCUM);
  }
}

// The any-shape instance's launch, its attribute opted in at kSmemLimit,
// the largest plan, on the first launch on each device, so that no plan
// launches under a smaller one.
template <typename T, bool ACCUM, bool CAM, bool TABLE, bool WIDE_N, bool WIDE_DL>
int launch_any(const AsmArgs<T>& args, int n_warps, cudaStream_t st) {
  static unsigned long long configured = 0;  // devices whose attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !((configured >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(assemble_any_kernel<T, ACCUM, CAM, TABLE, WIDE_N, WIDE_DL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) configured |= 1ull << dev;
  }
  const int warps = any_warps<T>(args.n, args.dr, args.dl);
  const int blocks = (n_warps + warps - 1) / warps;
  assemble_any_kernel<T, ACCUM, CAM, TABLE, WIDE_N, WIDE_DL>
      <<<blocks, warps * 32, any_bytes<T>(args.n, args.dr, args.dl), st>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// One launch over n_warps warp items: the unrolled instance of the two
// hot shapes (the pinhole and the Snavely camera with a point), else the
// any-shape instance at any shape whose warp region fits a block's shared
// memory (any_warps >= 1), its warps a block from the plan.
template <typename T, bool ACCUM, bool CAM, bool TABLE>
int launch(AsmArgs<T>& args, int n, int s, int dr_s, int dl, int n_warps, void* stream) {
  if (n < 1 || dr_s < 1 || dl < 1 || s != dr_s + dl || any_warps<T>(n, dr_s, dl) < 1)
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
  if (n > kHeldRows) {
    return dl > kColRows ? launch_any<T, ACCUM, CAM, TABLE, true, true>(args, n_warps, st)
                         : launch_any<T, ACCUM, CAM, TABLE, true, false>(args, n_warps, st);
  }
  return dl > kColRows ? launch_any<T, ACCUM, CAM, TABLE, false, true>(args, n_warps, st)
                       : launch_any<T, ACCUM, CAM, TABLE, false, false>(args, n_warps, st);
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

// Its warps a block (0: the shape does not fit).
int fused_obs_any_warps(int n, int dr_s, int dl, int f64) {
  return f64 ? any_warps<double>(n, dr_s, dl) : any_warps<float>(n, dr_s, dl);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
