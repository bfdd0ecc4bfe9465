"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each or more; any failure raises and exits non-zero:

1. device  — the card's name and power limit (``nvidia-smi``); no CUDA
   device is a failure.
2. build   — one LM iteration of a small pinhole problem through
   ``nt.optimize``, whose ``compile_problem`` compiles the port's CUDA
   kernels (``nllstpu_torch/ops/csrc``) with nvcc, one process per source,
   into ``.torch_ext/``: the build must fall in ``Result.time_init``, before
   the loop's budget clock.  Each kernel's registers and spill from nvcc's
   ``-Xptxas -v`` report (``_build.resources``); the any-shape instance of
   B1/B2/B8 must spill nothing in either float type (24 instances: B1, B2
   and B8, each with and without its WIDE_N and WIDE_DL paths).
3. B1      — kernel ``fused_obs_all`` (with kernel B6 over its per-slot
   camera rows, which the wrapper launches) against its plain PyTorch
   version on the pinhole bench problem's own inputs (128 cameras, 8192
   landmarks, run length 14) and on a small case with duplicate cameras
   and dustbin slots; two launches must give the same bits.
4. B2      — kernel ``fused_obs_all_into`` against its plain version on
   the whole batch of the two Snavely BAL problems (Ladybug-49 and
   bench-realistic, whose plan starts with a chunk bucket that the next
   bucket covers again; one launch takes each landmark's slots from every
   bucket): one whole assembly into zeroed buffers, then B6 over the
   camera runs (its plain version for the plain side); the host seconds of
   the compile-time tables.
5. B3      — kernel ``reduce_s_damped`` against its plain version on the
   systems of the pinhole bench (wc = 768), Ladybug-49 (wc = 441) and
   bench-realistic (wc = 1152), each over its compile-time row tables
   (``schur_info.w_rows``), and on a synthetic W of 128 blocks of 9 zero
   outside a random structure, λ ∈ {0, 1e-2}; two launches must give the
   same bits and s_sum must be exactly symmetric; beside each main-path
   shape its time, the structural bound (W's held blocks, the landmarks'
   inputs, the incidence list and the outputs: ``struct_work``) and the
   dense product's, the plain version's time and cuBLAS's dense
   ``Yᵀ W`` product alone (the one PyTorch call of the plain version that
   forms S).
6. main paths — Levenberg-Marquardt through ``nt.optimize`` (its graph
   driver: CUDA graphs of the assembly, the damped trial and the PCG's
   chunks, whose replays add to the launch counts what their captures
   counted) in float32 for 30 iterations, each with the launch counts set
   to 0 just before and read just after: the pinhole bench problem (B1, B6 and B3), Ladybug-49
   and bench-realistic (B2, B6 and B3, no B1), each checked against the
   JAX package's CPU float32 reference costs (constants below).
7. B6      — kernel ``segment_block_sum`` against its plain version on
   the real inputs of the two implicit problems, of phase 20's paths, (every D the path uses:
   3 for Wᵀv, 9 for W u, 12 for h_ll + g_l, 54 for a_rr + b_r and 81 for
   the preconditioner's correction, over landmark and camera runs,
   recorded from one assembly and one damped solve), of the adaptive
   direct problem (21 over landmark runs: h_ll, g_l and the kernel–point
   cross; 81 over camera runs: a_rr, b_r and the kernel–camera cross), of
   the per-cost problem through ``solver="schur"`` (9: b_r, 81: a_rr, 12:
   h_ll + g_l of the observations and the priors) and ``solver="schur_cg"``
   (also 3 for Wᵀv, 9 for W u, 81 for the preconditioner's correction) and
   of the camera side of B1 and B2 (27 on the pinhole bench, 54 on
   Ladybug-49 and bench-realistic: the per-slot camera rows, made here by
   B2's plain version), and on a synthetic case with empty runs and one
   run of 100,000 rows; two launches must give the same bits on every
   input; beside each main-path shape its time, its byte bound and the
   time of ``torch.segment_reduce``, one PyTorch call for the same
   function, each also replayed from a CUDA graph (the device's time
   without the host's rate of launching).
8. implicit main paths — LM through ``nt.optimize`` in float32 with
   ``linear_tol=1e-2``: bench-realistic through ``solver="schur_cg"`` (30
   iterations), and a Dubrovnik-356-class problem (356 cameras, 226,730
   points, 1,253,547 observations) through ``solver="schur"``, whose dense
   W (~8.7 GB) passes the 4 GiB limit so that the compile switches to the
   implicit backend; each launches B6 and never B1, B2 or B3, and meets
   the JAX package's CPU float32 start and best cost (constants below).
   The Dubrovnik-class run prints the peak device memory.
9. B7 and B5 — kernels ``place_w`` and ``reduce_s`` against their plain
   versions on the inputs the adaptive main path, the per-cost path and
   phase 20's two direct paths give them (recorded from one assembly and one damped solve: W [8192, 3,
   1155] and [7773, 3, 432], and their column-block structures), B7 also
   on a synthetic case with empty runs,
   repeated cameras, dropped costs and a row past 48 KB of shared memory,
   B5 also at dl = 5 on a synthetic W that is zero outside a random block
   structure; two B5 launches must give the same bits and s_sum must be
   exactly symmetric (B5 is B4's instance of one body); beside each
   main-path shape its time, its bound (B5: the structural one, the dense
   product's beside it), the plain version's time and, for B7,
   ``index_add_`` into a zeroed W, alone and with the zero fill
   (``torch.zeros`` + ``index_add_``, B7's output), for B5 cuBLAS's dense
   ``Yᵀ W`` product.
10. B8 and B4 — kernel ``fused_obs_leg`` against its plain version on the
   inputs of both dual-sorted paths (one assembly's obs-major tiles of the
   gauge-fixed float64 problem and of the float32 pinhole bench problem)
   and on a small case with duplicate cameras and dustbin slots, beside
   its time B1's on the same inputs; kernel ``reduce_s_lm`` against its
   plain version over each system's row tables: the gauge-fixed path's
   input (float64, wc = 756, recorded from one damped solve), the pinhole
   bench system (float32 and float64, wc = 768) and dl = 5 on a synthetic
   W of 80 blocks of 5 (wc = 400), two launches giving the same bits and
   an exactly symmetric s_sum; beside the main path's shape B3's figures
   (cuBLAS: DGEMM), and the float64 solve's reduction as it runs
   (``damped_inverse`` then B4).  Then the determinism gates: two
   assemblies must give the same bits in all five outputs through B1 (the
   pinhole bench), through B2 (Ladybug-49 and bench-realistic) and
   through each dual-sorted path, and two float32 LM runs of the pinhole
   bench must give the same cost trace through B1 and through the
   dual-sorted route.
11. adaptive main path — LM through ``nt.optimize`` in float32 for 60
   iterations on bench-realistic with 10% of its observations moved by 50
   pixels, one shared ContaminatedGaussian kernel
   (``make_bal_problem(data, kernel=..., kernel_params=...)``) and the
   points perturbed by 0.01: the generic direct assembly through B6 and
   B7 and the solve through B5, never B1, B2 or B3.  Its cost is ½Σρ with
   ρ = −log of a mixture density, negative once σ1 nears the noise: the
   gate holds the start cost within 1e-4 of |reference| and the best cost
   below reference + 1e-2·|reference|, and the recovered (σ1, σ2, w)
   against the JAX package's CPU float32 run (constants below).
12. dual-sorted main paths — LM through ``nt.optimize(..., w_impl="fused")``:
   the pinhole bench problem in float64 with its first two cameras fixed
   (``unfixed=cams[2:] + lmks``), B8 and B4 and never B1–B3 or B5–B7,
   held to the JAX package's CPU float64 trace (start cost 1e-12, the
   iterations both runs made and the best cost 1e-9, constants below); and
   in float32 with every variable free, B8 and B3 (never B6), held to the pinhole
   reference as the B1 path is.
13. drivers — the graph driver against the stepped driver
   (``callback=nt.null_callback``) on the pinhole bench (float32), the
   gauge-fixed float64 path and Ladybug-49, 30 iterations: the same
   iterations and damped solves, each iteration's cost within 1e-6
   (float32) or 1e-12 (float64) relative, and whether the bits held; two
   graph-driver runs of the pinhole bench give one trace.
14. timed loops — 10 iterations of the pinhole (through B1 and through
   the dual-sorted route), gauge-fixed, Ladybug-49, bench-realistic
   implicit and adaptive bench-realistic loops, through the graph driver,
   the stepped driver and the plain versions (``run_loop``), once each, with
   each loop's peak device memory and the graph driver's warm-up and
   capture seconds; once more of each with CUDA events around every phase
   (the graph driver's: around every replay; the implicit loops also print
   PCG iterations per damped solve and the time of one reduced matvec),
   and each driver once under ``torch.profiler`` (device busy time, idle
   share, the host's launches per iteration); the Dubrovnik-class loop
   through both drivers, with and without phase events, and profiled.
   The cost reaches the float32 floor early; later iterations spend a
   varying number of damped trials on rounding noise, so compare per-call
   phase times, not single-run rates.
15. Newton, dogleg and gradient descent — through ``nt.optimize`` (the
   graph driver), launch counts set to 0 just before and read just after,
   against the JAX package's CPU runs (``ITER_REF``, written by
   ``scripts_torch/iterator_reference.py``): Newton on the gauge-fixed
   float64 path (B8 and B4 at λ = 0; the float64 trace gate) and on the
   gauge-fixed pinhole bench in float32 through B1 (B1, B6, B3 at λ = 0;
   start within 1e-4, best ≤ reference + 1e-3·|reference|); dogleg on the
   gauge-fixed float64 path (trace gate), the free pinhole bench in
   float32 (B1, B6, B3) and bench-realistic through ``schur_cg`` with
   ``linear_tol=1e-2`` (B6 only, slack 1e-2); gradient descent on the
   free pinhole bench in float32 (B1 and B6, never B3 or B4; its cost
   never above its best).  Each path prints how many of its λ = 0 solves
   fell to LU and how many it took non-finite.
16. dense backend — Rosenbrock through the four iterators (to (1, 1)),
   ``make_curve_fit`` under each fixed kernel (LM, float64, best within
   1e-9 of the JAX CPU run's), and the parking-garage-sized pose graph
   (1,661 SE(3) poses, 6,275 edges, d = 9,960; LM and dogleg in float64,
   the trace gate); the assembly's sums through B6 (D = 1), which is held
   against its plain version on that input and timed beside
   ``torch.segment_reduce``.  Then the determinism gates (two dense
   assemblies of the pose graph give the same bits; a second graph-driver
   run of the pose graph and of the float32 dogleg pinhole bench gives one
   trace), the drivers gates of the new iterators (graph against stepped
   on the gauge-fixed float64 path and the pinhole bench in float32,
   Newton's gauge-fixed), and the pose graph's Cholesky against its bound
   (d³/3 at the float64 peak), LU, assembly and cost times and peak memory.
17. timed loops of this slice's paths — as 14, with each loop's iterator
   named, and the stepped driver's phase events (assembly, solve, cost).
18. cg backend — the parking-garage-sized pose graph through
   ``solver="cg"`` (the matrix-free PCG, tolerance 1e-14 in float64), LM
   and dogleg through ``nt.optimize``, launch counts set to 0 just before
   and read just after (B6 and no other kernel), held to the JAX
   package's CPU ``"cg"`` runs (the trace gate) and to the dense route's
   best cost within 1e-9; a second graph-driver run, two assemblies and
   two matvecs give the same bits; B6 against its plain version and
   ``torch.segment_reduce`` on the matvec's input (D = 6) and the
   block-Jacobi blocks' (D = 36), recorded from one assembly and one
   matvec; then the loops timed as in 17 (PCG iterations per solve, one
   matvec's time, the PCG chunk's replay time, peak device memory) and
   profiled.
19. generic Schur main paths — LM through ``nt.optimize``, launch counts
   set to 0 just before and read just after, then once more through the
   graph driver and once through the stepped driver: Ladybug-49 in the
   per-cost form (``make_bal_problem(..., batched=False)``: 34,619
   observations, autodiff Jacobians, float64) with a prior batch on every
   25th point, the first camera and three points fixed, through
   ``solver="schur"`` (the generic route: B5, B6 and B7, never B1–B4 or
   B8) and ``solver="schur_cg"`` with ``linear_tol=1e-8`` (B6 only), each
   held to the JAX package's CPU float64 trace (the trace gate, at
   ``rel_dcost=1e-6``) through both drivers, the implicit one also to its
   PCG iterations per solve within ±1, a second graph-driver run to the
   first one's bits; bench-realistic in float32 with riders (a prior batch
   on every camera and one on every 100th free point) and its 81 lowest-id
   points fixed (the extras region), the obs-major route (B2, B6 and B3,
   never B1, B5 or B7), held to the JAX package's CPU float32 start and
   best cost (slack 1e-2) through both drivers.  Their loops are timed and
   profiled as in 17.
20. adaptive kernels on every backend and batch form, and cluster-Jacobi —
   LM through ``nt.optimize``, launch counts set to 0 just before and read
   just after, each path then profiled (10 iterations: rate and idle
   share), against the JAX package's CPU runs (``ADAPTIVE_REFS``): the
   Dubrovnik-class data (1,253,547 observations) with 10% outliers and one
   shared ContaminatedGaussian through ``schur_cg`` in float32 (B6 only;
   the start cost against the JAX package's CPU float32 run, the first two
   iterations' costs within 1e-4 of its float64 run, (σ1, σ2, w) printed
   beside it, peak memory); adaptive bench-realistic
   through ``schur_cg`` (B6 only; 60 iterations, start and best cost and
   (σ1, σ2, w), printed beside the direct path's); Ladybug-49 with
   outliers in float64, one shared kernel in the per-cost form through
   ``schur`` (the generic route: B5, B6, B7, never B1–B4 or B8) and
   ``schur_cg`` (B6; PCG iterations per solve within ±1 of the JAX
   package's where its own count holds under a one-ulp change of its
   start), and one kernel per camera (49 kernel variables)
   through ``schur`` (B5, B6, B7), each held to the float64 trace gate;
   the pinhole bench through ``schur_cg`` with cluster-Jacobi (four cameras
   per cluster; B6 only; the pinhole reference), its PCG iterations per
   solve beside Schur-Jacobi's; tests/test_adaptive.py's two-mean mixture
   through ``dense`` and ``cg`` (B6 only; the trace gate and (σ1, σ2, w)
   within 0.12 of (1, 10, 0.8)).  B6 (phase 7) and B7/B5 (phase 9) are
   also held to their plain versions on these paths' inputs.
21. alternation, views, cache — each run with the launch counts set to 0 just before and
   read just after: ``optimize_singles(targets=PT)`` in float32, the points
   perturbed by 0.01: Dubrovnik-class with LM (226,730 points at once) and
   bench-realistic with Newton, each through B6 alone (its plain version
   never runs), the final cost (float64 at the final values) and the
   summed iterations within the JAX package's own spread under a one-ulp
   change of its start (``SINGLES_REF``; Dubrovnik-class's sum within that
   spread of the port's own CPU runs, its gap to the JAX runs printed);
   wall time, iterations per second summed over the points and memory
   above the process printed.
   ``SubproblemView(solver="schur")`` on the pinhole bench (B1, B3, B6) and
   bench-realistic (B2, B3, B6): the first half of the points, the second,
   the first again, one capture throughout, each swap's best cost against
   a fresh subproblem optimized on the card (``VIEW_FRESH_TOL``: 1e-5, and
   1e-3 at bench-realistic's float32 floor) and the JAX package's CPU runs
   (``VIEW_REF``; 1e-5, or the JAX runs' own spread where wider),
   ``view.cost()`` against the subproblem's cost.  The
   runner cache: a second ``nt.optimize`` on the pinhole bench compiles and
   captures nothing, its ``time_init`` under a tenth of the first's, its
   trace a fresh run's, and the device memory back within 64 MiB once the
   problem is gone.  ``hessian_coo`` summed against ``hessian_dense`` on
   the pose graph, a checkpoint round trip bit for bit, and ``write_bal``
   then ``load_bal`` of bench-realistic through the native parser.  B6 is
   held to its plain version and timed on the per-target sums' inputs
   (D = 13 and 1) and the bench-realistic view's camera runs.
22. sharded (run right after the build) — two rank processes, started by
   ``spawn`` and joined by ``torch.distributed`` (``nccl`` with a card per
   rank; on one card both ranks on ``cuda:0`` over ``gloo``, which stages
   every ``all_reduce`` through the host), each loading the library that
   the build made, run four paths through
   ``nllstpu_torch.parallel.optimize_sharded``, the launch counts set to 0
   just before and read just after: the pinhole bench (B1, B6, B3 per
   rank), bench-realistic (strided ownership; B2, B6, B3), the gauge-fixed
   float64 pinhole bench (B1, B6, B4) and Dubrovnik-class through the
   implicit solve (B6; 3 iterations).  Each rank's shard is measured first
   (one local assembly): h_ll and W hold its Lc landmark slots, 1/n of the
   landmarks up to the pad, never the global W.  Then each rank's kernels
   are held to their plain versions on its shard, both against a float64
   plain shard of the same inputs: the local assembly (B1 or B2, B6), the
   reduction at λ = 0 and 1e-2 (B3 or B4, S summed over the ranks) or the
   implicit solve's PCG pieces (B6); on bench-realistic B2 over the local
   bucket plan is checked on each rank and timed on rank 0 (its row in
   the kernels line).  Gates: both ranks end
   with the same bits; the JAX constants of phases 6 and 12 and the
   one-rank port runs (``nt.optimize``) in this smoke (best cost 1e-4; the
   float64 trace 1e-9; Dubrovnik-class 1e-3, finite; its PCG iterations:
   one damped solve ±1 of one card's, a run's within 2 of one card's range
   under a one-ulp change of the start).  Per path and rank:
   it/s, the time inside the collectives (CUDA events around each), the
   shard's bytes against the one-card system's, peak memory above the
   process, launches.
23. shapes (run right after the sharded phase) — the obs-major shapes past
   the two unrolled instances, ``scripts_torch/shapes_reference.py``'s
   problems at full width, each run with the launch counts set to 0 just
   before and read just after: the planar problem (affine cameras of 6
   dof, landmarks of 2; 128 cameras, 8192 landmarks, 104,858
   observations) in float32 (B1 at (2, 6, 2), B6, B3 at dl = 2; never B2,
   B4, B5, B7, B8), through ``w_impl="fused"`` (B8 and B3, nothing else)
   and in float64 (B1, B6 and B4 at dl = 2; the float64 trace gate against
   the JAX package's CPU run, ``SHAPES_REF``), and the stereo problem
   (bench-realistic with a right camera's u: B2 at (3, 9, 3), B6, B3; the
   bucketed slack 1e-2).  Then each kernel against its plain version,
   float64 within 1e-12 and float32 within 1e-5 of the largest entry (B3:
   float32 only, within 1e-5 unscaled and the scaled rule of phase 5), two
   launches the same bits, and timed: B1 and B8 on the planar path's tile
   and on bench-sized tiles at (3, 6, 3) and (3, 9, 3) (the planar tile
   and (3, 9, 3) in float64 too); B2 on the stereo path's batch and on
   random values over its observation pattern at (2, 6, 2), (3, 6, 3) and
   (3, 9, 3) (the last in float64); B3 on the planar system (dl = 2) and a
   synthetic dl = 1 structure; B4 on the float64 planar system (dl = 2,
   its inverses as the float64 solve forms them); B4 and B5 at dl = 7 and
   16 on synthetic structures, through their tiled instance.  Each row's
   launches are those of the main path it names (B5's: the adaptive main
   path, phase 11).
24. anydl (run right after the shapes phase) — the direct solve past the
   unrolled dl ≤ 6 and the assembly past the old caps of B1/B2/B8 (n ≤ 4,
   dr_s ≤ 16, dl ≤ 6): trajectory-space NRSfM
   (``scripts_torch/anydl_reference.py``: 128 frames of 6 dof, 8192 points
   of K DCT coefficients per axis, dl = 3K, 104,858 observations, W [8192,
   3K, 768]), each run with the launch counts set to 0 just before and
   read just after and the plain versions of B1, B2, B8, B4 and B5
   refused: through the obs-major route, float32 at K = 3 and 6 (B1 at
   (2, 6, 3K), B6, the damped inverses, B4; the JAX package's CPU start
   within 1e-4 and its best cost + 1e-3, ``ANYDL_REF``) and float64 at
   K = 6 (the float64 trace gate); through ``w_impl="fused"`` at K = 3 (B8
   and B4, nothing else; K = 3's reference); and its adaptive form at
   K = 3 (10% of the measurements moved by 50 pixels, one shared
   ContaminatedGaussian, started as the adaptive main path, phase 11)
   through the generic route (B6, B7, B5's tiled instance; the JAX
   package's CPU float32 start and best cost + 1e-2, its (σ1, σ2, w)
   printed beside).  Then, each against its plain version (float64 within
   1e-12, float32 within 1e-5 of the largest entry, two launches the same
   bits) and timed in both float types beside its bound: B1 and B8 on the
   obs-major paths' own tiles (2, 6, 9) and (2, 6, 18) and on bench-sized
   tiles at (5, 6, 3) and (2, 17, 3); B2 on random values over
   bench-realistic's observation pattern at those four shapes; B4 on the
   float32 obs-major paths' own reductions (dl 9 and 18, their inverses
   formed in float64); B5's tiled instance on a synthetic dl = 33
   structure (s_sum exactly symmetric; timed beside cuBLAS's ``Yᵀ W`` and
   the structural bound; the adaptive path's own reduction cancels, so
   that two summation orders part by ~1e-10 of its largest entry);
   and B7 on rows past a block's shared memory (a float64 row of 233,280
   bytes, built in column spans; timed in float64).  The rows of B1 and
   B8 give the launches of the K = 3 paths (obs-major and dual-sorted;
   K = 6's own tiles those of K = 6), B2's those of phase 23's stereo
   path, B5's and B7's those of the adaptive form.

Tolerances: each kernel is compared with its plain version run in float64
on the same inputs.  The float64 instance of a kernel must agree to 1e-10
of the largest entry (the arithmetic is the same, only the summation order
differs); the float32 instance to 1e-5 for B1 and B2 (float32 sums of up
to a few thousand terms per camera through B6, in a fixed order).  B3's
float32 outputs are compared after scaling by the float64 reference's
diagonal (D S D and D rhs with D = diag(S)^-½, and each h_inv
block by its own diagonal), so that the small blocks of S, whose diagonal
spans seven decades on the BAL problems, are held as tightly as the
largest.  Each output is held to 1e-4, or to ten times the plain
version's own float32 error on that same output where that is larger (a
float32 closed-form inverse of an ill-conditioned 3x3 block loses digits
in either version).  B6 sums each run in a fixed order: float64 within
1e-10 and float32 within 1e-5 of the largest entry.  B7 adds at most a
few values per entry, in run order: float64 within 1e-12 and float32
within 1e-6 of the largest entry, and two launches give the same bits.
B5: float64 within 1e-12 of the largest entry; float32 within 1e-6, or
ten times the plain version's own float32 error where that is larger.
B8 is held as B1; B4 within 1e-12 of the largest entry in float64 and
1e-6 in float32.  No kernel uses atomics: every kernel must give the same
bits on a second launch, B3 and B4 an exactly symmetric s_sum, and the
assembled systems the same bits on a second assembly.
Every row but B7's also carries ``graph_ms``: the same calls
replayed from one CUDA graph, the device's time without the host's rate
of launching them.  The last lines are the card's name and power limit, a
JSON record of the kernels (one row per kernel and main-path shape, with
that path's launches) and the device JSON.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import json
import subprocess
import time
import types

import torch

NCAM, NLMK, VIS, NOISE, ITERS = 128, 8192, 0.1, 1e-3, 30
TIMED_ITERS = 10
WIDE_L = 8192  # landmarks of the random wc = 1152 reduction case
# The JAX package on the CPU in float32 (scripts/cpu_ref.json).
REF_START_COST = 67.33655548
REF_BEST_COST = 0.0920996218919754
#: Snavely BAL problems: ``make_realistic_bal`` arguments, then the JAX
#: package's CPU float32 start and best cost after 30 LM iterations, from
#: ``JAX_PLATFORMS=cpu NLLSTPU_PLATFORM=cpu python scripts/bal_realistic.py
#: {ladybug|bench} direct 30``, and the slack allowed on the best cost.
#: bench-realistic's reference still falls ~1e-4 relative per iteration at
#: iteration 30, so rounding may leave the port a step behind: its slack is
#: 1e-2.
BAL = {
    "Ladybug-49": (
        dict(ncameras=49, npoints=7776, seed=1, noise=1e-3, track_alpha=2.3),
        375133.9375, 0.022988244891166687, 1e-3,
    ),
    "bench-realistic": (
        dict(ncameras=128, npoints=8192, seed=1, noise=1e-3, track_alpha=1.6,
             max_track=96),
        937386.25, 0.07579956948757172, 1e-2,
    ),
}
#: Implicit backend, ``linear_tol=1e-2``: ``make_realistic_bal``
#: arguments, the solver asked for, the JAX package's CPU float32 start and
#: best cost after 30 LM iterations, and the slack on the best cost.
#: bench-realistic: ``JAX_PLATFORMS=cpu NLLSTPU_PLATFORM=cpu python
#: scripts/bal_realistic.py bench implicit 30`` (it stops after 25
#: iterations on a small step).  Dubrovnik-class: the JAX package's
#: ``nt.optimize`` on the same perturbed problem with ``solver="schur"``
#: (auto-switched to implicit), the options of ``implicit_options`` and
#: ``store_trajectory=True``, in float32 on the CPU (the command is in
#: PERF.md).
IMPLICIT = {
    "bench-realistic implicit": (
        BAL["bench-realistic"][0], "schur_cg", 937386.25, 0.07557877153158188, 1e-2,
    ),
    "Dubrovnik-class": (
        dict(ncameras=356, npoints=226730, seed=1, noise=1e-3, track_alpha=2.0),
        "schur", 13210936.0, 0.9113152027130127, 1e-2,
    ),
}
#: Adaptive bench-realistic: bench-realistic's data with 10% of its
#: observations moved by 50 pixels, one shared ContaminatedGaussian kernel,
#: the points perturbed by 0.01, 60 LM iterations; the JAX package's CPU
#: float32 start and best cost and recovered (σ1, σ2, w) (it stops after
#: 59 iterations on a small step; command in PERF.md), and the relative
#: tolerance of each parameter.  σ2 (the outliers' width) and w are
#: weakly determined at the float32 floor: the JAX run itself, its inputs
#: scaled by 1 − 1e-7, 1 + 1e-7 or 1 + 2e-7, gives σ2 67.57–69.28 and w
#: 0.881–0.894 (2.2% and 1.1% from the constants); σ1 stays within 0.2%.
ADAPTIVE = "adaptive bench-realistic"
ADAPTIVE_ITERS = 60
ADAPTIVE_REF = dict(
    start=152114.40625, best=-207109.46875,
    sigmas_weight=(0.0012996768346056342, 69.10763549804688, 0.8913242220878601),
    tol=(1e-2, 5e-2, 5e-2),
)
#: The dual-sorted paths (``w_impl="fused"``: kernel B8 and the
#: camera-major leg): the pinhole bench problem in float64 with its first
#: two cameras fixed (BA's gauge removed; the solve through B4), and the
#: same problem in float32 with every variable free (the solve through
#: B3), by dtype and number of fixed cameras.
GAUGE = "gauge-fixed pinhole f64"
B4_SYNTHETIC = "dl=5 synthetic structure"
FUSED = "pinhole bench fused"
DUAL = {GAUGE: (torch.float64, 2), FUSED: (torch.float32, 0)}
#: The JAX package's CPU float64 run of the gauge-fixed problem through its
#: default direct path (``JAX_PLATFORMS=cpu python
#: scripts_torch/gauge_fixed_reference.py``): start cost, the cost after each
#: iteration and the best cost.  It stops after 9 iterations on the step
#: threshold (1e-12) at the float64 rounding floor, so the gate compares the
#: iterations both runs made, at least the 8 before that floor.
GAUGE_REF = dict(
    start=67.33655986736173,
    costs=(0.14520334765711815, 0.09210745183726589, 0.09210129529273842,
           0.09210109263701328, 0.09210109187234562, 0.0921010918722942,
           0.0921010918722942, 0.09210109187229418, 0.09210109187229419),
    best=0.09210109187229418,
)
#: The other iterators and the dense backend: the JAX package's CPU runs
#: (``JAX_PLATFORMS=cpu python scripts_torch/iterator_reference.py``):
#: start cost, the cost after every iteration (the float64 traces), best
#: cost.  The bench paths run ``bench_options`` with the iterator; the
#: gauge-fixed ones fix the first two cameras; ``dogleg_implicit`` is
#: bench-realistic through ``schur_cg`` with ``linear_tol=1e-2``; the pose
#: graphs 20 iterations with ``rel_dcost=1e-12`` (``posegraph_options``),
#: through "dense" and through "cg" (``posegraph_cg_*``).
#: Inside the JAX runs, no Cholesky fell to LU and no solve came out
#: non-finite, but on ``dogleg_f32``, whose 25 Newton legs (free gauge,
#: float32) all fell to LU, finite.
ITER_REF = {
    "newton_gauge_f64": dict(
        start=67.33655986736173, best=0.09210109187229415,
        costs=(0.13981437158415166, 0.09210201563989999, 0.09210109187404446,
               0.09210109187229441, 0.09210109187229415, 0.09210109187229418,
               0.09210109187229416, 0.0921010918722942)),
    "newton_gauge_f32": dict(start=67.33655548095703, best=0.0921010822057724),
    "dogleg_gauge_f64": dict(
        start=67.33655986736173, best=0.09210109187229415,
        costs=(66.1303135227357, 60.886893852440316, 48.26495663608343, 19.196437261040124,
               0.09622757962995243, 0.09210109744629769, 0.09210109187243593,
               0.09210109187229419, 0.09210109187229416, 0.09210109187229415,
               0.09210109187229419)),
    "dogleg_f32": dict(start=67.33655548095703, best=0.092099629342556),
    "gd_f32": dict(start=67.33655548095703, best=48.235252380371094),
    "dogleg_implicit": dict(start=937386.0, best=0.07560078054666519),
    "posegraph_lm": dict(
        start=116.01294325641327, best=1.3664886384424852,
        costs=(1.5316449844310265, 1.3664905737019573, 1.366488638501362,
               1.3664886384424881, 1.3664886384424852)),
    "posegraph_dogleg": dict(
        start=116.01294325641327, best=1.3664886384424857,
        costs=(27.732453835470196, 1.3810452048160364, 1.3664888056786404,
               1.3664886384484565, 1.3664886384424861, 1.3664886384424857)),
    "posegraph_cg_lm": dict(
        start=116.01294325641327, best=1.3664886384424857,
        costs=(1.5316449844310263, 1.3664905737019577, 1.366488638501362,
               1.3664886384424884, 1.3664886384424857)),
    "posegraph_cg_dogleg": dict(
        start=116.01294325641327, best=1.3664886384424857,
        costs=(27.732453835470192, 1.3810452048160364, 1.3664888056786402,
               1.3664886384484565, 1.3664886384424864, 1.3664886384424857)),
}
#: The generic Schur assembly's main paths, and the JAX package's CPU runs
#: of them (``JAX_PLATFORMS=cpu python scripts_torch/iterator_reference.py
#: ladybug_percost_lm ladybug_percost_cg bench_riders_f32``, ~2 min):
#: Ladybug-49 in the per-cost form (autodiff Jacobians, float64) with a
#: prior batch on every 25th point, the first camera and three points
#: fixed, LM with ``rel_dcost=1e-6`` through ``solver="schur"`` (the
#: generic route: B6, B7, B5) and ``solver="schur_cg"`` with
#: ``linear_tol=1e-8`` (B6; the PCG iterations of every damped solve);
#: bench-realistic in float32 with riders (a prior batch on every camera and
#: one on every 100th free point) and its 81 lowest-id points fixed, the
#: obs-major route (B2, B6, B3), the bench options.
PERCOST = "Ladybug-49 per-cost"
PERCOST_CG = "Ladybug-49 per-cost implicit"
RIDERS = "bench-realistic with riders"
GENERIC_REF = {
    PERCOST: dict(
        start=373994.9043413996, best=0.02297439421572495,
        costs=(1036.8302741812097, 70.34228151350952, 4.708976156073184, 0.16573947703244557,
               0.025093875823566286, 0.022980769577354666, 0.02297490991588189,
               0.022974428128800052, 0.02297439425988378, 0.02297439421572495)),
    PERCOST_CG: dict(
        start=373994.9043413996, best=0.022974394215725717,
        costs=(1036.8302741642515, 70.34228151412424, 4.70897615617682, 0.16573947703611303,
               0.02509387582346318, 0.022980769577337568, 0.02297490991587845,
               0.022974428128802883, 0.022974394259881473, 0.022974394215725717),
        pcg_iters=(45, 68, 77, 77, 76, 76, 85, 92, 89, 88)),
    RIDERS: dict(start=946645.25, best=0.0758107602596283),
}
#: This slice's adaptive paths: adaptive kernels on every backend and batch
#: form, and cluster-Jacobi.  The JAX package's CPU runs of them:
#: ``JAX_PLATFORMS=cpu python scripts_torch/iterator_reference.py
#: adaptive_dubrovnik_implicit adaptive_dubrovnik_implicit_f64
#: adaptive_bench_implicit ladybug_adaptive_lm ladybug_adaptive_cg
#: ladybug_per_camera_lm mixture_dense mixture_cg`` (~2.5 min; the
#: Dubrovnik-class cases hold ~6 and ~12 GiB): start cost, the costs of every
#: iteration, best cost, the recovered (σ1, σ2, w) (of the first three
#: kernels on the per-camera path) and the implicit paths' PCG iterations.
ADAPTIVE_BIG = "adaptive Dubrovnik-class implicit"
ADAPTIVE_IMPLICIT = "adaptive bench-realistic implicit"
ADAPTIVE_PERCOST = "Ladybug-49 adaptive per-cost"
ADAPTIVE_PERCOST_CG = "Ladybug-49 adaptive per-cost implicit"
PER_CAMERA = "Ladybug-49 per-camera kernels"
CLUSTER = "pinhole bench cluster-Jacobi"
MIXTURE = "two-mean mixture"
#: LM iterations of the adaptive Dubrovnik-class path (the JAX CPU runs':
#: ``DUBROVNIK_ITERS``) and of the Ladybug-49 adaptive paths.  The
#: Dubrovnik-class path is held to the JAX package's float64 run
#: (``adaptive_dubrovnik_implicit_f64``): its float32 run's first cost lies
#: 1.3e-3 from it (``costs_f32``), as does the port's float32 run through
#: the plain versions, whose sums over the kernel's rows (one run of
#: 1,253,547 costs) lose 5.4e-3, where B6 keeps them within 5.1e-7 and the
#: port's float32 run lies within 2.6e-7 of float64; from the third
#: iteration on, the JAX
#: float32 run moves from itself by 5e-5 and then 0.87 of its cost under
#: a one-ulp change of its start (``--spread``), so two iterations are
#: held, within 1e-4.
ADAPTIVE_BIG_ITERS = 2
LADYBUG_ADAPTIVE_ITERS = 10
ADAPTIVE_REFS = {
    ADAPTIVE_BIG: dict(
        start=2152168.0, start_f64=2152167.8815292846,
        costs=(1025097.9492924765, 495007.92316220584),
        best=495007.92316220584,
        costs_f32=(1023744.0625, 494308.21875),
        sigmas_weight=(0.5367367495523548, 25.890522492476293, 0.8823278404483968)),
    ADAPTIVE_IMPLICIT: dict(
        start=152114.40625, best=-207098.796875,
        sigmas_weight=(0.0012994270073249936, 69.26436614990234, 0.8942699432373047)),
    ADAPTIVE_PERCOST: dict(
        start=102427.54876965011, best=74591.64151618074,
        costs=(
            89433.25239609904, 84984.40585042434, 81536.78599853278, 79637.44324219247,
            78046.41506860782, 76881.30660301351, 76182.04848543, 75599.61686042367,
            75003.98229198487, 74591.64151618074)),
    ADAPTIVE_PERCOST_CG: dict(
        start=102427.54876965011, best=74591.77765474908,
        costs=(
            89433.25240173953, 84984.40470647899, 81536.7823379137, 79637.44091189807,
            78046.4044965285, 76881.3416113654, 76182.12643521032, 75599.76412971326,
            75004.11617351625, 74591.77765474908),
        pcg_iters=(500, 500, 500, 237, 500, 7, 7, 8, 6, 6, 5, 5, 5, 5, 5, 4, 4, 4),
        pcg_min=(500, 500, 500, 237, 500, 7, 7, 8, 6, 6, 5, 5, 5, 5, 5, 4, 4, 4),
        pcg_max=(500, 500, 500, 251, 500, 7, 7, 8, 6, 6, 5, 5, 5, 5, 5, 4, 4, 4)),
    PER_CAMERA: dict(
        start=102427.54876965012, best=99460.06249863948,
        costs=(
            100891.1877877026, 100492.45686319181, 100306.29656528788, 100067.34163841368,
            99897.02377247483, 99868.13840342293, 99740.05651112049, 99648.22453118124,
            99555.55310667718, 99460.06249863948)),
    f"{MIXTURE} dense": dict(
        start=1970.5579555490312, best=1268.1134612251515,
        costs=(
            1855.83852714888, 1763.9848340936871, 1653.3574152432275, 1527.0544363774914,
            1439.7331518352016, 1377.9174796582397, 1337.259680081258, 1311.5516782303678,
            1295.508639108744, 1285.500143845227, 1279.2236725830953, 1275.2590910813938,
            1272.7358678894284, 1271.1185409242644, 1270.0752749479611, 1269.398597954854,
            1268.9576353036687, 1268.669143684116, 1268.4797819676987, 1268.355148257247,
            1268.2729320436483, 1268.2185962975848, 1268.1826315883452, 1268.1587967935538,
            1268.1429845982484, 1268.1324858361584, 1268.1255102152097, 1268.120872841464,
            1268.1177885090046, 1268.1157363376499, 1268.1143704985682, 1268.1134612251515)),
    f"{MIXTURE} cg": dict(
        start=1970.5579555490312, best=1268.1134612251515,
        costs=(
            1855.8385271488778, 1763.984834093684, 1653.3574152432216, 1527.0544363774861,
            1439.7331518351975, 1377.917479658236, 1337.2596800812562, 1311.5516782303662,
            1295.5086391087434, 1285.5001438452264, 1279.2236725830953, 1275.2590910813933,
            1272.7358678894277, 1271.1185409242646, 1270.075274947961, 1269.3985979548538,
            1268.957635303669, 1268.6691436841163, 1268.4797819676987, 1268.355148257247,
            1268.272932043648, 1268.2185962975848, 1268.1826315883452, 1268.1587967935538,
            1268.1429845982484, 1268.1324858361584, 1268.1255102152097, 1268.120872841464,
            1268.1177885090046, 1268.1157363376499, 1268.1143704985682, 1268.1134612251515)),
}
#: Cluster-Jacobi's cameras per cluster on the pinhole bench problem (32
#: clusters of 4).
CLUSTER_SIZE = 4
#: ``make_curve_fit`` (100 samples, 15% outliers, seed 0) under each fixed
#: kernel at width 0.5, LM in float64 with the default options: the JAX
#: package's CPU best cost (same script, case ``curvefit``).
CURVEFIT_REF = {
    "None": 73.89570348817624, "Huber": 22.41616509324342,
    "GemanMcclure": 1.8378972524967947, "Cauchy": 6.990309101872129,
    "Welsch": 7.733943213220016, "Tukey": 0.6386680892787314,
}
#: The public parking-garage pose graph's counts: 1,661 poses, 6,275 edges
#: (1,661 odometry edges around the loop and 4,614 loop closures).
POSES, LOOPS = 1661, 4614
POSEGRAPH = "parking-garage pose graph"
TOL_F64 = 1e-10
TOL_B1_F32 = 1e-5
TOL_B3_F32 = 1e-4
TOL_B57_F64 = 1e-12
TOL_B57_F32 = 1e-6
#: Published H100 SXM peaks at 700 W: HBM bytes/s; float32 FLOP/s outside
#: the tensor cores (the kernels' arithmetic; TF32 is not float32); float64
#: FLOP/s of the float64 tensor cores (DMMA, full IEEE float64, which cuBLAS
#: uses), the card's float64 peak.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP64_FLOP_PER_S = 67e12


def rel_err(a, b) -> float:
    """max |a − b| over max |b| (b the float64 yardstick)."""
    b = b.double()
    return float((a.double() - b).abs().max() / b.abs().max())


def abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _inv_sqrt(diag):
    diag = diag.abs()
    return torch.where(diag > 0, diag.rsqrt(), torch.ones_like(diag))


def scaled_errs(out, ref) -> list:
    """B3's (s_sum, rhs, h_inv) against the float64 reference, each scaled
    by the reference's diagonal: D S D and D rhs with D = diag(S)^-½, and
    every h_inv block E h E with E its own diagonal^-½."""
    s, r, h = (t.double() for t in out)
    s0, r0, h0 = (t.double() for t in ref)
    d = _inv_sqrt(torch.diagonal(s0))
    e = _inv_sqrt(torch.diagonal(h0, dim1=0, dim2=1).T)  # [dl, L]
    ds, eh = d[:, None] * d[None, :], e[:, None, :] * e[None, :, :]
    return [rel_err(s * ds, s0 * ds), rel_err(r * d, r0 * d), rel_err(h * eh, h0 * eh)]


def time_ms(fn, reps=20) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events,
    after two warm-up calls)."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=20) -> float:
    """Mean device time of ``fn()`` with the host taken out: ``reps`` calls
    captured in one CUDA graph, replayed between CUDA events (a small
    kernel's event time above is the host's rate of launching it)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    gc.disable()  # a collected runner's graph destroyed mid-capture invalidates it
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    finally:
        gc.enable()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, dtype=torch.float32) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the rate of their float type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    rate = FP64_FLOP_PER_S if dtype == torch.float64 else FP32_FLOP_PER_S
    t_ops = flops / rate * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def assembly_flops(n_obs: int, dr_s: int, dl: int = 3, n: int = 2,
                   camera_side: bool = True) -> int:
    """Operations of B1/B2 per real observation: g_l, the h_ll upper
    triangle, the W block, the a_rr upper triangle and b_r, each entry a
    length-n product, then ρ′· and + 2ρ″·g·g (2n + 5 operations); B8's
    without the camera side (a_rr and b_r)."""
    cam = camera_side * dr_s
    entries = dl * (dl + 1) // 2 + dl * dr_s + cam * (dr_s + 1) // 2
    return n_obs * (2 * dl + entries * (2 * n + 5) + 2 * cam)


def reduce_flops(L: int, dl: int, wc: int) -> int:
    """Operations of B3 and B4 (and of B5's dense plain version): Y = H⁻¹W,
    the upper triangle of S = YᵀW (diagonal included) and rhs = Yᵀg (B3's
    inverses not counted)."""
    return 2 * dl * dl * L * wc + L * dl * wc * (wc + 1) + 2 * L * dl * wc


def _host(x):
    import numpy as np

    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def struct_work(tables, dl: int, elt: int, damped: bool = False):
    """``(bytes, operations)`` the reduction needs on W's block structure
    (``schur_reduce.RowTables``), as B3, B4 and B5 read it: each held block
    of W read once; the inverse (B3: h_ll, of every landmark, since B3
    writes every inverse) and g_l of each landmark holding a block read
    once; the incidence list (landmark, block) once; per (landmark, block)
    Y = H⁻¹W and its rhs term once, per (landmark, block pair i ≤ j) the
    block Y_iᵀW_j (on a diagonal pair its upper triangle only, as
    :func:`reduce_flops` counts S's).  No other table is counted: the
    links, items and pair lists are the implementation's.  The outputs
    (S, rhs, B3's h_inv, written once) are counted by the caller."""
    import numpy as np

    lmk, blk, bwidth, links = (_host(getattr(tables, k)) for k in ("lmk", "blk", "bwidth", "links"))
    real = blk >= 0
    width = bwidth[blk[real]].astype(np.int64)  # each held block's width
    held = int(width.sum())
    n_held = np.unique(lmk[real]).shape[0]  # landmarks holding a block
    n_inv = np.unique(lmk).shape[0] if damped else n_held
    nbytes = (held * dl + n_inv * dl * dl + n_held * dl) * elt + int(real.sum()) * 8
    wi, wj = bwidth[blk[links[:, 0]]].astype(np.int64), bwidth[blk[links[:, 1]]].astype(np.int64)
    entries = np.where(links[:, 0] == links[:, 1], wi * (wi + 1) // 2, wi * wj)
    ops = int((2 * dl * entries).sum() + 2 * dl * dl * held + 2 * dl * held)
    return int(nbytes), ops


def gemm_call(w, h_inv):
    """The library yardstick of B3, B4 and B5: cuBLAS's dense product Yᵀ W
    (SGEMM or DGEMM), the one PyTorch call of their plain version that
    forms S, with Y = H⁻¹ W formed beforehand."""
    L, dl, wc = w.shape
    y = torch.einsum("edl,ldr->ler", h_inv, w).reshape(L * dl, wc)
    w2 = w.reshape(L * dl, wc)
    return lambda: y.T @ w2


def row_case(gen, L, dl, n_blocks, width, device, inverse):
    """A synthetic obs-major W ``(w, h, g_l, rows)`` on ``device``: landmark
    l holds about ten random camera blocks of ``width`` columns (every 9th
    none), zero elsewhere; h SPD, or its inverse with ``inverse``; the
    device row tables."""
    from nllstpu_torch.ops import schur_reduce

    held = torch.rand(L, n_blocks, generator=gen) < min(1.0, 10.0 / n_blocks)
    held[::9] = False
    lmk, blk = held.nonzero(as_tuple=True)
    w = torch.zeros(L, dl, n_blocks, width, dtype=torch.float64)
    w[lmk, :, blk] = torch.randn(len(lmk), dl, width, generator=gen, dtype=torch.float64)
    a = torch.randn(L, dl, dl, generator=gen, dtype=torch.float64)
    h = a @ a.transpose(1, 2) + 2.0 * torch.eye(dl, dtype=torch.float64)
    if inverse:
        h = torch.linalg.inv(h)
    rows = schur_reduce.row_tables(lmk.numpy(), blk.numpy(), L,
                                   *schur_reduce.uniform_blocks(n_blocks, width))
    return (w.reshape(L, dl, -1).to(device), h.permute(1, 2, 0).contiguous().to(device),
            torch.randn(dl, L, generator=gen, dtype=torch.float64).to(device),
            schur_reduce.upload_tables(rows, device))


class PhaseTimer:
    """``IterCtx.phase`` hook: CUDA events around every phase."""

    def __init__(self):
        self.events = collections.defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        yield
        e.record()
        self.events[name].append((s, e))

    def totals(self):
        torch.cuda.synchronize()
        return {
            k: (len(v), sum(s.elapsed_time(e) for s, e in v))
            for k, v in self.events.items()
        }


def bench_problem(device):
    from nllstpu_torch.models.ba import make_pinhole_ba, perturb_ba

    problem, _, lmks = make_pinhole_ba(
        ncameras=NCAM, nlandmarks=NLMK, prop_visible=VIS, noise=NOISE,
        dtype=torch.float32, batched="cm", device=device,
    )
    perturb_ba(problem, lmks, 0.05, seed=5)
    return problem


def dual_problem(name, device):
    """``(problem, route)``: a dual-sorted path's problem and the keyword
    arguments of ``nt.optimize`` that select its variables and route."""
    from nllstpu_torch.models.ba import make_pinhole_ba, perturb_ba

    dtype, n_fixed = DUAL[name]
    problem, cams, lmks = make_pinhole_ba(
        ncameras=NCAM, nlandmarks=NLMK, prop_visible=VIS, noise=NOISE,
        dtype=dtype, batched="cm", device=device,
    )
    perturb_ba(problem, lmks, 0.05, seed=5)
    return problem, dict(unfixed=cams[n_fixed:] + lmks if n_fixed else None, w_impl="fused")


def bal_problem(name, device):
    from nllstpu_torch.models.ba import perturb_ba
    from nllstpu_torch.models.bal import make_bal_problem, make_realistic_bal

    args = BAL[name][0] if name in BAL else IMPLICIT[name][0]
    problem, _, points = make_bal_problem(
        make_realistic_bal(**args), dtype=torch.float32, device=device
    )
    perturb_ba(problem, points, 0.05, seed=5)
    return problem


def with_outliers(data):
    """The adaptive paths' outlier recipe: 10% of the observations moved
    by 50 pixels (``numpy.random.default_rng(3)``)."""
    import numpy as np

    rng = np.random.default_rng(3)
    out = rng.choice(len(data["pt_idx"]), size=len(data["pt_idx"]) // 10, replace=False)
    data["observations"][out] += 50.0
    return data


def adaptive_problem(device, args=None):
    """``(problem, kernel_handle)``: the adaptive main path's problem (on
    ``make_realistic_bal(**args)``'s data, bench-realistic's by default)."""
    import nllstpu_torch as nt
    from nllstpu_torch.models.ba import perturb_ba
    from nllstpu_torch.models.bal import make_bal_problem, make_realistic_bal

    data = with_outliers(make_realistic_bal(**(args or BAL["bench-realistic"][0])))
    problem, _, points, kh = make_bal_problem(
        data, dtype=torch.float32, device=device, kernel=nt.ContaminatedGaussian(),
        kernel_params=nt.ContaminatedGaussian.make_params(1.0, 10.0, 0.8),
    )
    perturb_ba(problem, points, 0.01, seed=5)
    return problem, kh


def point_prior(measurement, point):
    """A prior on a point: its offset from ``measurement``."""
    return point - measurement


def camera_prior(measurement, camera):
    """A prior on a Snavely camera: its offset from ``measurement``."""
    return camera - measurement


def percost_problem(device):
    """``(problem, route)``: Ladybug-49 in the per-cost form in float64,
    with a prior batch on every 25th point from the fourth on (its true
    position), the first camera and the first three points fixed at their
    true values, the free points perturbed by 0.05."""
    import numpy as np

    from nllstpu_torch.models.ba import perturb_ba
    from nllstpu_torch.models.bal import PT, make_bal_problem, make_realistic_bal

    data = make_realistic_bal(**BAL["Ladybug-49"][0])
    problem, cams, pts = make_bal_problem(data, dtype=torch.float64, device=device,
                                          batched=False)
    idx = np.arange(3, len(pts), 25)
    problem.add_cost_batch(point_prior, slots=[(PT, idx)], params=data["points"][idx])
    perturb_ba(problem, pts[3:], 0.05, seed=5)
    return problem, dict(unfixed=cams[1:] + pts[3:])


def ladybug_adaptive_problem(device, per_camera=False):
    """``(problem, route, kernel handles)``: Ladybug-49 with the outlier
    recipe in float64, one shared ContaminatedGaussian (1, 10, 0.8) in the
    per-cost form (``make_bal_problem(..., batched=False)``), or one per
    camera in a components-major batch (49 kernel variables); the first
    camera and the first three points fixed at their true values, the free
    points perturbed by 0.05 (seed 5)."""
    import numpy as np

    import nllstpu_torch as nt
    from nllstpu_torch.models.ba import perturb_ba
    from nllstpu_torch.models.bal import (CAM, PT, make_bal_problem, make_realistic_bal,
                                          snavely_jacobian_cm, snavely_residual_cm)

    data = with_outliers(make_realistic_bal(**BAL["Ladybug-49"][0]))
    kern = nt.ContaminatedGaussian()
    kp = nt.ContaminatedGaussian.make_params(1.0, 10.0, 0.8)
    if per_camera:
        problem = nt.Problem(dtype=torch.float64, device=device)
        cams = problem.add_variables(CAM, data["cameras"])
        pts = problem.add_variables(PT, data["points"])
        kh = [problem.add_variable(kern.manifold, kp.numpy()) for _ in cams]
        problem.add_cost_batch(
            snavely_residual_cm,
            [(kern.manifold, np.asarray([h.index for h in kh])[data["cam_idx"]]),
             (CAM, data["cam_idx"]), (PT, data["pt_idx"])],
            params=data["observations"], kernel=kern, jacobian=snavely_jacobian_cm,
            batched="cm")
    else:
        problem, cams, pts, k = make_bal_problem(data, dtype=torch.float64, device=device,
                                                 batched=False, kernel=kern,
                                                 kernel_params=kp.numpy())
        kh = [k]
    perturb_ba(problem, pts[3:], 0.05, seed=5)
    return problem, dict(unfixed=cams[1:] + pts[3:] + kh), kh


def mixture_residual(data, mean):
    """tests/test_adaptive.py's residual: a mean's offset from a sample."""
    return mean - data


def mixture_problem(device):
    """``(problem, kernel_handle)``: tests/test_adaptive.py's two-mean
    mixture (1,000 samples, a fifth of them ten times wider; each sample a
    cost on either mean, one ContaminatedGaussian from (0.5, 5, 0.6)) in
    float64."""
    import numpy as np

    import nllstpu_torch as nt

    rng = np.random.default_rng(1)
    points = np.concatenate([rng.normal(0, 1, 800), rng.normal(0, 10, 200)])
    kern = nt.ContaminatedGaussian()
    problem = nt.Problem(dtype=torch.float64, device=device)
    kh = problem.add_variable(kern.manifold, nt.ContaminatedGaussian.make_params(0.5, 5.0, 0.6))
    m1 = problem.add_variable(nt.Scalar(), 0.0)
    m2 = problem.add_variable(nt.Scalar(), 0.0)
    for x in points:
        problem.add_cost(mixture_residual, (kh, m1), params=x - 1.0, kernel=kern)
        problem.add_cost(mixture_residual, (kh, m2), params=x + 1.0, kernel=kern)
    return problem, kh


def adaptive_all_options(label):
    """The options of this slice's paths (``ADAPTIVE_REFS``' runs)."""
    import nllstpu_torch as nt

    if label == ADAPTIVE_BIG:
        return dataclasses.replace(bench_options(), solver="schur_cg", linear_tol=1e-2,
                                   max_iters=ADAPTIVE_BIG_ITERS)
    if label == ADAPTIVE_IMPLICIT:
        return dataclasses.replace(adaptive_options(), solver="schur_cg", linear_tol=1e-2)
    if label == CLUSTER:
        return dataclasses.replace(bench_options(), solver="schur_cg", linear_tol=1e-2,
                                   schur_cluster_size=CLUSTER_SIZE)
    if label.startswith(MIXTURE):
        return nt.Options(solver=label.split()[-1], rel_dcost=1e-6, max_time=float("inf"))
    solver = "schur_cg" if label == ADAPTIVE_PERCOST_CG else "schur"
    return dataclasses.replace(generic_options(solver), max_iters=LADYBUG_ADAPTIVE_ITERS)


def adaptive_all_problem(label, device):
    """``(problem, route)`` of one of this slice's paths."""
    if label == ADAPTIVE_BIG:
        return adaptive_problem(device, IMPLICIT["Dubrovnik-class"][0])[0], {}
    if label == ADAPTIVE_IMPLICIT:
        return adaptive_problem(device)[0], {}
    if label == CLUSTER:
        return bench_problem(device), {}
    if label.startswith(MIXTURE):
        return mixture_problem(device)[0], {}
    problem, route, _ = ladybug_adaptive_problem(device, per_camera=label == PER_CAMERA)
    return problem, route


def riders_problem(device):
    """``(problem, route)``: bench-realistic in float32 with a prior batch
    on every camera and one on every 100th free point (their true values),
    its 81 lowest-id points (1%) fixed at their true values, the free points
    perturbed by 0.05."""
    import numpy as np

    from nllstpu_torch.models.ba import perturb_ba
    from nllstpu_torch.models.bal import CAM, PT, make_bal_problem, make_realistic_bal

    data = make_realistic_bal(**BAL["bench-realistic"][0])
    problem, cams, pts = make_bal_problem(data, dtype=torch.float32, device=device)
    n_fix = len(pts) // 100
    problem.add_cost_batch(camera_prior, slots=[(CAM, np.arange(len(cams)))],
                           params=data["cameras"])
    idx = np.arange(n_fix, len(pts), 100)
    problem.add_cost_batch(point_prior, slots=[(PT, idx)], params=data["points"][idx])
    perturb_ba(problem, pts[n_fix:], 0.05, seed=5)
    return problem, dict(unfixed=cams + pts[n_fix:])


def generic_options(solver):
    """The per-cost path's options: LM, ``rel_dcost=1e-6`` (the float64
    trace gate's stop rule), ``linear_tol=1e-8`` on the implicit solve."""
    import nllstpu_torch as nt

    return nt.Options(solver=solver, schur_family=nt.Euclidean(3), rel_dcost=1e-6,
                      max_time=float("inf"),
                      linear_tol=1e-8 if solver == "schur_cg" else None)


def bench_options():
    import nllstpu_torch as nt

    return nt.Options(
        max_iters=ITERS, rel_dcost=0.0, abs_dcost=0.0, dstep=1e-12,
        max_fails=1 << 30, max_time=float("inf"), solver="schur",
        schur_family=nt.Euclidean(3),
    )


def adaptive_options():
    return dataclasses.replace(bench_options(), max_iters=ADAPTIVE_ITERS)


def implicit_options(name):
    """The bench options with the implicit problem's solver and
    ``linear_tol=1e-2``, as ``scripts/bal_realistic.py`` runs it."""
    return dataclasses.replace(bench_options(), solver=IMPLICIT[name][1], linear_tol=1e-2)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    import nllstpu_torch  # noqa: F401  (fails here when run outside the repository)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | count {torch.cuda.device_count()}", flush=True)
    return torch.device("cuda", 0), smi


def phase_build(device):
    """The first use of the kernels: one LM iteration of a small pinhole
    problem through ``nt.optimize``, whose compile builds and loads the
    library; the build must count in ``Result.time_init``."""
    import nllstpu_torch as nt
    from nllstpu_torch.models.ba import make_pinhole_ba
    from nllstpu_torch.ops import _build

    problem, _, _ = make_pinhole_ba(8, 64, 0.8, noise=NOISE, dtype=torch.float32, batched="cm",
                                    device=device)
    opts = dataclasses.replace(bench_options(), max_iters=1)
    result = nt.optimize(problem, opts)
    if _build._lib is None:
        raise AssertionError("build: compile_problem did not load the kernel library")
    if not result.time_init >= _build.BUILD_SECONDS:
        raise AssertionError(f"build: time_init {result.time_init} s misses the "
                             f"{_build.BUILD_SECONDS} s build")
    how = "compiled" if _build.BUILD_LOG else "reused the library in .torch_ext/"
    print(f"build: {_build.BUILD_SECONDS:.2f} s ({how}) inside compile_problem; the first "
          f"nt.optimize: time_init {result.time_init:.2f} s, its loop "
          f"{result.time_total - result.time_init:.3f} s", flush=True)
    kernels = _build.resources()
    for name, regs, stores, loads in kernels:
        print(f"build: {regs} registers, spill stores {stores} / loads {loads} bytes: {name}",
              flush=True)
    anyshape = [k for k in kernels if "assemble_any_kernel" in k[0]]
    if len(anyshape) != 24 or any(k[2] or k[3] for k in anyshape):
        raise AssertionError(f"build: the any-shape instance of B1/B2/B8 (f32 and f64 of B1, B2 "
                             f"and B8, each with and without its WIDE_N and WIDE_DL paths) must "
                             f"build spill-free, nvcc reports {anyshape}")


def check(name, got, ref, tol):
    errs = [rel_err(a, b) for a, b in zip(got, ref)]
    if not max(errs) <= tol:
        raise AssertionError(f"{name}: relative errors {errs} exceed {tol}")
    return errs


def small_assembly_case(seed, e_start):
    """A small B8 input, ``(floats, ints)``: 5 slots of 37 landmarks over
    11 cameras, every run seeing a camera twice, dustbin slots with zero
    weights (:func:`with_tables` makes it B1's)."""
    gen = torch.Generator().manual_seed(seed)
    K, L, n_r = 5, 37, 11
    small = [
        torch.randn(2, 9, K, L, generator=gen, dtype=torch.float64),
        torch.randn(9, K, L, generator=gen, dtype=torch.float64),
        torch.rand(K, L, generator=gen, dtype=torch.float64) + 0.05,
        -0.2 * torch.rand(K, L, generator=gen, dtype=torch.float64),
    ]
    vc = torch.randint(0, n_r, (K, L), generator=gen, dtype=torch.int32)
    vc[1] = vc[0]
    vc[K - 1, ::3] = n_r
    small[2][K - 1, ::3] = 0.0
    small[3][K - 1, ::3] = 0.0
    return small, (vc, n_r, 6, 3, e_start)


def with_tables(it):
    """B8's ``(vc, n_r, dr_s, dl, e_start)`` with B1's camera tables of
    that one bucket after ``vc``."""
    from nllstpu_torch.ops import fused_obs

    return (it[0], *fused_obs.camera_tables(it[0], it[1]), *it[1:])


def camera_rows(args, cpos, n_rows, dtype):
    """The per-slot camera rows ``[n_rows, npairs + dr_s]`` that B1 writes
    for a uniform batch's one bucket ``args`` (here by its plain version):
    kernel B6's input on the camera side of the direct path."""
    from nllstpu_torch.ops import fused_obs

    return fused_obs._tile_plain(*[t.to(dtype) for t in args[:4]], args[4], cpos, *args[5:],
                                 n_rows)[3]


def phase_b1(device):
    """B1 against its plain version; returns its record, the bench system
    with its row tables (for B3) and B6's camera-side input (D = 27)."""
    from nllstpu_torch.core.optimize import compile_problem
    from nllstpu_torch.ops import fused_obs, schur

    problem = bench_problem(device)
    comp = compile_problem(problem, solver="schur", schur_family=bench_options().schur_family)
    (batch,), (fast,) = comp.batches, comp.schur_info.fast
    _, args = schur.fused_inputs(
        batch, problem.stacked_variables(), comp.schur_info, fast, torch.float32
    )
    floats, ints = args[:4], (args[4], fast.cpos, fast.cstarts, *args[5:])
    small_fl, small_it = small_assembly_case(0, e_start=6)
    cases = {
        f"bench K={args[0].shape[2]} L={args[0].shape[3]}": (floats, ints),
        "small dup+dustbin": (small_fl, with_tables((small_it[0].to(device), *small_it[1:]))),
    }
    main_abs = None
    for label, (fl, it) in cases.items():
        fl = [t.to(device) for t in fl]
        ref = fused_obs.fused_obs_all_reference(*[t.double() for t in fl], *it)
        out64 = fused_obs.fused_obs_all(*[t.double() for t in fl], *it)
        out32 = fused_obs.fused_obs_all(*[t.float() for t in fl], *it)
        again = fused_obs.fused_obs_all(*[t.float() for t in fl], *it)
        torch.cuda.synchronize()
        e64 = check(f"B1 f64 {label}", out64, ref, TOL_F64)
        e32 = check(f"B1 f32 {label}", out32, ref, TOL_B1_F32)
        if not all(torch.equal(a, b) for a, b in zip(out32, again)):
            raise AssertionError(f"B1 {label}: two launches differ")
        if main_abs is None:
            main_abs = max(abs_err(a, b) for a, b in zip(out32, ref))
        print(f"B1 {label}: rel err h_ll/g_l/w/ab f64 {['%.2e' % e for e in e64]}"
              f" f32 {['%.2e' % e for e in e32]}, two launches bit-identical", flush=True)
    f32 = [t.float() for t in floats]
    ms = time_ms(lambda: fused_obs.fused_obs_all(*f32, *ints))
    device_ms = graph_ms(lambda: fused_obs.fused_obs_all(*f32, *ints))
    plain_ms = time_ms(lambda: fused_obs.fused_obs_all_reference(*f32, *ints))
    dr_s, dl = ints[4:6]
    outs = fused_obs.fused_obs_all(*f32, *ints)
    b = bound(nbytes(*f32, *ints[:3], *outs), assembly_flops(batch.n, dr_s, dl))
    print(f"B1 bench time (kernel and B6 over the camera runs): kernel {ms:.4f} ms (in a CUDA "
          f"graph {device_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']})", flush=True)
    sys_ = comp.assemble(problem.stacked_variables())[1], comp.schur_info.w_rows
    cam = {f"pinhole bench D={dr_s * (dr_s + 3) // 2} camera runs": (
        camera_rows(args, fast.cpos, int(fast.cam_starts[-1]), torch.float32),
        fast.cstarts,
    )}
    return dict(max_abs_err=main_abs, ms=ms, plain_ms=plain_ms, **b, graph_ms=device_ms), sys_, cam


def _assemble_batch(fns, fast, head, tail, dtype, L):
    """One assembly of a bucketed batch's ``L`` landmarks through ``fns``
    (B2 and B6, or their plain versions): buffers zeroed, one B2 call over
    the batch, then the camera runs' sums: ``(h_ll, g_l, w, ab)``."""
    from nllstpu_torch.ops import fused_obs

    into, camera_sum = fns
    n_r, dr_s, dl, _ = tail
    bufs = fused_obs.zero_buffers(L, n_r, dr_s, dl, int(fast.cam_starts[-1]), dtype,
                                  head[0].device)
    into(*[t.to(dtype) for t in head[:4]], *head[4:], *bufs, *tail)
    return (*bufs[:3], camera_sum(bufs[3], fast.cstarts))


def b2_case(name, batch, info, fast, variables, timed=True):
    """B2 (with B6 over the camera runs) against its plain version on one
    bucketed batch's whole assembly (``info``'s tables, ``fast`` its
    bucket plan); with ``timed``, its times per whole assembly.  Returns
    its record (no times without ``timed``) and the batch's inputs
    ``(head, tail)``."""
    from nllstpu_torch.ops import schur

    _, head, tail = schur.batch_inputs(batch, variables, info, fast, torch.float32)
    note = (f"{len(fast.buckets)} buckets {list(fast.buckets)} in one launch; B2 and B3/B4 "
            f"tables built in {info.table_seconds:.4f} s")
    return b2_check(name, head, tail, fast, info.num_elim, batch.n, note, timed), head, tail


def b2_check(name, head, tail, fast, L, n_obs, note, timed=True, tol64=TOL_F64,
             tol32=TOL_B1_F32, f64_timed=False):
    """B2 (with B6 over the camera runs) against its plain version on one
    whole assembly of the batch ``head`` (jac, g0, ρ′·mask, 2ρ″·mask, camera
    columns, camera-order rows, slot tables), ``tail`` (n_r, dr_s, dl,
    e_start) of ``L`` landmarks and ``n_obs`` observations (``fast``: its
    ``cam_starts`` and ``cstarts``); with ``timed``, its float32 times per
    whole assembly (``f64_timed``: also its float64 times, the record's
    ``"f64"``).  Returns its record (no times without ``timed``)."""
    from nllstpu_torch.ops import fused_obs, segment_sum

    kern = (fused_obs.fused_obs_all_into, segment_sum.segment_block_sum)
    plain = (fused_obs.fused_obs_all_into_reference, segment_sum.segment_block_sum_reference)
    ref = _assemble_batch(plain, fast, head, tail, torch.float64, L)
    out64 = _assemble_batch(kern, fast, head, tail, torch.float64, L)
    out32 = _assemble_batch(kern, fast, head, tail, torch.float32, L)
    again = _assemble_batch(kern, fast, head, tail, torch.float32, L)
    torch.cuda.synchronize()
    e64 = check(f"B2 f64 {name}", out64, ref, tol64)
    e32 = check(f"B2 f32 {name}", out32, ref, tol32)
    if not all(torch.equal(a, b) for a, b in zip(out32, again)):
        raise AssertionError(f"B2 {name}: two assemblies differ")
    slots = head[6]
    n, (_, dr_s, dl, _) = head[0].shape[0], tail
    print(f"B2 {name} ((n, dr_s, dl) = ({n}, {dr_s}, {dl}); {note}; "
          f"{slots.work.shape[0]} warp items, {int((slots.slots < 0).sum())} repeated "
          f"cameras): rel err h_ll/g_l/w/ab f64 {['%.2e' % e for e in e64]} f32 "
          f"{['%.2e' % e for e in e32]}, two assemblies bit-identical", flush=True)
    record = dict(max_abs_err=max(abs_err(a, r) for a, r in zip(out32, ref)))
    for dt, out in ((torch.float32, out32), (torch.float64, out64)):
        if not timed or (dt == torch.float64 and not f64_timed):
            continue
        ms = time_ms(lambda: _assemble_batch(kern, fast, head, tail, dt, L))
        device_ms = graph_ms(lambda: _assemble_batch(kern, fast, head, tail, dt, L))
        plain_ms = time_ms(lambda: _assemble_batch(plain, fast, head, tail, dt, L))
        # The real columns of the inputs (the pad columns and the slot
        # tables are the implementation's), the outputs written once.
        n_real = int(slots.starts[-1])
        elt = torch.empty((), dtype=dt).element_size()
        b = bound(
            sum(t[..., :1].numel() * (elt if t.is_floating_point() else t.element_size())
                for t in head[:6]) * n_real + nbytes(*out),
            assembly_flops(n_obs, dr_s, dl, n), dt,
        )
        print(f"B2 {name} {dt} time per assembly, B6 over the camera runs included ({n_obs} "
              f"observations, W {tuple(out[2].shape)}): kernel {ms:.4f} ms (in a CUDA graph "
              f"{device_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']})", flush=True)
        times = dict(ms=ms, plain_ms=plain_ms, **b, graph_ms=device_ms)
        if dt == torch.float32:
            record.update(times)
        else:
            record["f64"] = dict(max_abs_err=max(abs_err(a, r) for a, r in zip(out64, ref)),
                                 **times)
    return record


def phase_b2(device):
    """B2 (with B6 over the camera runs) against its plain version on the
    whole batch of both BAL problems (:func:`b2_case`); times per whole
    assembly.  Returns a record per problem, the float32 systems with
    their row tables for B3 and B6's camera-side inputs (D = 54)."""
    from nllstpu_torch.core.optimize import compile_problem

    records, systems, cam = {}, {}, {}
    for name in BAL:
        problem = bal_problem(name, device)
        comp = compile_problem(problem, solver="schur", schur_family=bench_options().schur_family)
        (batch,), (fast,) = comp.batches, comp.schur_info.fast
        info = comp.schur_info
        records[name], head, tail = b2_case(name, batch, info, fast,
                                            problem.stacked_variables())
        systems[name] = comp.assemble(problem.stacked_variables())[1], info.w_rows
        cam[f"{name} D={tail[1] * (tail[1] + 3) // 2} camera runs"] = (
            _assemble_rows(head, tail, info.num_elim, int(fast.cam_starts[-1])), fast.cstarts,
        )
        del head
    return records, systems, cam


def _assemble_rows(head, tail, L, n_rows):
    """The per-slot camera rows B2 writes for a batch (here by its plain
    version): kernel B6's camera-side input."""
    from nllstpu_torch.ops import fused_obs

    n_r, dr_s, dl, _ = tail
    bufs = fused_obs.zero_buffers(L, n_r, dr_s, dl, n_rows, torch.float32, head[0].device)
    fused_obs.fused_obs_all_into_reference(*head, *bufs, *tail)
    return bufs[3]


def phase_b3(device, systems, synthetic=None, rel_tol=None):
    """B3 against its plain version on each main path's own system over
    its row tables (keyed by the path) and on a synthetic structure; two
    launches give the same bits, s_sum exactly symmetric.  A record per
    path, with both bounds: the structural one (``bound_ms``) and the
    dense product's.  ``synthetic``: row cases (:func:`row_case`) checked
    and timed beside the systems, in place of the default wc = 1152
    structure, which is checked only; ``rel_tol``: each output also
    within it of its largest entry, unscaled."""
    from nllstpu_torch.ops import schur_reduce

    kern, plain = schur_reduce.reduce_s_damped, schur_reduce.reduce_s_damped_reference
    gen = torch.Generator().manual_seed(1)
    cases = {name: (s[4], s[2], s[3], rows) for name, (s, rows) in systems.items()}
    timed = set(systems)
    if synthetic is None:
        cases["synthetic structure"] = row_case(gen, WIDE_L, 3, 128, 9, device, inverse=False)
    else:
        cases.update(synthetic)
        timed |= set(synthetic)
    records = {}
    for name, (*inputs, rows) in cases.items():
        inputs = [t.to(device) for t in inputs]
        f32 = [t.float() for t in inputs]
        label = f"wc={inputs[0].shape[2]} {name}"
        max_abs = 0.0
        for lam in (0.0, 1e-2):
            ref = plain(*[t.double() for t in inputs], lam)
            plain32 = plain(*f32, lam)
            # λ as a float, then as the 0-d float64 device tensor the drivers give.
            lam_dev = torch.full((), lam, dtype=torch.float64, device=device)
            out32, again = kern(*f32, lam, rows), kern(*f32, lam_dev, rows)
            torch.cuda.synchronize()
            e32, p32 = scaled_errs(out32, ref), scaled_errs(plain32, ref)
            tol32 = [max(TOL_B3_F32, 10 * p) for p in p32]
            if not all(e <= t for e, t in zip(e32, tol32)):
                raise AssertionError(
                    f"B3 f32 {label} lam={lam}: scaled errors s_sum/rhs/h_inv {e32}"
                    f" exceed {tol32}"
                )
            if rel_tol is not None:
                check(f"B3 f32 {label} lam={lam} unscaled", out32, ref, rel_tol)
            if not all(torch.equal(x, y) for x, y in zip(out32, again)):
                raise AssertionError(f"B3 {label} lam={lam}: two launches (λ a float, then "
                                     "in device memory) differ")
            if not torch.equal(out32[0], out32[0].T):
                raise AssertionError(f"B3 {label} lam={lam}: s_sum is not exactly symmetric")
            max_abs = max(max_abs, *(abs_err(x, y) for x, y in zip(out32, ref)))
            print(f"B3 {label} lam={lam} ({rows.links.shape[0]} links in {rows.items.shape[0]} "
                  f"items): f32 scaled by diag, kernel {['%.2e' % e for e in e32]} plain "
                  f"{['%.2e' % e for e in p32]} tolerance {['%.2e' % t for t in tol32]}; two "
                  "launches (λ a float, λ in device memory) bit-identical, s_sum symmetric",
                  flush=True)
        if name not in timed:
            continue
        lam_dev = torch.full((), 1e-2, dtype=torch.float64, device=device)
        ms = time_ms(lambda: kern(*f32, lam_dev, rows))
        device_ms = graph_ms(lambda: kern(*f32, lam_dev, rows))
        plain_ms = time_ms(lambda: plain(*f32, 1e-2))
        outs = kern(*f32, lam_dev, rows)
        library_ms = time_ms(gemm_call(f32[0], outs[2]))
        L, dl, wc = f32[0].shape
        pb, pf = struct_work(rows, dl, 4, damped=True)
        b = bound(pb + nbytes(*outs), pf)
        dense = bound(nbytes(*f32, *outs), reduce_flops(L, dl, wc))
        print(f"B3 {label} time (λ in device memory): kernel {ms:.4f} ms (in a CUDA graph "
              f"{device_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, cuBLAS Y^T W {library_ms:.4f} ms, structural bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {pb} bytes, {pf} operations), dense "
              f"bound {dense['bound_ms']:.4f} ms ({dense['bound_by']})", flush=True)
        records[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, **b,
                             dense_bound_ms=dense["bound_ms"], graph_ms=device_ms,
                             library_ms=library_ms)
    return records


def phase_b6(device, camera_cases):
    """B6 against its plain version on the inputs the implicit paths and
    the adaptive direct path give it: each problem is compiled through its
    user-facing solver (the Dubrovnik-class one must switch to implicit,
    the adaptive one stay direct), then one assembly and one damped solve
    run with a recorder in place of the kernel that keeps the first input
    of each (D, runs); on ``camera_cases``, the camera side of B1 and B2;
    and on a synthetic case.  Two launches must give the same bits.
    Returns a record per main-path shape."""
    from nllstpu_torch.core.optimize import compile_problem
    from nllstpu_torch.ops import segment_sum

    kern, plain = segment_sum.segment_block_sum, segment_sum.segment_block_sum_reference
    gen = torch.Generator().manual_seed(3)
    lengths = torch.randint(0, 50, (4096,), generator=gen)
    lengths[::5] = 0
    lengths[1000] = 100_000
    starts = torch.cat([torch.zeros(1, dtype=torch.long), lengths.cumsum(0)])
    cases = {"synthetic 100k run + empty runs": (
        torch.randn(int(starts[-1]), 12, generator=gen, dtype=torch.float64).to(device),
        starts.to(device),
    ), **camera_cases}
    paths = [(name, lambda name=name: (bal_problem(name, device), {}), implicit_options(name))
             for name in IMPLICIT]
    paths.append((ADAPTIVE, lambda: (adaptive_problem(device)[0], {}), adaptive_options()))
    paths.append((PERCOST, lambda: percost_problem(device), generic_options("schur")))
    paths.append((PERCOST_CG, lambda: percost_problem(device), generic_options("schur_cg")))
    paths += [(name, lambda name=name: adaptive_all_problem(name, device),
               adaptive_all_options(name))
              for name in (ADAPTIVE_BIG, ADAPTIVE_IMPLICIT, ADAPTIVE_PERCOST, ADAPTIVE_PERCOST_CG,
                           PER_CAMERA, CLUSTER, f"{MIXTURE} dense", f"{MIXTURE} cg")]
    implicit = (*IMPLICIT, PERCOST_CG, ADAPTIVE_BIG, ADAPTIVE_IMPLICIT, ADAPTIVE_PERCOST_CG,
                CLUSTER)
    for name, make, opts in paths:
        problem, route = make()
        comp = compile_problem(problem, route.get("unfixed"), solver=opts.solver,
                               schur_family=opts.schur_family)
        if comp.implicit != (name in implicit):
            raise AssertionError(f"{name}: solver={opts.solver!r} compiled the wrong backend")
        if name == CLUSTER and comp.ctx(opts).linops.cluster is None:
            raise AssertionError(f"{name}: cluster-Jacobi did not apply")
        L = comp.schur_info.num_elim if comp.schur_info is not None else -1
        seen = {}

        def record(data, st, seen=seen, L=L):
            kind = "landmark" if st.shape[0] == L + 1 else "camera" if L >= 0 else "variable"
            key = f"{name} D={data.shape[1]} {kind} runs"
            seen.setdefault(key, (data.clone(), st))
            return kern(data, st)

        comp.kernels = dataclasses.replace(comp.kernels, segment_sum=record)
        _, sys_ = comp.assemble(problem.stacked_variables())
        ctx = comp.ctx(opts)
        ctx.linops.solve(sys_, 1e-2 * ctx.linops.diag_max(sys_).item())
        cases.update(seen)
        del comp, sys_, ctx
    records = {}
    for label, (data, st) in cases.items():
        record = b6_case(label, data, st, timed=not label.startswith("synthetic"))
        if record is not None:
            records[label] = record
    return records


def b6_case(label, data, st, timed=True):
    """B6 on one input against its plain version (float64 and float32),
    two launches bit-identical; ``timed``: its time by events and in a CUDA
    graph beside its plain version's, ``torch.segment_reduce``'s and its
    byte bound, returned as a ``kernels`` record (else None)."""
    from nllstpu_torch.ops import segment_sum

    kern, plain = segment_sum.segment_block_sum, segment_sum.segment_block_sum_reference
    ref = plain(data.double(), st)
    out64, out32 = kern(data.double(), st), kern(data.float(), st)
    again64, again32 = kern(data.double(), st), kern(data.float(), st)
    torch.cuda.synchronize()
    e64 = check(f"B6 f64 {label}", [out64], [ref], TOL_F64)[0]
    e32 = check(f"B6 f32 {label}", [out32], [ref], TOL_B1_F32)[0]
    if not (torch.equal(out64, again64) and torch.equal(out32, again32)):
        raise AssertionError(f"B6 {label}: two launches differ")
    line = (f"B6 {label} (N {data.shape[0]}, L {st.shape[0] - 1}): rel err f64 "
            f"{e64:.2e} f32 {e32:.2e}, two launches bit-identical")
    if not timed:
        print(line, flush=True)
        return None
    f32 = data.float()
    n_run = int(st[-1])
    lib_in, lib_off = f32[:n_run], st.long()
    ms = time_ms(lambda: kern(f32, st))
    plain_ms = time_ms(lambda: plain(f32, st))
    library_ms = time_ms(lambda: torch.segment_reduce(lib_in, "sum", offsets=lib_off, axis=0))
    device_ms = graph_ms(lambda: kern(f32, st))
    library_device_ms = graph_ms(
        lambda: torch.segment_reduce(lib_in, "sum", offsets=lib_off, axis=0))
    # The library computes the same function (held in float64); its
    # float32 error is printed beside B6's: on one run of 1.25M rows
    # (the adaptive kernel's rows) a float32 sum in the order of a
    # single pass loses digits that B6's two-level order keeps.
    lib = torch.segment_reduce(lib_in, "sum", offsets=lib_off, axis=0)
    lib64 = torch.segment_reduce(data.double()[:n_run], "sum", offsets=lib_off, axis=0)
    if rel_err(lib64, ref) > TOL_F64:
        raise AssertionError(f"B6 {label}: torch.segment_reduce disagrees")
    line += f", torch.segment_reduce f32 {rel_err(lib, ref):.2e}"
    b = bound(nbytes(lib_in, st, out32), lib_in.numel())
    print(f"{line} | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.segment_reduce {library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms"
          f" ({b['bound_by']}); in a CUDA graph: kernel {device_ms:.4f} ms, "
          f"torch.segment_reduce {library_device_ms:.4f} ms", flush=True)
    return dict(max_abs_err=abs_err(out32, ref), ms=ms, plain_ms=plain_ms,
                **b, library_ms=library_ms, graph_ms=device_ms,
                library_graph_ms=library_device_ms)


def adaptive_inputs(device):
    """The inputs B7 and B5 receive on the adaptive main path, on the
    per-cost path through ``solver="schur"`` and on this slice's direct
    paths (the adaptive per-cost and per-camera-kernel ones): ``({path: B7
    input}, {path: B5 input})`` (:func:`recorded_inputs`)."""
    place, reduce = {}, {}
    for label, (problem, route), opts in (
            (ADAPTIVE, (adaptive_problem(device)[0], {}), adaptive_options()),
            (PERCOST, percost_problem(device), generic_options("schur")),
            (ADAPTIVE_PERCOST, adaptive_all_problem(ADAPTIVE_PERCOST, device),
             adaptive_all_options(ADAPTIVE_PERCOST)),
            (PER_CAMERA, adaptive_all_problem(PER_CAMERA, device),
             adaptive_all_options(PER_CAMERA))):
        place[label], reduce[label] = recorded_inputs(problem, route, opts)
    return place, reduce


def recorded_inputs(problem, route, opts):
    """The inputs B7 and B5 receive on a direct path: one assembly and one
    damped solve of its compiled problem, with recorders in place of the
    two kernels that keep a copy of what they are given (B7's first
    launch)."""
    from nllstpu_torch.core.optimize import compile_problem

    comp = compile_problem(problem, route.get("unfixed"), solver=opts.solver,
                           schur_family=opts.schur_family)
    kern, seen = comp.kernels, {}

    def place(we, lstarts, colbase, wc):
        seen.setdefault("place_w", (we.clone(), lstarts, colbase, wc))
        return kern.place_w(we, lstarts, colbase, wc)

    def reduce(w, h_inv, g_l, pairs):
        seen["reduce_s"] = (w.clone(), h_inv.clone(), g_l.clone(), pairs)
        return kern.reduce_external(w, h_inv, g_l, pairs)

    comp.kernels = dataclasses.replace(kern, place_w=place, reduce_external=reduce)
    _, sys_ = comp.assemble(problem.stacked_variables())
    ctx = comp.ctx(opts)
    ctx.linops.solve(sys_, 1e-2 * ctx.linops.diag_max(sys_).item())
    return seen["place_w"], seen["reduce_s"]


def phase_b7(device, main_inputs):
    """B7 against its plain version on the main paths' inputs
    (``main_inputs``, by path: the adaptive and the per-cost one) and on a
    synthetic case: empty runs, cameras seen twice in a run, dropped
    costs (a negative column and one past W's columns), and a float64 row
    of 72 KB (past the 48 KB of static shared memory).  A record per main
    path."""
    from nllstpu_torch.ops import w_place

    kern, plain = w_place.place_w, w_place.place_w_reference
    gen = torch.Generator().manual_seed(7)
    L, dl, dr_s, n_r = 300, 3, 9, 333
    lengths = torch.randint(0, 40, (L,), generator=gen)
    lengths[::7] = 0
    lstarts = torch.cat([torch.zeros(1, dtype=torch.long), lengths.cumsum(0)]).int()
    n = int(lstarts[-1])
    wc = n_r * dr_s + 3
    colbase = (torch.randint(0, n_r, (n,), generator=gen) * dr_s).int()
    colbase[::11] = -1
    colbase[5::13] = wc - dr_s + 1
    cases = {
        **main_inputs,
        "synthetic": (torch.randn(n, dl, dr_s, generator=gen, dtype=torch.float64),
                      lstarts, colbase, wc),
    }
    records = {}
    for label, (we, lst, cb, wc) in cases.items():
        we, lst, cb = we.to(device), lst.to(device), cb.to(device)
        ref = plain(we.double(), lst, cb, wc)
        out64, out32 = kern(we.double(), lst, cb, wc), kern(we.float(), lst, cb, wc)
        again = kern(we.float(), lst, cb, wc)
        torch.cuda.synchronize()
        e64 = check(f"B7 f64 {label}", [out64], [ref], TOL_B57_F64)[0]
        e32 = check(f"B7 f32 {label}", [out32], [ref], TOL_B57_F32)[0]
        if not torch.equal(out32, again):
            raise AssertionError(f"B7 {label}: two launches differ")
        line = (f"B7 {label} (B {we.shape[0]}, W {tuple(out32.shape)}): rel err f64 "
                f"{e64:.2e} f32 {e32:.2e}, deterministic")
        if label not in main_inputs:
            print(line, flush=True)
            continue
        f32 = we.float()
        keep, idx = w_place.flat_index(lst, cb, *f32.shape[1:], wc)
        vals = torch.where(keep, f32.reshape(-1), 0)
        wz = torch.zeros(out32.numel(), dtype=torch.float32, device=device)
        lib = wz.clone().index_add_(0, idx, vals).view(out32.shape)
        if rel_err(lib, ref) > TOL_B57_F32:
            raise AssertionError(f"B7 {label}: index_add_ disagrees")
        ms = time_ms(lambda: kern(f32, lst, cb, wc))
        device_ms = graph_ms(lambda: kern(f32, lst, cb, wc))
        plain_ms = time_ms(lambda: plain(f32, lst, cb, wc))
        library_ms = time_ms(lambda: wz.index_add_(0, idx, vals))
        zeros_ms = time_ms(lambda: torch.zeros(
            out32.numel(), dtype=torch.float32, device=device).index_add_(0, idx, vals))
        b = bound(nbytes(f32, lst, cb, out32), int(keep.sum()))
        print(f"{line} | kernel {ms:.4f} ms (in a CUDA graph {device_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, index_add_ into a zeroed W {library_ms:.4f} ms, "
              f"torch.zeros + index_add_ {zeros_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']})", flush=True)
        records[label] = dict(max_abs_err=abs_err(out32, ref), ms=ms, plain_ms=plain_ms, **b,
                              graph_ms=device_ms, library_ms=library_ms,
                              zeros_library_ms=zeros_ms)
    return records


def structured_case(gen, L, dl, widths, spare):
    """A synthetic B5 input ``(w, h_inv, g_l, tables)``: W zero outside a
    random block structure (blocks of ``widths`` with up to ``spare``
    columns between them, landmark l holding a random subset, every 9th
    none), and that structure's host tables."""
    from nllstpu_torch.ops import schur_reduce

    widths = torch.as_tensor(widths)
    bcol = (torch.cumsum(widths + torch.randint(0, spare + 1, widths.shape, generator=gen), 0)
            - widths)
    held = torch.rand(L, len(widths), generator=gen) < 0.3
    held[::9] = False
    lmk, blk = held.nonzero(as_tuple=True)
    w = torch.zeros(L, dl, int(bcol[-1] + widths[-1] + spare), dtype=torch.float64)
    for b in range(len(widths)):
        rows = lmk[blk == b]
        w[rows, :, int(bcol[b]) : int(bcol[b] + widths[b])] = torch.randn(
            len(rows), dl, int(widths[b]), generator=gen, dtype=torch.float64)
    a = torch.randn(L, dl, dl, generator=gen, dtype=torch.float64)
    h = a @ a.transpose(1, 2) + 2.0 * torch.eye(dl, dtype=torch.float64)
    return (w, torch.linalg.inv(h).permute(1, 2, 0).contiguous(),
            torch.randn(dl, L, generator=gen, dtype=torch.float64),
            schur_reduce.row_tables(lmk.numpy(), blk.numpy(), L, bcol.numpy(), widths.numpy()))


def phase_b5(device, main_inputs):
    """B5 against its plain version on the main paths' inputs
    (``main_inputs``, by path: the adaptive one, dl = 3, wc = 1155, and the
    per-cost one, wc = 441, each over its column-block structure) and at
    dl = 5 on a synthetic W zero outside a random block structure; two
    launches give the same bits.  A record per main path, with both
    bounds: the structural one (``bound_ms``) and the dense product's."""
    from nllstpu_torch.ops import schur_reduce

    kern, plain = schur_reduce.reduce_s, schur_reduce.reduce_s_reference
    gen = torch.Generator().manual_seed(5)
    *syn, syn_tables = structured_case(gen, 2048, 5, [9] * 40 + [3, 16, 1], 2)
    cases = {
        **main_inputs,
        "dl=5 synthetic structure": (*syn, schur_reduce.upload_tables(syn_tables, device)),
    }
    records = {}
    for label, (*inputs, pairs) in cases.items():
        inputs = [t.to(device) for t in inputs]
        ref = plain(*[t.double() for t in inputs])
        plain32 = plain(*[t.float() for t in inputs])
        out64 = kern(*[t.double() for t in inputs], pairs=pairs)
        out32 = kern(*[t.float() for t in inputs], pairs=pairs)
        again = kern(*[t.float() for t in inputs], pairs=pairs)
        torch.cuda.synchronize()
        e64 = check(f"B5 f64 {label}", out64, ref, TOL_B57_F64)
        e32 = [rel_err(x, y) for x, y in zip(out32, ref)]
        p32 = [rel_err(x, y) for x, y in zip(plain32, ref)]
        tol32 = [max(TOL_B57_F32, 10 * p) for p in p32]
        if not all(e <= t for e, t in zip(e32, tol32)):
            raise AssertionError(f"B5 f32 {label}: errors s_sum/rhs {e32} exceed {tol32}")
        if not all(torch.equal(x, y) for x, y in zip(out32, again)):
            raise AssertionError(f"B5 {label}: two launches differ")
        if not (torch.equal(out32[0], out32[0].T) and torch.equal(out64[0], out64[0].T)):
            raise AssertionError(f"B5 {label}: s_sum is not exactly symmetric")
        line = (f"B5 {label} (W {tuple(inputs[0].shape)}, {pairs.pairs.shape[0]} block pairs, "
                f"{pairs.links.shape[0]} links, {pairs.items.shape[0]} items): rel err "
                f"s_sum/rhs f64 {['%.2e' % e for e in e64]}; f32 kernel "
                f"{['%.2e' % e for e in e32]} plain {['%.2e' % e for e in p32]} tolerance "
                f"{['%.2e' % t for t in tol32]}; two launches bit-identical, s_sum symmetric")
        if label not in main_inputs:
            print(line, flush=True)
            continue
        f32 = [t.float() for t in inputs]
        ms = time_ms(lambda: kern(*f32, pairs=pairs))
        device_ms = graph_ms(lambda: kern(*f32, pairs=pairs))
        plain_ms = time_ms(lambda: plain(*f32))
        library_ms = time_ms(gemm_call(*f32[:2]))
        pb, pf = struct_work(pairs, f32[0].shape[1], 4)
        b = bound(pb + nbytes(*out32), pf)
        dense = bound(nbytes(*f32, *out32), reduce_flops(*f32[0].shape))
        print(f"{line} | kernel {ms:.4f} ms (in a CUDA graph {device_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, cuBLAS Y^T W {library_ms:.4f} ms, structural bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {pb} bytes, {pf} operations), dense "
              f"bound {dense['bound_ms']:.4f} ms ({dense['bound_by']})", flush=True)
        records[label] = dict(max_abs_err=max(abs_err(x, y) for x, y in zip(out32, ref)),
                              ms=ms, plain_ms=plain_ms, **b, dense_bound_ms=dense["bound_ms"],
                              graph_ms=device_ms, library_ms=library_ms)
    return records


def dual_compile(name, device, w_impl="fused"):
    """``(problem, compiled, route)`` of a dual-sorted path, compiled
    through ``w_impl`` (``"fused_all"``: the same problem through B1)."""
    from nllstpu_torch.core.optimize import compile_problem

    problem, route = dual_problem(name, device)
    comp = compile_problem(problem, route["unfixed"], solver="schur",
                           schur_family=bench_options().schur_family,
                           w_impl=w_impl)
    return problem, comp, route


def phase_b8(device):
    """B8 against its plain version on both dual-sorted paths' inputs (the
    obs-major tiles of one assembly) and on a small case with duplicate
    cameras and dustbin slots; beside each path's shape its time, its
    bound, the plain version's and B1's on the same inputs (with B6 over
    B1's camera rows: the whole function).  A record per path."""
    from nllstpu_torch.ops import fused_obs, schur

    kern, plain = fused_obs.fused_obs_leg, fused_obs.fused_obs_leg_reference
    cases = {}
    for name in DUAL:
        problem, comp, _ = dual_compile(name, device)
        (batch,), (fast,) = comp.batches, comp.schur_info.fast
        _, args = schur.fused_inputs(
            batch, problem.stacked_variables(), comp.schur_info, fast, comp.dtype
        )
        cases[name] = (args[:4], args[4:], comp.dtype, batch.n, (fast.cpos, fast.cstarts))
    cases["small dup+dustbin"] = (*small_assembly_case(8, e_start=0), None, None, None)
    records = {}
    for label, (fl, it, dtype, n_obs, tables) in cases.items():
        fl = [t.to(device) for t in fl]
        it = (it[0].to(device),) + tuple(it[1:])
        ref = plain(*[t.double() for t in fl], *it)
        out64 = kern(*[t.double() for t in fl], *it)
        out32 = kern(*[t.float() for t in fl], *it)
        torch.cuda.synchronize()
        e64 = check(f"B8 f64 {label}", out64, ref, TOL_F64)
        e32 = check(f"B8 f32 {label}", out32, ref, TOL_B1_F32)
        line = (f"B8 {label} (K {fl[0].shape[2]}, L {fl[0].shape[3]}, W "
                f"{tuple(out64[2].shape)}): rel err h_ll/g_l/w f64 "
                f"{['%.2e' % e for e in e64]} f32 {['%.2e' % e for e in e32]}")
        if dtype is None:
            print(line, flush=True)
            continue
        own = [t.to(dtype) for t in fl]
        out = kern(*own, *it)
        ms = time_ms(lambda: kern(*own, *it))
        device_ms = graph_ms(lambda: kern(*own, *it))
        plain_ms = time_ms(lambda: plain(*own, *it))
        b1_ms = time_ms(lambda: fused_obs.fused_obs_all(*own, it[0], *tables, *it[1:]))
        b1_device_ms = graph_ms(lambda: fused_obs.fused_obs_all(*own, it[0], *tables, *it[1:]))
        n_r, dr_s, dl = it[1:4]
        b = bound(nbytes(*own, it[0], *out), assembly_flops(n_obs, dr_s, dl, camera_side=False),
                  dtype)
        print(f"{line} | {str(dtype)[6:]}: kernel {ms:.4f} ms (in a CUDA graph {device_ms:.4f} "
              f"ms), plain {plain_ms:.4f} ms, B1 on the same inputs {b1_ms:.4f} ms (in a CUDA "
              f"graph {b1_device_ms:.4f} ms), bound {b['bound_ms']:.4f} ms ({b['bound_by']})",
              flush=True)
        err = out64 if dtype == torch.float64 else out32
        records[label] = dict(max_abs_err=max(abs_err(x, y) for x, y in zip(err, ref)),
                              ms=ms, plain_ms=plain_ms, **b, graph_ms=device_ms)
    return records


def phase_determinism(device):
    """Gates: two assemblies must give the same bits in all five outputs
    through B1 (the pinhole bench), through B2 (Ladybug-49 and
    bench-realistic) and through the dual-sorted route (both of its
    paths); two float32 LM runs of the pinhole bench must give the same
    cost trace through B1 and through the dual-sorted route."""
    import nllstpu_torch as nt
    from nllstpu_torch.core.optimize import compile_problem

    def twice(label, problem, comp):
        variables = problem.stacked_variables()
        first, second = comp.assemble(variables)[1], comp.assemble(variables)[1]
        same = [torch.equal(a, b) for a, b in zip(first, second)]
        if not all(same):
            raise AssertionError(f"determinism {label}: two assemblies differ in "
                                 f"(a_rr, b_r, h_ll, g_l, W): {same}")
        print(f"determinism {label}: two assemblies bit-identical in a_rr, b_r, h_ll, g_l "
              f"and W", flush=True)

    for name in DUAL:
        problem, comp, _ = dual_compile(name, device)
        twice(f"{name} (dual-sorted, B8)", problem, comp)
    problem = bench_problem(device)
    twice("pinhole bench (B1)", problem,
          compile_problem(problem, solver="schur", schur_family=bench_options().schur_family))
    for name in BAL:
        problem = bal_problem(name, device)
        twice(f"{name} (B2)", problem,
              compile_problem(problem, solver="schur", schur_family=bench_options().schur_family))
    # At the rounding floor a last-bit change in the system changes which
    # damped trials pass, so equal traces show that nothing varies.
    for w_impl in ("fused_all", "fused"):
        traces = []
        for _ in range(2):
            problem, route = dual_problem(FUSED, device)
            traces.append(nt.optimize(problem, bench_options(), **{**route, "w_impl": w_impl}))
        print(f"determinism pinhole bench: two float32 LM runs through w_impl={w_impl!r}: "
              f"{len(traces[0].costs)} and {len(traces[1].costs)} iterations, best "
              f"{traces[0].best_cost!r} and {traces[1].best_cost!r}", flush=True)
        if traces[0].costs != traces[1].costs:
            raise AssertionError(f"determinism: two LM runs through w_impl={w_impl!r} "
                                 "give different cost traces")


def b4_inputs(device):
    """B4's inputs with their row tables: what the gauge-fixed float64 main
    path gives it in one damped solve (recorded, with that solve's h_ll
    and λ), the float32 pinhole bench system (W [8192, 3, 768]) with
    inverses formed in float64 at the same relative damping (the float32
    route itself sends it to B3), and a synthetic dl = 5 structure."""
    from nllstpu_torch.ops import schur

    problem, comp, _ = dual_compile(GAUGE, device)
    kern, seen = comp.kernels.reduce_lm, {}

    def record(w, h_inv, g_l, rows):
        seen[GAUGE] = (w.clone(), h_inv.clone(), g_l.clone(), rows)
        return kern(w, h_inv, g_l, rows)

    comp.kernels = dataclasses.replace(comp.kernels, reduce_lm=record)
    _, sys_ = comp.assemble(problem.stacked_variables())
    ops = comp.ctx().linops
    lam = 1e-2 * ops.diag_max(sys_).item()
    ops.solve(sys_, lam)
    damped = (sys_[2], lam)
    problem, comp, _ = dual_compile(FUSED, device)
    _, sys_ = comp.assemble(problem.stacked_variables())
    lam = 1e-2 * comp.ctx().linops.diag_max(sys_).item()
    seen["pinhole bench f32"] = (sys_[4], schur.SchurOps.damped_inverse(sys_[2], lam), sys_[3],
                                 comp.schur_info.w_rows)
    gen = torch.Generator().manual_seed(5)
    seen[B4_SYNTHETIC] = row_case(gen, 2048, 5, 80, 5, device, inverse=True)
    return seen, damped


def b4_f64_case(label, w, h_inv, g_l, rows, tol):
    """B4 in float64 against its plain version (within ``tol`` of the
    largest entry), two launches the same bits, s_sum exactly symmetric;
    its times (events and graph), its structural and dense bounds (float64
    operations), the plain version's and cuBLAS DGEMM's.  Returns the
    record."""
    from nllstpu_torch.ops import schur_reduce

    kern, plain = schur_reduce.reduce_s_lm, schur_reduce.reduce_s_reference
    f64 = [t.double() for t in (w, h_inv, g_l)]
    ref = plain(*f64)
    out64, again = kern(*f64, rows), kern(*f64, rows)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(out64, again)):
        raise AssertionError(f"B4 {label}: two launches differ")
    if not torch.equal(out64[0], out64[0].T):
        raise AssertionError(f"B4 {label}: s_sum is not exactly symmetric")
    e64 = check(f"B4 f64 {label}", out64, ref, tol)
    ms = time_ms(lambda: kern(*f64, rows))
    device_ms = graph_ms(lambda: kern(*f64, rows))
    plain_ms = time_ms(lambda: plain(*f64))
    library_ms = time_ms(gemm_call(*f64[:2]))
    L, dl, wc = f64[0].shape
    pb, pf = struct_work(rows, dl, 8)
    b = bound(pb + nbytes(*out64), pf, torch.float64)
    dense = bound(nbytes(*f64, *out64), reduce_flops(L, dl, wc), torch.float64)
    print(f"B4 {label} (W {tuple(w.shape)}, {rows.links.shape[0]} links in "
          f"{rows.items.shape[0]} items): rel err s_sum/rhs f64 {['%.2e' % e for e in e64]}; two "
          f"launches bit-identical, s_sum symmetric | kernel {ms:.4f} ms (in a CUDA graph "
          f"{device_ms:.4f} ms), plain {plain_ms:.4f} ms, cuBLAS Y^T W (DGEMM) "
          f"{library_ms:.4f} ms, structural bound {b['bound_ms']:.4f} ms ({b['bound_by']}: "
          f"{pb} bytes, {pf} operations), dense bound {dense['bound_ms']:.4f} ms "
          f"({dense['bound_by']})", flush=True)
    return dict(max_abs_err=max(abs_err(x, y) for x, y in zip(out64, ref)), ms=ms,
                plain_ms=plain_ms, **b, dense_bound_ms=dense["bound_ms"], graph_ms=device_ms,
                library_ms=library_ms)


def phase_b4(device, cases, damped):
    """B4 against its plain version over each system's row tables: in
    float64 on the gauge-fixed path's input (wc = 756, 1e-12) and in
    float32 and float64 on the pinhole bench system (wc = 768; float32
    within 1e-6 of the largest entry) and on a synthetic dl = 5 structure
    (float32 as B5's synthetic case); two launches give the same bits and
    s_sum is exactly symmetric; beside the main path's shape its time, its
    structural and dense bounds (float64 operations), the plain version's
    and cuBLAS DGEMM's.  Then the float64 solve's reduction as the solve
    runs it (``damped``: h_ll, λ): ``damped_inverse``, then B4.  A record
    for the main path."""
    from nllstpu_torch.ops import schur, schur_reduce

    kern, plain = schur_reduce.reduce_s_lm, schur_reduce.reduce_s_reference
    record = None
    for label, (*inputs, rows) in cases.items():
        if label == GAUGE:
            record = b4_f64_case(GAUGE, *inputs, rows, TOL_B57_F64)
            continue
        f64 = [t.double() for t in inputs]
        ref = plain(*f64)
        f32 = [t.float() for t in inputs]
        outs = {torch.float64: (kern(*f64, rows), kern(*f64, rows)),
                torch.float32: (kern(*f32, rows), kern(*f32, rows))}
        torch.cuda.synchronize()
        for dt, (out, again) in outs.items():
            if not all(torch.equal(x, y) for x, y in zip(out, again)):
                raise AssertionError(f"B4 {label} {dt}: two launches differ")
            if not torch.equal(out[0], out[0].T):
                raise AssertionError(f"B4 {label} {dt}: s_sum is not exactly symmetric")
        e64 = check(f"B4 f64 {label}", outs[torch.float64][0], ref, TOL_B57_F64)
        out32 = outs[torch.float32][0]
        p32 = [rel_err(x, y) for x, y in zip(plain(*f32), ref)]
        e32 = [rel_err(x, y) for x, y in zip(out32, ref)]
        # A main path's system within TOL_B57_F32; the synthetic case, as
        # B5's, within ten times the plain version's own error too.
        tol32 = [TOL_B57_F32 if label != B4_SYNTHETIC else max(TOL_B57_F32, 10 * p)
                 for p in p32]
        if not all(e <= t for e, t in zip(e32, tol32)):
            raise AssertionError(f"B4 f32 {label}: errors s_sum/rhs {e32} exceed {tol32}")
        print(f"B4 {label} (W {tuple(inputs[0].shape)}, {rows.links.shape[0]} links in "
              f"{rows.items.shape[0]} items): rel err s_sum/rhs f64 {['%.2e' % e for e in e64]}; "
              f"f32 kernel {['%.2e' % e for e in e32]} plain (cuBLAS) "
              f"{['%.2e' % e for e in p32]}; two launches bit-identical, s_sum symmetric",
              flush=True)
    h_ll, lam = damped
    w, _, g_l, rows = cases[GAUGE]
    solve_ms = time_ms(lambda: kern(w, schur.SchurOps.damped_inverse(h_ll, lam), g_l, rows))
    inv_ms = time_ms(lambda: schur.SchurOps.damped_inverse(h_ll, lam))
    print(f"f64 solve reduction {GAUGE} (W {tuple(w.shape)}): damped_inverse + B4 "
          f"{solve_ms:.4f} ms (damped_inverse alone {inv_ms:.4f} ms)", flush=True)
    return {GAUGE: record}


def phase_gauge_main(device, smi):
    """The gauge-fixed float64 main path through ``nt.optimize(...,
    unfixed=cams[2:] + lmks, w_impl="fused")``: B8 and B4, never B1, B2,
    B3, B5, B6 or B7; held to the JAX package's CPU float64 trace (start cost
    1e-12, each iteration both runs made and the best cost 1e-9)."""
    problem, route = dual_problem(GAUGE, device)
    launches, result = phase_main(
        GAUGE, problem, GAUGE_REF["start"], GAUGE_REF["best"], 1e-9,
        needs=("fused_obs_leg", "reduce_s_lm"),
        never=("fused_obs_all", "fused_obs_all_into", "reduce_s_damped", "place_w", "reduce_s",
               "segment_block_sum"),
        **route,
    )
    ref = GAUGE_REF["costs"]
    n = min(len(ref), len(result.costs), 10)
    errs = [abs(a - b) / abs(b) for a, b in zip(result.costs[:n], ref)]
    best = abs(result.best_cost - GAUGE_REF["best"]) / GAUGE_REF["best"]
    start = abs(result.start_cost - GAUGE_REF["start"]) / GAUGE_REF["start"]
    print(f"{GAUGE} main path: costs {result.costs!r} against the JAX package's CPU float64 "
          f"{list(ref)!r}; rel err start {start:.2e}, per iteration "
          f"{['%.2e' % e for e in errs]}, best {best:.2e} | {smi}", flush=True)
    if not (start <= 1e-12 and n >= len(ref) - 1 and max(errs) <= 1e-9 and best <= 1e-9):
        raise AssertionError(f"{GAUGE}: the trace departs from the JAX package's")
    return launches


#: The direct adaptive path's recovered (σ1, σ2, w), printed beside the
#: implicit one's.
DIRECT_SIGMAS = []


def phase_adaptive_main(device, smi):
    """The adaptive main path through ``nt.optimize``: B5, B6 and B7, never
    B1, B2 or B3; the JAX package's start and best cost (sign-safe gate)
    and its recovered kernel parameters."""
    import nllstpu_torch as nt

    problem, kh = adaptive_problem(device)
    launches, result = phase_main(
        ADAPTIVE, problem, ADAPTIVE_REF["start"], ADAPTIVE_REF["best"], 1e-2,
        needs=("segment_block_sum", "place_w", "reduce_s"),
        never=("fused_obs_all", "fused_obs_all_into", "reduce_s_damped"),
        options=adaptive_options(),
    )
    sw = nt.ContaminatedGaussian.sigmas_weight(problem.get_value(kh)).double()
    DIRECT_SIGMAS.extend(sw.tolist())
    ref = torch.tensor(ADAPTIVE_REF["sigmas_weight"], dtype=torch.float64)
    err = ((sw - ref).abs() / ref.abs()).tolist()
    print(f"{ADAPTIVE} main path: (sigma1, sigma2, w) {sw.tolist()} against the JAX "
          f"package's {ref.tolist()}, rel err {['%.2e' % e for e in err]} (tolerance "
          f"{ADAPTIVE_REF['tol']}); cost every 10th iteration {result.costs[9::10]} | {smi}",
          flush=True)
    if not all(e <= t for e, t in zip(err, ADAPTIVE_REF["tol"])):
        raise AssertionError(f"{ADAPTIVE}: kernel parameters {sw.tolist()} != {ref.tolist()}")
    return launches


def _reset_counts():
    from nllstpu_torch.ops import fused_obs, schur_reduce, segment_sum, w_place

    fused_obs.LAUNCHES = 0
    fused_obs.INTO_LAUNCHES = 0
    fused_obs.LEG_LAUNCHES = 0
    schur_reduce.LAUNCHES = 0
    schur_reduce.LM_LAUNCHES = 0
    schur_reduce.EXTERNAL_LAUNCHES = 0
    segment_sum.LAUNCHES = 0
    w_place.LAUNCHES = 0


def _read_counts():
    from nllstpu_torch.ops import fused_obs, schur_reduce, segment_sum, w_place

    return {
        "fused_obs_all": fused_obs.LAUNCHES,
        "fused_obs_all_into": fused_obs.INTO_LAUNCHES,
        "fused_obs_leg": fused_obs.LEG_LAUNCHES,
        "reduce_s_damped": schur_reduce.LAUNCHES,
        "reduce_s_lm": schur_reduce.LM_LAUNCHES,
        "reduce_s": schur_reduce.EXTERNAL_LAUNCHES,
        "segment_block_sum": segment_sum.LAUNCHES,
        "place_w": w_place.LAUNCHES,
    }


def phase_main(label, problem, start_ref, best_ref, slack, needs, never=(),
               options=None, **route):
    """The user's entry point on one problem, with the launch counts set to
    0 just before and read just after; ``route`` (``unfixed``, ``w_impl``)
    goes to ``nt.optimize``.  ``needs`` are the kernels the path must
    launch, ``never`` those it must not.  A run that ends on a NaN cost or
    step fails.  Returns the launch counts and the result."""
    import nllstpu_torch as nt
    from nllstpu_torch.core import structs

    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    result = nt.optimize(problem, options or bench_options(), **route)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    print(f"main path {label}: {result.num_iterations} iterations in {wall:.3f} s, "
          f"start cost {result.start_cost!r}, best cost {result.best_cost!r}, "
          f"{result.linear_solves} damped solves, launches {launches}, peak device "
          f"memory {peak_memory(held)}, ended: "
          f"{' '.join(result.termination_reasons())}", flush=True)
    if not all(launches[k] > 0 for k in needs) or any(launches[k] for k in never):
        raise AssertionError(
            f"{label}: launches {launches}; needed {needs}, never {never}"
        )
    # Sign-safe: an adaptive kernel's cost may be negative.
    if not abs(result.start_cost - start_ref) <= 1e-4 * abs(start_ref):
        raise AssertionError(f"{label}: start cost {result.start_cost} != {start_ref}")
    if not result.best_cost <= best_ref + slack * abs(best_ref):
        raise AssertionError(
            f"{label}: best cost {result.best_cost} > {best_ref} + {slack}·|{best_ref}|"
        )
    final = problem.stacked_variables()
    if not all(torch.isfinite(v).all() for v in final.values()):
        raise AssertionError(f"{label}: non-finite final variables")
    if result.termination & (structs.TERM_COST_NAN | structs.TERM_STEP_NAN):
        raise AssertionError(f"{label}: the run ended on a NaN cost or step")
    return launches, result


def peak_memory(held: int) -> str:
    """The peak device memory since the last reset, and how far it rose
    above ``held``, the bytes allocated at the reset (what the process
    already held: problems and results of earlier phases)."""
    peak = torch.cuda.max_memory_allocated()
    return (f"{peak / 2**30:.3f} GiB ({(peak - held) / 2**20:.1f} MiB above the "
            f"{held / 2**30:.3f} GiB held)")


def run_driver(driver, comp, opts, vars0, phase=None):
    """One optimization loop of ``comp`` through ``driver``: "graph"
    (``run_graphs``; its warm-up and captures not in ``seconds``),
    "stepped" (``run_stepped``, the kernels) or "plain" (``run_loop`` over
    the plain versions, which cannot be captured).  Returns the final
    state with ``seconds`` (the loop's wall time, fenced) and ``peak``
    (:func:`peak_memory` from the runner's construction on)."""
    from nllstpu_torch.core.optimize import _GraphRunner, run_loop, run_stepped

    gc.collect()  # an earlier runner's graphs and their pool go first
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    if driver == "graph":
        runner = _GraphRunner(comp, opts, vars0, phase=phase)
        t0 = time.perf_counter()
        final = runner.run()
    elif driver == "stepped":
        t0 = time.perf_counter()
        final = run_stepped(comp, opts, vars0, phase=phase)
    else:
        ctx = comp.ctx(opts, phase=phase)
        t0 = time.perf_counter()
        final = run_loop(comp.assemble, comp.cost, ctx, opts, vars0)
        final["cg_iters"] = list(getattr(ctx.linops, "cg_iters", []))
    torch.cuda.synchronize()
    final["wall"] = time.perf_counter() - t0
    final["peak"] = peak_memory(held)
    return final


def phase_timed(label, problem, driver, phases: bool, options=None, unfixed=None,
                w_impl="fused_all"):
    """The loop for ``TIMED_ITERS`` iterations through ``driver`` (see
    :func:`run_driver`); with ``phases``, CUDA events around every phase
    (the graph driver: around every replay), and on the implicit path the
    PCG iterations per damped solve and one reduced matvec's time."""
    from nllstpu_torch.core.optimize import compile_problem

    opts = dataclasses.replace(options or bench_options(), max_iters=TIMED_ITERS)
    comp = compile_problem(problem, unfixed, solver=opts.solver,
                           schur_family=opts.schur_family, plain=driver == "plain",
                           w_impl=w_impl)
    timer = PhaseTimer() if phases else None
    final = run_driver(driver, comp, opts, problem.stacked_variables(), phase=timer)
    rate = final["iternum"] / final["wall"]
    line = (
        f"{ITER_NAME[opts.iterator]} {label} {driver}{' (phase events on)' if phases else ''}: "
        f"{final['iternum']} iterations, {final['nsolve']} damped solves in "
        f"{final['wall'] * 1e3:.3f} ms = {rate:.3f} it/s, best cost "
        f"{float(final['bestcost'])!r}, peak device memory {final['peak']}"
    )
    if driver == "graph":
        line += (f", warm-up and capture {final['capture_seconds']:.3f} s, "
                 f"{final['replays']} replays")
    if phases:
        line += " | " + ", ".join(
            f"{k} {n}x {ms / n:.4f} ms/call" for k, (n, ms) in timer.totals().items()
        )
    if phases and (comp.implicit or comp.cg_ops is not None):
        ops = comp.ctx(opts).linops
        _, sys_ = comp.assemble(final["variables"])
        lam = 1e-2 * ops.diag_max(sys_).item()
        if comp.implicit:
            h_inv = ops.damped_inverse(sys_[2], lam)
            v = torch.randn(comp.schur_info.dim_reduced, dtype=comp.dtype, device=h_inv.device)
            matvec_ms = time_ms(lambda: ops.s_matvec(sys_, h_inv, lam, v))
        else:
            v = torch.randn(ops.dim, dtype=comp.dtype, device=comp.device)
            matvec_ms = time_ms(lambda: ops.matvec(sys_, lam, v))
        cg = final["cg_iters"]
        line += (f" | PCG iterations per solve {cg} (mean {sum(cg) / max(len(cg), 1):.2f}), "
                 f"{'reduced ' if comp.implicit else ''}matvec {matvec_ms:.4f} ms/call")
    print(line, flush=True)
    return rate


#: The CUDA runtime calls that enqueue work: what a host launch costs.
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
               "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def phase_profile(label, problem, driver, options=None, unfixed=None, w_impl="fused_all"):
    """The 10-iteration loop through ``driver`` ("graph" or "stepped") under
    ``torch.profiler``: wall time, the summed device time of every kernel,
    the device's idle share, the host's launches per iteration (the CUDA
    runtime calls that enqueue work, graph replays among them), and the
    kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from nllstpu_torch.core.optimize import _GraphRunner, compile_problem, run_stepped

    opts = dataclasses.replace(options or bench_options(), max_iters=TIMED_ITERS)
    comp = compile_problem(problem, unfixed, solver=opts.solver,
                           schur_family=opts.schur_family, w_impl=w_impl)
    vars0 = problem.stacked_variables()
    runner = _GraphRunner(comp, opts, vars0) if driver == "graph" else None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        final = runner.run() if runner else run_stepped(comp, opts, vars0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [
        (e.key, e.count, e.self_device_time_total / 1e3)
        for e in events if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    api = {e.key: e.count for e in events
           if e.device_type == torch.autograd.DeviceType.CPU and e.key in LAUNCH_APIS}
    busy_ms = sum(ms for _, _, ms in kernels)
    top = sorted(kernels, key=lambda k: -k[2])[:6]
    # The port's own kernels: those of ops/csrc's anonymous namespaces (not
    # PyTorch's, whose template arguments name at::).
    port = [k for k in kernels
            if k[0].startswith("void (anonymous namespace)::") and "at::" not in k[0]]
    n = final["iternum"]
    print(f"profile {ITER_NAME[opts.iterator]} {label} {driver}, {n} iterations, {final['nsolve']} damped solves: wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%, {sum(c for _, c, _ in kernels)} kernels "
          f"on the device; host launches per iteration {sum(api.values()) / n:.1f} "
          f"({', '.join(f'{k} {v / n:.1f}' for k, v in sorted(api.items()))})"
          + (f", graph replays per iteration {final['replays'] / n:.1f}" if runner else "")
          + " | " + "; ".join(f"{name[:60]} {c}x {ms:.3f} ms" for name, c, ms in top)
          + " | the port's kernels: " + "; ".join(
              f"{name.split('::')[1].split('<')[0]}{name[name.find('<'):name.find('>') + 1]}"
              f" {c}x {ms:.3f} ms ({100 * ms / busy_ms:.1f}% of busy)"
              for name, c, ms in sorted(port, key=lambda k: -k[2])), flush=True)


def phase_drivers(device, smi):
    """The graph driver (``nt.optimize``) against the stepped driver
    (``callback=nt.null_callback``) on the pinhole bench (float32), the
    gauge-fixed float64 path and Ladybug-49, 30 iterations: the same
    iterations and damped solves, each iteration's cost within 1e-6
    (float32) or 1e-12 (float64) relative; prints whether the bits held.
    Two graph-driver runs of the pinhole bench must give one trace."""
    import nllstpu_torch as nt

    cases = (
        ("pinhole bench", lambda: (bench_problem(device), {}), 3),
        (GAUGE, lambda: dual_problem(GAUGE, device), 2),
        ("Ladybug-49", lambda: (bal_problem("Ladybug-49", device), {}), 2),
    )
    for label, make, n_runs in cases:
        runs = []
        for i in range(n_runs):
            problem, route = make()
            cb = dict(callback=nt.null_callback) if i == 1 else {}
            runs.append(nt.optimize(problem, bench_options(), **route, **cb))
        graph, stepped = runs[:2]
        tol = 1e-12 if problem.dtype == torch.float64 else 1e-6
        n = min(len(graph.costs), len(stepped.costs))
        err = max(abs(a - b) / abs(b) for a, b in zip(graph.costs[:n], stepped.costs[:n]))
        same = graph.costs == stepped.costs
        print(f"drivers {label}: graph {graph.num_iterations} iterations, "
              f"{graph.linear_solves} damped solves, best {graph.best_cost!r}; stepped "
              f"{stepped.num_iterations} iterations, {stepped.linear_solves} damped solves, "
              f"best {stepped.best_cost!r}; max rel cost difference {err:.2e} (tolerance "
              f"{tol:g}); bits {'held' if same else 'differ'}"
              + ("; two graph-driver runs give one trace" if n_runs == 3
                 and runs[2].costs == graph.costs else "") + f" | {smi}", flush=True)
        if (graph.num_iterations, graph.linear_solves) != (
                stepped.num_iterations, stepped.linear_solves) or not err <= tol:
            raise AssertionError(f"drivers {label}: the graph and stepped drivers disagree")
        if n_runs == 3 and runs[2].costs != graph.costs:
            raise AssertionError(f"drivers {label}: two graph-driver runs give two traces")


ITER_NAME = {"newton": "Newton", "levenberg_marquardt": "LM", "dogleg": "dogleg",
             "gradient_descent": "GD"}


def iter_options(iterator, base=None):
    return dataclasses.replace(base or bench_options(), iterator=iterator)


def gauge_problem(dtype, device):
    """``(problem, route)``: the pinhole bench problem in ``dtype`` with its
    first two cameras fixed; float64 through the dual-sorted route (B8 and
    B4, as the gauge-fixed LM path), float32 through B1 (B6's camera sum
    and B3)."""
    from nllstpu_torch.models.ba import make_pinhole_ba, perturb_ba

    problem, cams, lmks = make_pinhole_ba(
        ncameras=NCAM, nlandmarks=NLMK, prop_visible=VIS, noise=NOISE, dtype=dtype,
        batched="cm", device=device,
    )
    perturb_ba(problem, lmks, 0.05, seed=5)
    w_impl = "fused" if dtype == torch.float64 else "fused_all"
    return problem, dict(unfixed=cams[2:] + lmks, w_impl=w_impl)


def posegraph_problem(device, n_poses=None, n_loops=None):
    """``(problem, route)``: the parking-garage-sized pose graph in float64,
    pose 0 fixed."""
    from nllstpu_torch.models.posegraph import make_pose_graph

    problem, poses, _ = make_pose_graph(n_poses or POSES, LOOPS if n_loops is None else n_loops,
                                        noise=0.01, dtype=torch.float64, device=device)
    return problem, dict(unfixed=poses[1:])


def posegraph_options(iterator, solver="dense"):
    import nllstpu_torch as nt

    return nt.Options(iterator=iterator, solver=solver, max_iters=20, rel_dcost=1e-12,
                      max_time=float("inf"))


#: The pieces whose read holds a solve at λ = 0 (dogleg's legs; Newton's
#: trials) and their LU retakes.
ZERO_SOLVES = ("leg", "leg_lu", "pcg_leg", "trial", "trial_lu")


@contextlib.contextmanager
def piece_counts():
    """Counts the graph driver's replays per piece while it is open (a
    "…_lu" replay is a Cholesky that fell to LU), and the solves of
    :data:`ZERO_SOLVES` that the iterator took (an LU one, or a Cholesky
    one whose flag held) and whose read came out non-finite ("non-finite
    <piece>")."""
    from nllstpu_torch.core import optimize

    counts = collections.Counter()
    real = optimize._GraphRunner._step

    def step(self, name):
        out = real(self, name)
        counts[name] += 1
        if name in ZERO_SOLVES:
            read = out if torch.is_tensor(out) else out[2]
            ok = read[5 if "leg" in name else 4]
            taken = name.endswith("_lu") or name == "pcg_leg" or bool(ok)
            if taken and not bool(torch.isfinite(read[:4]).all()):
                counts[f"non-finite {name}"] += 1
        return out

    optimize._GraphRunner._step = step
    try:
        yield counts
    finally:
        optimize._GraphRunner._step = real


def trace_gate(label, result, ref, tol=1e-9):
    """The float64 trace gate (as the gauge-fixed LM path's): start cost
    within 1e-12, every iteration both runs made and the best cost within
    ``tol`` relative."""
    n = min(len(ref["costs"]), len(result.costs))
    errs = [abs(a - b) / abs(b) for a, b in zip(result.costs[:n], ref["costs"])]
    best = abs(result.best_cost - ref["best"]) / abs(ref["best"])
    start = abs(result.start_cost - ref["start"]) / abs(ref["start"])
    print(f"{label}: costs {result.costs!r} against the JAX package's CPU float64 "
          f"{list(ref['costs'])!r}; rel err start {start:.2e}, per iteration "
          f"{['%.2e' % e for e in errs]}, best {best:.2e}", flush=True)
    if not (start <= 1e-12 and n >= 1 and max(errs) <= tol and best <= tol):
        raise AssertionError(f"{label}: the trace departs from the JAX package's")


#: Launch-count expectations of this slice's main paths: (needed, never).
ALL_KERNELS = ("fused_obs_all", "fused_obs_all_into", "fused_obs_leg", "reduce_s_damped",
               "reduce_s_lm", "reduce_s", "segment_block_sum", "place_w")
def _never(needs, also=()):
    return tuple(k for k in ALL_KERNELS if k not in needs and k not in also)


def phase_iter_main(device, smi):
    """Newton, dogleg and gradient descent through ``nt.optimize`` (the
    graph driver) with the launch counts set to 0 just before and read just
    after, each against the JAX package's CPU run (:data:`ITER_REF`).
    Returns ``(launches, results)``: per path the launch counts and the
    result."""
    import nllstpu_torch as nt

    newton, dogleg, gd = nt.NEWTON, nt.DOGLEG, nt.GRADIENT_DESCENT
    f64 = ("fused_obs_leg", "reduce_s_lm")
    b1b3 = ("fused_obs_all", "segment_block_sum", "reduce_s_damped")
    implicit = "bench-realistic implicit"
    paths = (
        ("Newton gauge-fixed f64", "newton_gauge_f64",
         lambda: gauge_problem(torch.float64, device), iter_options(newton), f64),
        ("Newton gauge-fixed f32", "newton_gauge_f32",
         lambda: gauge_problem(torch.float32, device), iter_options(newton), b1b3),
        ("dogleg gauge-fixed f64", "dogleg_gauge_f64",
         lambda: gauge_problem(torch.float64, device), iter_options(dogleg), f64),
        ("dogleg pinhole bench f32", "dogleg_f32", lambda: (bench_problem(device), {}),
         iter_options(dogleg), b1b3),
        ("dogleg bench-realistic implicit", "dogleg_implicit",
         lambda: (bal_problem(implicit, device), {}),
         iter_options(dogleg, implicit_options(implicit)), ("segment_block_sum",)),
        ("GD pinhole bench f32", "gd_f32", lambda: (bench_problem(device), {}),
         iter_options(gd), ("fused_obs_all", "segment_block_sum")),
    )
    launches, results = {}, {}
    for label, key, make, opts, needs in paths:
        ref = ITER_REF[key]
        problem, route = make()
        slack = 1e-2 if key == "dogleg_implicit" else 1e-3
        with piece_counts() as counts:
            launches[label], result = phase_main(
                label, problem, ref["start"], ref["best"], slack, needs=needs,
                never=_never(needs), options=opts, **route)
        results[label] = result
        zero = {k: v for k, v in counts.items() if k in ZERO_SOLVES or "non-finite" in k}
        print(f"{label}: {result.num_iterations} iterations, {result.linear_solves} solves, "
              f"{result.cost_computations} cost evaluations; λ = 0 solve pieces replayed "
              f"{zero} (JAX CPU reference: {key}) | {smi}", flush=True)
        if "costs" in ref:
            trace_gate(f"{label} main path", result, ref)
        if key == "gd_f32":
            best = [min(result.costs[: i + 1]) for i in range(len(result.costs))]
            if not all(b <= a for a, b in zip(best, best[1:])) or not all(
                    c <= result.start_cost for c in result.costs):
                raise AssertionError(f"{label}: the cost rose above its best")
    return launches, results


def phase_dense(device, smi):
    """The dense backend through ``nt.optimize``: Rosenbrock through the
    four iterators (to (1, 1) within the functional test's rtols), robust
    curve fitting under each fixed kernel (LM, best cost within 1e-9 of the
    JAX package's CPU run), and the parking-garage-sized pose graph (LM
    and dogleg, float64, held to the JAX package's CPU trace); each with
    the launch counts set to 0 just before and read just after (the
    assembly's sums through B6).  Returns ``(launches, results, b6
    input)``: the B6 input one pose-graph assembly gives it."""
    import numpy as np

    import nllstpu_torch as nt
    from nllstpu_torch.core.optimize import compile_problem
    from nllstpu_torch.models.curvefit import make_curve_fit
    from nllstpu_torch.models.rosenbrock import make_rosenbrock

    never = _never(("segment_block_sum",))
    launches, results = {}, {}
    for it, x0, y0, rtol in ((nt.NEWTON, 0.0, 0.0, 1e-10),
                             (nt.LEVENBERG_MARQUARDT, -0.5, 2.5, 1e-10),
                             (nt.DOGLEG, -0.5, 2.5, 1e-10),
                             (nt.GRADIENT_DESCENT, 1.0 - 1e-5, 1.0, 1e-5)):
        _reset_counts()
        problem, x, y = make_rosenbrock(x0=x0, y0=y0, device=device)
        r = nt.optimize(problem, nt.Options(iterator=it))
        counts = _read_counts()
        xy = [float(problem.get_value(x)), float(problem.get_value(y))]
        print(f"dense Rosenbrock {ITER_NAME[it]}: {r.num_iterations} iterations, best "
              f"{r.best_cost!r}, (x, y) {xy!r}, launches {counts}", flush=True)
        if not np.allclose(xy, 1.0, rtol=rtol, atol=0) or not counts["segment_block_sum"] or any(
                counts[k] for k in never):
            raise AssertionError(f"dense Rosenbrock {it}: {xy} (rtol {rtol}), {counts}")
    for name, ref in CURVEFIT_REF.items():
        _reset_counts()
        kernel = None if name == "None" else getattr(nt, name)(0.5)
        problem, _, _ = make_curve_fit(kernel=kernel, dtype=torch.float64, device=device)
        r = nt.optimize(problem, nt.Options(max_time=float("inf")))
        counts = _read_counts()
        err = abs(r.best_cost - ref) / ref
        print(f"dense curve fit {name}: {r.num_iterations} iterations, best {r.best_cost!r} "
              f"against the JAX package's CPU {ref!r} (rel err {err:.2e}), launches "
              f"{counts['segment_block_sum']} B6", flush=True)
        if not err <= 1e-9 or not counts["segment_block_sum"]:
            raise AssertionError(f"dense curve fit {name}: best {r.best_cost} != {ref}")
    for it, key in ((nt.LEVENBERG_MARQUARDT, "posegraph_lm"), (nt.DOGLEG, "posegraph_dogleg")):
        label = f"{POSEGRAPH} {ITER_NAME[it]}"
        ref = ITER_REF[key]
        problem, route = posegraph_problem(device)
        launches[label], results[label] = phase_main(
            label, problem, ref["start"], ref["best"], 1e-9, needs=("segment_block_sum",),
            never=never, options=posegraph_options(it), **route)
        trace_gate(f"{label} main path", results[label], ref)
        print(f"{label}: d = {6 * (POSES - 1)} | {smi}", flush=True)
    # B6's input on the dense path: one assembly of the pose graph, recorded.
    problem, route = posegraph_problem(device)
    comp = compile_problem(problem, route["unfixed"], solver="dense")
    seen = []
    kern = comp.kernels.segment_sum

    def record(data, st):
        seen.append((data.clone(), st))
        return kern(data, st)

    comp.kernels = dataclasses.replace(comp.kernels, segment_sum=record)
    comp.assemble(problem.stacked_variables())
    return launches, results, {f"{POSEGRAPH} D=1": seen[0]}


def phase_b6_dense(device, cases):
    """B6 on the pose graph's float64 inputs (``cases``: the dense path's
    H entries sorted by target, D = 1; the cg path's matvec products, D =
    6, and block-Jacobi blocks, D = 36, sorted by variable): against its
    plain version, two launches, and beside its time the plain version's,
    ``torch.segment_reduce``'s and the byte bound."""
    from nllstpu_torch.ops import segment_sum

    kern, plain = segment_sum.segment_block_sum, segment_sum.segment_block_sum_reference
    records = {}
    for label, (data, st) in cases.items():
        ref = plain(data, st)
        out, again = kern(data, st), kern(data, st)
        err = check(f"B6 f64 {label}", [out], [ref], TOL_F64)[0]
        if not torch.equal(out, again):
            raise AssertionError(f"B6 {label}: two launches differ")
        lib_off = st.long()
        ms, plain_ms = time_ms(lambda: kern(data, st)), time_ms(lambda: plain(data, st))
        library_ms = time_ms(lambda: torch.segment_reduce(data, "sum", offsets=lib_off, axis=0))
        device_ms = graph_ms(lambda: kern(data, st))
        b = bound(nbytes(data, st, out), data.numel(), torch.float64)
        print(f"B6 {label} (N {data.shape[0]}, L {st.shape[0] - 1}): rel err f64 {err:.2e}, two "
              f"launches bit-identical | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.segment_reduce {library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}); in a CUDA graph: kernel {device_ms:.4f} ms", flush=True)
        records[label] = dict(max_abs_err=abs_err(out, ref), ms=ms, plain_ms=plain_ms, **b,
                              library_ms=library_ms, graph_ms=device_ms)
    return records


def phase_iter_determinism(device, results):
    """Gates: two dense assemblies of the pose graph give the same bits in
    H, g and the cost; a second graph-driver LM run of the pose graph and a
    second float32 dogleg run of the pinhole bench give the first run's
    trace (``results``: :func:`phase_iter_main`'s and :func:`phase_dense`'s)."""
    import nllstpu_torch as nt
    from nllstpu_torch.core.optimize import compile_problem

    problem, route = posegraph_problem(device)
    comp = compile_problem(problem, route["unfixed"], solver="dense")
    variables = problem.stacked_variables()
    (c1, (h1, g1)), (c2, (h2, g2)) = comp.assemble(variables), comp.assemble(variables)
    same = [torch.equal(a, b) for a, b in ((c1, c2), (h1, h2), (g1, g2))]
    print(f"determinism {POSEGRAPH}: two dense assemblies bit-identical in (cost, H, g): "
          f"{same}", flush=True)
    if not all(same):
        raise AssertionError(f"determinism {POSEGRAPH}: two dense assemblies differ")
    del comp, h1, h2
    for label, make, opts in (
        (f"{POSEGRAPH} LM", lambda: posegraph_problem(device),
         posegraph_options(nt.LEVENBERG_MARQUARDT)),
        ("dogleg pinhole bench f32", lambda: (bench_problem(device), {}),
         iter_options(nt.DOGLEG)),
    ):
        problem, route = make()
        again = nt.optimize(problem, opts, **route)
        first = results[label]
        print(f"determinism {label}: two graph-driver runs, {len(first.costs)} and "
              f"{len(again.costs)} iterations, best {first.best_cost!r} and "
              f"{again.best_cost!r}", flush=True)
        if again.costs != first.costs:
            raise AssertionError(f"determinism {label}: two runs give two traces")


def phase_iter_drivers(device, smi, results):
    """For each new iterator, the graph driver (``results``, the main
    paths' runs, or a run here) against the stepped driver
    (``callback=nt.null_callback``) on the gauge-fixed float64 path and the
    pinhole bench in float32 (Newton: with the gauge fixed, as its main
    path): the same iterations and solves, costs within 1e-12 (float64) or
    1e-6 (float32) relative; prints whether the bits held."""
    import nllstpu_torch as nt

    cases = (
        ("Newton gauge-fixed f64", lambda: gauge_problem(torch.float64, device), nt.NEWTON),
        ("Newton gauge-fixed f32", lambda: gauge_problem(torch.float32, device), nt.NEWTON),
        ("dogleg gauge-fixed f64", lambda: gauge_problem(torch.float64, device), nt.DOGLEG),
        ("dogleg pinhole bench f32", lambda: (bench_problem(device), {}), nt.DOGLEG),
        ("GD gauge-fixed f64", lambda: gauge_problem(torch.float64, device),
         nt.GRADIENT_DESCENT),
        ("GD pinhole bench f32", lambda: (bench_problem(device), {}), nt.GRADIENT_DESCENT),
    )
    for label, make, it in cases:
        graph = results.get(label)
        if graph is None:
            problem, route = make()
            graph = nt.optimize(problem, iter_options(it), **route)
        problem, route = make()
        stepped = nt.optimize(problem, iter_options(it), callback=nt.null_callback, **route)
        tol = 1e-12 if problem.dtype == torch.float64 else 1e-6
        n = min(len(graph.costs), len(stepped.costs))
        err = max(abs(a - b) / abs(b) for a, b in zip(graph.costs[:n], stepped.costs[:n]))
        print(f"drivers {label}: graph {graph.num_iterations} iterations, "
              f"{graph.linear_solves} solves, {graph.cost_computations} costs, best "
              f"{graph.best_cost!r}; stepped {stepped.num_iterations}, {stepped.linear_solves}, "
              f"{stepped.cost_computations}, best {stepped.best_cost!r}; max rel cost "
              f"difference {err:.2e} (tolerance {tol:g}); bits "
              f"{'held' if graph.costs == stepped.costs else 'differ'} | {smi}", flush=True)
        if (graph.num_iterations, graph.linear_solves) != (
                stepped.num_iterations, stepped.linear_solves) or not err <= tol:
            raise AssertionError(f"drivers {label}: the graph and stepped drivers disagree")


def phase_posegraph_times(device, smi):
    """The pose graph's dense system: the damped Cholesky alone against its
    bound (d³/3 operations at the card's float64 peak), by CUDA events,
    beside one assembly and one cost evaluation; the peak device memory of
    one assembly and factorisation."""
    from nllstpu_torch.core.optimize import _cusolver, compile_problem

    problem, route = posegraph_problem(device)
    comp = compile_problem(problem, route["unfixed"], solver="dense")
    variables = problem.stacked_variables()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _, (h, g) = comp.assemble(variables)
    d = h.shape[0]
    m = h.clone()
    m.diagonal().add_(1e-6 * float(h.diagonal().abs().max()))
    with _cusolver(device):
        chol_ms = time_ms(lambda: torch.linalg.cholesky_ex(m), reps=5)
        lu_ms = time_ms(lambda: torch.linalg.lu_factor_ex(m), reps=3)
    assemble_ms = time_ms(lambda: comp.assemble(variables), reps=5)
    cost_ms = time_ms(lambda: comp.cost(variables), reps=5)
    peak = peak_memory(held)
    b = bound(0, d ** 3 / 3, torch.float64)["bound_ms"]
    print(f"{POSEGRAPH} dense system (d {d}, H {d * d * 8 / 1e6:.1f} MB): Cholesky "
          f"{chol_ms:.3f} ms against its bound {b:.3f} ms ({b / chol_ms * 100:.1f}% of the "
          f"float64 peak), LU {lu_ms:.3f} ms, assembly {assemble_ms:.3f} ms, cost "
          f"{cost_ms:.3f} ms; peak device memory {peak} | {smi}", flush=True)


def _final_result(final):
    """:func:`run_driver`'s final state in the shape :func:`trace_gate`
    reads."""
    return types.SimpleNamespace(costs=[float(c) for c in final["trace"]],
                                 best_cost=float(final["bestcost"]),
                                 start_cost=float(final["startcost"]))


def phase_generic_main(device, smi):
    """This slice's main paths through ``nt.optimize`` (the graph driver),
    the launch counts set to 0 just before and read just after, then once
    more through the graph driver and once through the stepped driver: the
    per-cost path through ``solver="schur"`` (B5, B6 and B7, never B1–B4 or
    B8) and ``solver="schur_cg"`` (B6 only), each run held to the JAX
    package's CPU float64 trace (the implicit one also to its PCG
    iterations per solve, within ±1), the second graph run to the first
    one's bits; the riders path (B2, B6 and B3, never B1, B5 or B7) held to
    the JAX package's CPU float32 start and best cost (slack 1e-2) through
    both drivers.  Returns the launch counts per path."""
    from nllstpu_torch.core.optimize import compile_problem

    launches = {}
    for label, solver, needs in ((PERCOST, "schur", ("segment_block_sum", "place_w", "reduce_s")),
                                 (PERCOST_CG, "schur_cg", ("segment_block_sum",))):
        ref, opts = GENERIC_REF[label], generic_options(solver)
        problem, route = percost_problem(device)
        launches[label], result = phase_main(
            label, problem, ref["start"], ref["best"], 1e-9, needs=needs, never=_never(needs),
            options=opts, **route)
        trace_gate(f"{label} main path", result, ref)
        problem, route = percost_problem(device)
        comp = compile_problem(problem, route["unfixed"], solver=solver,
                               schur_family=opts.schur_family)
        vars0 = problem.stacked_variables()
        runs = {driver: run_driver(driver, comp, opts, vars0) for driver in ("graph", "stepped")}
        for driver, final in runs.items():
            trace_gate(f"{label} {driver} driver", _final_result(final), ref)
        same = [float(c) for c in runs["graph"]["trace"]] == result.costs
        line = (f"determinism {label}: two graph-driver runs, {len(result.costs)} and "
                f"{len(runs['graph']['trace'])} iterations, traces "
                f"{'bit-identical' if same else 'differ'}")
        if solver == "schur_cg":
            want = list(ref["pcg_iters"])
            got = {d: list(f["cg_iters"]) for d, f in runs.items()}
            line += f"; PCG iterations per solve {got} against the JAX package's {want}"
            if not all(len(g) == len(want) and max(abs(a - b) for a, b in zip(g, want)) <= 1
                       for g in got.values()):
                raise AssertionError(f"{label}: PCG iterations depart from the JAX package's")
        print(f"{line} | {smi}", flush=True)
        if not same:
            raise AssertionError(f"determinism {label}: two runs differ")
    needs = ("fused_obs_all_into", "segment_block_sum", "reduce_s_damped")
    ref = GENERIC_REF[RIDERS]
    problem, route = riders_problem(device)
    launches[RIDERS], _ = phase_main(RIDERS, problem, ref["start"], ref["best"], 1e-2,
                                     needs=needs, never=_never(needs), **route)
    problem, route = riders_problem(device)
    comp = compile_problem(problem, route["unfixed"], solver="schur",
                           schur_family=bench_options().schur_family)
    if comp.schur_info.w_rows is None or comp.schur_info.fast[0].ex_cols.shape[0] == 0:
        raise AssertionError(f"{RIDERS}: not on the obs-major route with an extras region")
    final = run_driver("stepped", comp, bench_options(), problem.stacked_variables())
    best = float(final["bestcost"])
    print(f"{RIDERS} stepped driver: {final['iternum']} iterations, start cost "
          f"{float(final['startcost'])!r}, best cost {best!r} against the JAX package's "
          f"{ref['best']!r} | {smi}", flush=True)
    if not (abs(float(final["startcost"]) - ref["start"]) <= 1e-4 * abs(ref["start"])
            and best <= ref["best"] + 1e-2 * abs(ref["best"])):
        raise AssertionError(f"{RIDERS}: the stepped driver departs from the JAX package's")
    return launches


def _sigmas(problem):
    """(σ1, σ2, w) of a problem's first ContaminatedGaussian variable."""
    import nllstpu_torch as nt

    kh = nt.VarHandle(nt.ContaminatedGaussian().manifold, 0)
    return nt.ContaminatedGaussian.sigmas_weight(problem.get_value(kh)).double().tolist()


def phase_adaptive_everywhere(device, smi, direct_sigmas, labels=None):
    """This slice's main paths through ``nt.optimize`` (the graph driver),
    launch counts set to 0 just before and read just after, each then
    profiled (10 iterations: its rate and the device's idle share):

    - adaptive Dubrovnik-class through ``schur_cg`` (B6 only), float32,
      ``ADAPTIVE_BIG_ITERS`` iterations: the start cost within 1e-4 of the
      JAX package's CPU float32 run's, each iteration's cost within 1e-4
      of its float64 run's, no NaN, (σ1, σ2, w) printed beside its;
    - adaptive bench-realistic through ``schur_cg`` (B6 only), 60
      iterations: start and best cost (sign-safe, slack 1e-2) and (σ1, σ2,
      w) within ``ADAPTIVE_REF["tol"]`` of the JAX CPU float32 run of the
      same implicit path, printed beside the direct path's
      (``direct_sigmas``);
    - Ladybug-49 adaptive per-cost in float64 through ``schur`` (B5, B6,
      B7; never B1–B4 or B8) and ``schur_cg`` (B6 only, ``linear_tol=1e-8``:
      also its PCG iterations per solve, from a second graph-driver run,
      within ±1 of the JAX package's in every solve whose count does not
      move when the JAX run's start is scaled by 1 ± 2⁻⁵²), and Ladybug-49
      with a kernel per camera
      through ``schur`` (B5, B6, B7): the float64 trace gate;
    - the pinhole bench through ``schur_cg`` with cluster-Jacobi (B6 only):
      the pinhole reference (start 1e-4, best slack 1e-2), then the PCG
      iterations per solve of a graph-driver run with and without it;
    - the two-mean mixture through ``dense`` and ``cg`` (B6 only): the
      float64 trace gate and (σ1, σ2, w) within 0.12 of (1, 10, 0.8).

    ``labels`` picks some of the paths (all by default).  Returns the
    launch counts per path."""
    from nllstpu_torch.core.optimize import compile_problem

    launches = {}
    b6_only = ("segment_block_sum",)
    generic = ("segment_block_sum", "place_w", "reduce_s")
    paths = ((ADAPTIVE_BIG, b6_only), (ADAPTIVE_IMPLICIT, b6_only),
             (ADAPTIVE_PERCOST, generic), (ADAPTIVE_PERCOST_CG, b6_only), (PER_CAMERA, generic),
             (CLUSTER, b6_only), (f"{MIXTURE} dense", b6_only), (f"{MIXTURE} cg", b6_only))
    for label, needs in paths:
        if labels is not None and label not in labels:
            continue
        opts = adaptive_all_options(label)
        if label == CLUSTER:
            ref = dict(start=REF_START_COST, best=REF_BEST_COST)
        else:
            ref = ADAPTIVE_REFS[label]
        problem, route = adaptive_all_problem(label, device)
        slack = 1e-4 if label == ADAPTIVE_BIG else 1e-9 if "costs" in ref else 1e-2
        launches[label], result = phase_main(label, problem, ref["start"], ref["best"], slack,
                                             needs=needs, never=_never(needs), options=opts,
                                             **route)
        if label == ADAPTIVE_BIG:
            errs = [abs(a - b) / abs(b) for a, b in zip(result.costs, ref["costs"])]
            errs32 = [abs(a - b) / abs(b) for a, b in zip(ref["costs_f32"], ref["costs"])]
            print(f"{label}: costs {result.costs!r} against the JAX package's CPU float64 "
                  f"{list(ref['costs'])!r}, rel err {['%.2e' % e for e in errs]} (its float32 "
                  f"run's {list(ref['costs_f32'])!r}: {['%.2e' % e for e in errs32]}); (sigma1, "
                  f"sigma2, w) {_sigmas(problem)} against "
                  f"{list(ref['sigmas_weight'])} | {smi}", flush=True)
            if len(errs) != len(ref["costs"]) or max(errs) > 1e-4:
                raise AssertionError(f"{label}: the costs depart from the JAX package's")
        elif label == ADAPTIVE_IMPLICIT:
            sw = _sigmas(problem)
            want = ref["sigmas_weight"]
            err = [abs(a - b) / abs(b) for a, b in zip(sw, want)]
            print(f"{label}: (sigma1, sigma2, w) {sw} against the JAX package's implicit "
                  f"{list(want)}, rel err {['%.2e' % e for e in err]} (tolerance "
                  f"{ADAPTIVE_REF['tol']}); the direct path's {direct_sigmas} | {smi}",
                  flush=True)
            if not all(e <= t for e, t in zip(err, ADAPTIVE_REF["tol"])):
                raise AssertionError(f"{label}: kernel parameters {sw} != {list(want)}")
        elif label == CLUSTER:
            runs = {}
            for m in (CLUSTER_SIZE, 0):
                o = dataclasses.replace(opts, schur_cluster_size=m)
                p2, _ = adaptive_all_problem(label, device)
                comp = compile_problem(p2, solver=o.solver, schur_family=o.schur_family)
                if (comp.ctx(o).linops.cluster is None) != (m == 0):
                    raise AssertionError(f"{label}: cluster-Jacobi taken = {m > 0} expected")
                runs[m] = run_driver("graph", comp, o, p2.stacked_variables())
            cg = {m: list(f["cg_iters"]) for m, f in runs.items()}
            mean = {m: sum(c) / max(len(c), 1) for m, c in cg.items()}
            print(f"{label}: PCG iterations per solve, cluster size {CLUSTER_SIZE}: "
                  f"{cg[CLUSTER_SIZE]} (mean {mean[CLUSTER_SIZE]:.2f}, "
                  f"{runs[CLUSTER_SIZE]['wall']:.3f} s); Schur-Jacobi: {cg[0]} (mean "
                  f"{mean[0]:.2f}, {runs[0]['wall']:.3f} s) | {smi}", flush=True)
        else:
            trace_gate(f"{label} main path", result, ref)
            if label.startswith(MIXTURE):
                sw = _sigmas(problem)
                print(f"{label}: (sigma1, sigma2, w) {sw} against (1, 10, 0.8), rtol 0.12",
                      flush=True)
                if not all(abs(a - b) <= 0.12 * b for a, b in zip(sw, (1.0, 10.0, 0.8))):
                    raise AssertionError(f"{label}: kernel parameters {sw}")
            if label == ADAPTIVE_PERCOST_CG:
                problem, route = adaptive_all_problem(label, device)
                comp = compile_problem(problem, route["unfixed"], solver=opts.solver,
                                       schur_family=opts.schur_family)
                final = run_driver("graph", comp, opts, problem.stacked_variables())
                got, lo, hi = list(final["cg_iters"]), ref["pcg_min"], ref["pcg_max"]
                print(f"{label}: PCG iterations per solve {got} against the JAX package's "
                      f"{list(ref['pcg_iters'])} (its own range over starts scaled by 1 ± "
                      f"2^-52: {list(lo)} to {list(hi)}) | {smi}", flush=True)
                # Held where the JAX package's own count does not move under
                # that perturbation, within ±1.
                if len(got) != len(lo) or any(a == b and abs(g - a) > 1
                                              for g, a, b in zip(got, lo, hi)):
                    raise AssertionError(f"{label}: PCG iterations depart from the JAX package's")
        problem, route = adaptive_all_problem(label, device)
        phase_profile(label, problem, "graph", options=opts, **route)
    return launches


def phase_cg(device, smi, dense_results):
    """The cg backend through ``nt.optimize`` on the parking-garage-sized
    pose graph (LM and dogleg, float64), with the launch counts set to 0
    just before and read just after (B6 and no other kernel): held to the
    JAX package's CPU "cg" traces and to the dense route's best cost
    (``dense_results``, :func:`phase_dense`'s) within 1e-9; a second LM run
    gives the first one's trace; two assemblies give the same bits, and so
    do two matvecs.  Returns ``(launches, results, b6 inputs)``: B6's
    inputs on the matvec (D = 6) and on the block-Jacobi blocks (D = 36),
    recorded from one assembly and one matvec."""
    import nllstpu_torch as nt
    from nllstpu_torch.core.optimize import _cusolver, compile_problem
    from nllstpu_torch.ops import cg

    never = _never(("segment_block_sum",))
    launches, results = {}, {}
    for it, key in ((nt.LEVENBERG_MARQUARDT, "posegraph_cg_lm"),
                    (nt.DOGLEG, "posegraph_cg_dogleg")):
        label = f"{POSEGRAPH} cg {ITER_NAME[it]}"
        ref = ITER_REF[key]
        problem, route = posegraph_problem(device)
        launches[label], results[label] = phase_main(
            label, problem, ref["start"], ref["best"], 1e-9, needs=("segment_block_sum",),
            never=never, options=posegraph_options(it, "cg"), **route)
        trace_gate(f"{label} main path", results[label], ref)
        dense = dense_results[f"{POSEGRAPH} {ITER_NAME[it]}"].best_cost
        err = abs(results[label].best_cost - dense) / abs(dense)
        print(f"{label}: best {results[label].best_cost!r} against the dense route's "
              f"{dense!r} (rel err {err:.2e}) | {smi}", flush=True)
        if not err <= 1e-9:
            raise AssertionError(f"{label}: best cost departs from the dense route's")
    label = f"{POSEGRAPH} cg LM"
    problem, route = posegraph_problem(device)
    again = nt.optimize(problem, posegraph_options(nt.LEVENBERG_MARQUARDT, "cg"), **route)
    comp = compile_problem(problem, route["unfixed"], solver="cg")
    ops = comp.ctx().linops
    variables = problem.stacked_variables()
    (c1, s1), (c2, s2) = comp.assemble(variables), comp.assemble(variables)
    same_sys = all(torch.equal(a, b) for a, b in zip((c1, s1[0], *s1[1], *s1[3], s1[4]),
                                                     (c2, s2[0], *s2[1], *s2[3], s2[4])))
    x = torch.randn(ops.dim, dtype=comp.dtype, device=device)
    lam = torch.tensor(1e-3, dtype=torch.float64, device=device)
    same_mv = bool(torch.equal(ops.matvec(s1, lam, x), ops.matvec(s1, lam, x)))
    same_run = again.costs == results[label].costs
    print(f"determinism {label}: two graph-driver runs, {len(results[label].costs)} and "
          f"{len(again.costs)} iterations, traces {'equal' if same_run else 'differ'}; two cg "
          f"assemblies bit-identical {same_sys}; two matvecs bit-identical {same_mv}", flush=True)
    if not (same_run and same_sys and same_mv):
        raise AssertionError(f"determinism {label}: two runs differ")
    del s2
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with _cusolver(device):
        _, sys_ = comp.assemble(variables)
        ops.solve(sys_, lam)
    torch.cuda.synchronize()
    blocks_mb = sum(h.numel() * h.element_size() for h in sys_[1]) / 2**20
    print(f"{POSEGRAPH} cg system: per-cost blocks {blocks_mb:.1f} MiB; one assembly and one "
          f"solve ({ops.cg_iters[-1]} PCG iterations): peak device memory {peak_memory(held)} "
          f"| {smi}", flush=True)
    seen = []
    kern = ops.segment_sum

    def record(data, st):
        seen.append((data.clone(), st))
        return kern(data, st)

    ops = dataclasses.replace(ops, segment_sum=record)
    _, sys_ = cg.assemble_cg(comp.batches, variables, ops)
    blocks = next(c for c in seen if c[0].shape[1] == 36)
    seen.clear()
    ops.matvec(sys_, lam, x)
    (matvec_in,) = seen
    return launches, results, {f"{POSEGRAPH} cg D=6": matvec_in,
                               f"{POSEGRAPH} cg D=36": blocks}


#: Phase 21 (per-variable alternation, cost-subset views): the JAX
#: package's CPU float32 references from ``JAX_PLATFORMS=cpu python
#: scripts_torch/item6_reference.py``, each run three times with its start
#: scaled by 1 and 1 ± 2⁻²³ (the package's own spread).  Singles: the data
#: with the points perturbed by 0.01 (seed 5), ``optimize_singles(targets=
#: PT)`` with the default options; the start cost and, per run, the summed
#: iterations and the final cost, both costs in float64 at the float32
#: values.  The final cost is held to the JAX runs' range widened by its
#: own width.  The float32 cases' summed iterations are held to the port's
#: own CPU runs from the same three starts (``port_cpu``: ``python
#: scripts_torch/singles_spread.py`` on the H100 machine's CPU), their
#: range widened by its width or by the JAX runs' relative width where
#: that is wider; bench-realistic's also to the JAX runs.  Dubrovnik-
#: class's is not: there the port's sum sits 0.6% under the JAX package's
#: on the card and on the CPU alike (1,022,873–1,024,252 against
#: 1,030,004–1,030,462), a bias whose cause is open (PERF.md §7), and its
#: gap to the JAX runs is printed.  The float64 case stops at
#: ``rel_dcost=1e-6``, before its floor, and is held to the JAX sum within
#: its spread (±1).
SINGLES_REF = {
    "Dubrovnik-class": dict(
        args=IMPLICIT["Dubrovnik-class"][0], iterator="levenberg_marquardt",
        start=528379.3145493721, iterations=(1030004, 1030462, 1030394),
        final=(0.9127431583339611, 0.9128067138252072, 0.9127863057320433),
        port_cpu=(1024009, 1023397, 1024252), jax_iterations_bias=True),
    "Dubrovnik-class f64": dict(
        args=IMPLICIT["Dubrovnik-class"][0], iterator="levenberg_marquardt",
        dtype=torch.float64, options=dict(rel_dcost=1e-6),
        start=528379.3068250538, iterations=(700254, 700255, 700253),
        final=(0.9125897352242254, 0.9125897352242263, 0.912589735224256), final_floor=1e-9),
    "bench-realistic": dict(
        args=BAL["bench-realistic"][0], iterator="newton",
        start=37490.256419411635, iterations=(62532, 62874, 62599),
        final=(0.07617897863848394, 0.07618433173479422, 0.07618233894256382),
        port_cpu=(63201, 62613, 62874)),
}
#: Views: ``SubproblemView(solver="schur")``, float32, LM for
#: ``VIEW_ITERS`` iterations without early stop, the first half of the
#: points selected, then the second, then the first again: each swap's
#: best cost in the three runs.  bench-realistic (points perturbed by 0.01)
#: ends its swaps at its float32 floor, where the JAX package's own runs
#: part by up to 5e-3; the pinhole bench (0.05) by 1.6e-7.  A swap after
#: the first starts from the previous swap's result, which is the port's
#: own on the card: the fresh subproblem starts from the same values.
VIEW_ITERS = 20
VIEW_REF = {
    "pinhole bench": (
        (0.04595138505101204, 0.04610435664653778, 0.04595138877630234),
        (0.04595138505101204, 0.04610435664653778, 0.04595138132572174),
        (0.04595138132572174, 0.046104349195957184, 0.04595138132572174)),
    "bench-realistic": (
        (0.03716730326414108, 0.038001563400030136, 0.03716743737459183),
        (0.03735113516449928, 0.03799987956881523, 0.03721827641129494),
        (0.03720852732658386, 0.037997499108314514, 0.03721699118614197)),
}
VIEW_TOL = 1e-5
#: A view's best cost against a fresh subproblem's, both the port's on the
#: card from the same values: ``VIEW_TOL``, except where the swaps end at
#: the float32 floor (bench-realistic: gaps up to 2.4e-4 measured, PERF.md
#: §6).  The JAX comparison keeps the JAX runs' spread (``view_tolerance``).
VIEW_FRESH_TOL = {"pinhole bench": VIEW_TOL, "bench-realistic": 1e-3}


def within_spread(got, refs, floor=0.0) -> bool:
    """``got`` inside the references' range widened by its own width (or
    by ``floor`` of the largest, where that is wider) on each side: the
    port is one more draw from the rounding that spreads the references."""
    lo, hi = min(refs), max(refs)
    w = max(hi - lo, floor * abs(hi))
    return lo - w <= got <= hi + w


def view_tolerance(name) -> float:
    """The relative tolerance of a view's best costs: ``VIEW_TOL``, or the
    JAX package's own largest relative spread over the swaps where that is
    wider (bench-realistic's float32 floor: 5e-3)."""
    spread = max((max(c) - min(c)) / min(c) for c in zip(*VIEW_REF[name]))
    return max(VIEW_TOL, spread)


def singles_problem(name, device):
    """``(data, problem, points)``: the singles case's BAL problem, the
    points perturbed by 0.01 (seed 5)."""
    from nllstpu_torch.models.ba import perturb_ba
    from nllstpu_torch.models.bal import make_bal_problem, make_realistic_bal

    ref = SINGLES_REF[name]
    data = make_realistic_bal(**ref["args"])
    problem, _, points = make_bal_problem(data, dtype=ref.get("dtype", torch.float32),
                                          device=device)
    perturb_ba(problem, points, 0.01, seed=5)
    return data, problem, points


def cost64(data, problem, device):
    """The cost in float64 at the problem's values."""
    import nllstpu_torch as nt
    from nllstpu_torch.models.bal import make_bal_problem

    q, _, _ = make_bal_problem(data, dtype=torch.float64, device=device)
    q.set_values({k: v.double() for k, v in problem.stacked_variables().items()})
    return nt.cost(q)


@contextlib.contextmanager
def no_plain_b6():
    """Fail when B6's plain version runs (the dispatcher on a CUDA tensor
    must launch the kernel)."""
    from nllstpu_torch.ops import segment_sum

    real = segment_sum.segment_block_sum_reference

    def refuse(*args):
        raise AssertionError("B6's plain version ran on a main path")

    segment_sum.segment_block_sum_reference = refuse
    try:
        yield
    finally:
        segment_sum.segment_block_sum_reference = real


@contextlib.contextmanager
def b6_recorder(seen, label):
    """Keep the first B6 input of each width that the kernels' dispatcher
    gets (``optimize.KERNELS.segment_sum``), passing it on."""
    from nllstpu_torch.core import optimize

    real = optimize.KERNELS

    def record(data, st):
        seen.setdefault(f"{label} D={data.shape[1]} target runs", (data.clone(), st))
        return real.segment_sum(data, st)

    optimize.KERNELS = dataclasses.replace(real, segment_sum=record)
    try:
        yield
    finally:
        optimize.KERNELS = real


def phase_singles(device, smi):
    """``optimize_singles`` at full size on the card: landmark polish of
    Dubrovnik-class with LM and of bench-realistic with Newton, cameras
    fixed by construction, launch counts set to 0 just before and read just
    after: B6 and nothing else, never B6's plain version; the summed
    iterations and the final cost (float64 at the final values) within
    the JAX package's own spread (``SINGLES_REF``).  Returns the launch
    counts and the B6 inputs (one per width) per case."""
    import nllstpu_torch as nt
    from nllstpu_torch.models.bal import PT

    launches, inputs = {}, {}
    for name, ref in SINGLES_REF.items():
        data, problem, points = singles_problem(name, device)
        start = cost64(data, problem, device)
        label = f"{name} singles"
        seen = {}
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        _reset_counts()
        t0 = time.perf_counter()
        with no_plain_b6(), b6_recorder(seen, label):
            out = nt.optimize_singles(problem, nt.Options(iterator=ref["iterator"],
                                                          **ref.get("options", {})),
                                      targets=PT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        iters = sum(out.values())
        final = cost64(data, problem, device)
        print(f"{label} ({ITER_NAME[ref['iterator']]}, {len(points)} points): {iters} "
              f"iterations summed in {wall:.3f} s = {iters / wall:.1f} it/s, start cost "
              f"{start!r} (JAX {ref['start']!r}), final {final!r} (JAX {ref['final']}; "
              f"iterations {ref['iterations']}), launches {counts}, peak device memory "
              f"{peak_memory(held)} | {smi}", flush=True)
        if not abs(start - ref["start"]) <= 1e-9 * ref["start"]:
            raise AssertionError(f"{label}: start cost {start} != {ref['start']}")
        jax_iters = ref["iterations"]
        print(f"{label}: summed iterations {iters / (sum(jax_iters) / len(jax_iters)) - 1:+.4%} "
              f"from the JAX runs' mean", flush=True)
        width = (max(jax_iters) - min(jax_iters)) / max(jax_iters)
        if "port_cpu" in ref and not within_spread(iters, ref["port_cpu"], width):
            raise AssertionError(f"{label}: {iters} iterations outside the port's CPU runs "
                                 f"{ref['port_cpu']} (at least the JAX spread {width:.3%})")
        if not ref.get("jax_iterations_bias") and not within_spread(iters, jax_iters):
            raise AssertionError(f"{label}: {iters} iterations outside the JAX runs "
                                 f"{jax_iters}")
        if not within_spread(final, ref["final"], ref.get("final_floor", 0.0)):
            raise AssertionError(f"{label}: final cost {final} outside the JAX package's "
                                 f"spread {ref['final']}")
        if not counts["segment_block_sum"] or any(v for k, v in counts.items()
                                                  if k != "segment_block_sum"):
            raise AssertionError(f"{label}: launches {counts}")
        if not all(torch.isfinite(v).all() for v in problem.stacked_variables().values()):
            raise AssertionError(f"{label}: non-finite values")
        launches[label] = counts
        if problem.dtype == torch.float32:
            inputs.update(seen)
        del problem, data
    return launches, inputs


def view_problem(name, device):
    """``(problem, points)``: the pinhole bench (points perturbed by 0.05)
    or bench-realistic (0.01) in float32."""
    from nllstpu_torch.models.ba import make_pinhole_ba, perturb_ba
    from nllstpu_torch.models.bal import make_bal_problem, make_realistic_bal

    if name == "pinhole bench":
        problem, _, points = make_pinhole_ba(
            ncameras=NCAM, nlandmarks=NLMK, prop_visible=VIS, noise=NOISE,
            dtype=torch.float32, batched="cm", device=device)
        perturb_ba(problem, points, 0.05, seed=5)
    else:
        problem, _, points = make_bal_problem(make_realistic_bal(**BAL[name][0]),
                                              dtype=torch.float32, device=device)
        perturb_ba(problem, points, 0.01, seed=5)
    return problem, points


def phase_views(device, smi):
    """``SubproblemView(solver="schur")`` on the pinhole bench (B1) and on
    bench-realistic (B2): the first half of the points, the second, the
    first again, each swap with the launch counts set to 0 just before and
    read just after.  Gates: one capture across the swaps; B1 or B2, B3
    and B6 in each swap; each swap's best cost within ``VIEW_FRESH_TOL``
    of a fresh subproblem optimized on the card from the same values, and
    within ``VIEW_TOL`` (or the JAX package's own spread, where wider) of
    the JAX package's CPU runs;
    ``view.cost()`` equal to the subproblem's cost at the same values.
    Returns the launch counts of each view's first swap and its B6 camera
    input (bench-realistic's: B2's camera runs)."""
    import nllstpu_torch as nt
    from nllstpu_torch.core import optimize

    opts = dataclasses.replace(bench_options(), max_iters=VIEW_ITERS)
    launches, inputs = {}, {}
    for name, assemble in (("pinhole bench", "fused_obs_all"),
                           ("bench-realistic", "fused_obs_all_into")):
        problem, points = view_problem(name, device)
        view = nt.SubproblemView(problem, solver="schur", schur_family=nt.Euclidean(3))
        half = len(points) // 2
        label = f"{name} view"
        for k, sel in enumerate((points[:half], points[half:], points[:half])):
            fresh, _ = view_problem(name, device)
            fresh.set_values(problem.stacked_variables())
            _reset_counts()
            t0 = time.perf_counter()
            with no_plain_b6():
                r = view.select(sel).optimize(opts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _read_counts()
            vc, sc = view.cost(), nt.cost(problem.subproblem(sel))
            r_sub = nt.optimize(fresh.subproblem(sel), opts)
            refs = [run[k] for run in VIEW_REF[name]]
            tol, fresh_tol = view_tolerance(name), VIEW_FRESH_TOL[name]
            print(f"{label} swap {k + 1} ({'first' if k != 1 else 'second'} half): "
                  f"{r.num_iterations} iterations in {wall:.3f} s, start {r.start_cost!r}, best "
                  f"{r.best_cost!r}; a fresh subproblem {r_sub.best_cost!r}; JAX {refs}; "
                  f"view.cost() {vc!r}, the subproblem's {sc!r}; captures {view.capture_count}, "
                  f"launches {counts} | {smi}", flush=True)
            if view.capture_count != 1 or view.compile_count != 1 or len(view._runners) != 1:
                raise AssertionError(f"{label}: {view.capture_count} captures")
            needs = (assemble, "reduce_s_damped", "segment_block_sum")
            if not all(counts[n] for n in needs):
                raise AssertionError(f"{label}: launches {counts}, needed {needs}")
            if not abs(r.best_cost - r_sub.best_cost) <= fresh_tol * abs(r_sub.best_cost):
                raise AssertionError(f"{label} swap {k + 1}: best {r.best_cost} against the "
                                     f"fresh subproblem's {r_sub.best_cost} (tolerance "
                                     f"{fresh_tol:.2e})")
            if not min(refs) * (1 - tol) <= r.best_cost <= max(refs) * (1 + tol):
                raise AssertionError(f"{label} swap {k + 1}: best {r.best_cost} against JAX "
                                     f"{refs} (tolerance {tol:.2e})")
            if not abs(vc - sc) <= VIEW_TOL * abs(sc):
                raise AssertionError(f"{label}: view.cost() {vc} != subproblem's {sc}")
            launches.setdefault(label, counts)
            del fresh
        if name == "bench-realistic":
            seen = {}
            comp = view.compiled
            real = comp.kernels

            def record(data, st):
                seen.setdefault(f"{label} D={data.shape[1]} camera runs", (data.clone(), st))
                return real.segment_sum(data, st)

            comp.kernels = dataclasses.replace(real, segment_sum=record)
            comp.assemble(problem.stacked_variables())
            comp.kernels = real
            inputs.update(seen)
        view.select(points[half:])
        profile_block(f"{label} swap (second half, {VIEW_ITERS} LM iterations, graph driver)",
                      lambda: view.optimize(opts))
        print(f"{label}: compiles {view.compile_count}, captures {view.capture_count} over "
              f"four swaps (process captures {optimize.CAPTURES})", flush=True)
        if view.capture_count != 1:
            raise AssertionError(f"{label}: {view.capture_count} captures")
        del view, problem
    return launches, inputs


def phase_cache(device, smi):
    """The runner cache: ``nt.optimize`` twice on the pinhole bench.  Gates:
    the second call compiles and captures nothing and its ``time_init`` is
    under a tenth of the first's; its best cost equals a fresh uncached
    run's; the memory after the problem is dropped returns within 64 MiB
    of before."""
    import nllstpu_torch as nt
    from nllstpu_torch.core import optimize

    opts = dataclasses.replace(bench_options(), max_iters=10)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    problem, start = bench_problem(device), bench_problem(device)
    first = nt.optimize(problem, opts)
    problem.set_values(start.stacked_variables())
    compiles, captures = optimize.COMPILES, optimize.CAPTURES
    second = nt.optimize(problem, opts)
    hit = (optimize.COMPILES - compiles, optimize.CAPTURES - captures)
    fresh = nt.optimize(start, opts)
    del problem, start
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    print(f"runner cache pinhole bench: first call time_init {first.time_init:.4f} s, second "
          f"{second.time_init:.6f} s with {hit[0]} compiles and {hit[1]} captures; best "
          f"{second.best_cost!r}, a fresh run's {fresh.best_cost!r}; device memory "
          f"{before / 2**20:.1f} MiB before, {after / 2**20:.1f} MiB after the problem went "
          f"| {smi}", flush=True)
    if hit != (0, 0) or not second.time_init < 0.1 * first.time_init:
        raise AssertionError(f"runner cache: {hit} on the second call, time_init "
                             f"{second.time_init} against {first.time_init}")
    if second.best_cost != fresh.best_cost or second.costs != fresh.costs:
        raise AssertionError("runner cache: the cached run departs from a fresh one")
    if not after - before <= 64 << 20:
        raise AssertionError(f"runner cache: {(after - before) / 2**20:.1f} MiB kept")


def phase_utils(device, smi):
    """``hessian_coo`` summed equals ``hessian_dense`` on the pose graph; a
    checkpoint round trip gives the values bit for bit; ``write_bal`` then
    ``load_bal`` of bench-realistic goes through the native parser and
    gives the arrays back."""
    import os
    import tempfile

    import numpy as np

    from nllstpu_torch.core.optimize import compile_problem
    from nllstpu_torch.models.bal import load_bal, make_realistic_bal, write_bal
    from nllstpu_torch.ops import export
    from nllstpu_torch.utils import checkpoint, native

    problem, route = posegraph_problem(device)
    comp = compile_problem(problem, route["unfixed"], solver="dense")
    v = problem.stacked_variables()
    a, _ = export.hessian_dense(comp, v)
    rows, cols, vals = export.hessian_coo(comp, v)
    summed = torch.zeros_like(a).index_put_(
        (torch.as_tensor(rows, device=device), torch.as_tensor(cols, device=device)),
        torch.as_tensor(vals, device=device), accumulate=True)
    err = rel_err(summed, a)
    print(f"export {POSEGRAPH}: H {tuple(a.shape)}, {len(vals)} COO entries summed against "
          f"hessian_dense: rel err {err:.2e}", flush=True)
    if not err <= TOL_F64:
        raise AssertionError(f"export: COO sum departs from hessian_dense by {err}")
    del comp, a, summed
    with tempfile.TemporaryDirectory() as tmp:
        problem, _ = view_problem("bench-realistic", device)
        saved = {k: t.clone() for k, t in problem.stacked_variables().items()}
        path = os.path.join(tmp, "state.npz")
        checkpoint.save_variables(path, problem, extra={"lm_lambda": 1e-3})
        problem.set_values({k: torch.zeros_like(t) for k, t in saved.items()})
        extras = checkpoint.load_variables(path, problem)
        same = all(torch.equal(problem.stacked_variables()[k], t) for k, t in saved.items())
        data = make_realistic_bal(**BAL["bench-realistic"][0])
        path = os.path.join(tmp, "bench.txt")
        write_bal(path, data)
        t0 = time.perf_counter()
        got = load_bal(path)
        secs = time.perf_counter() - t0
        equal = all(np.array_equal(got[k], data[k]) for k in data)
    print(f"checkpoint: round trip bit-identical {same}, extras {dict(extras)}; load_bal "
          f"({native.LAST_PARSER} parser) {len(data['pt_idx'])} observations in {secs:.3f} s, "
          f"arrays identical {equal}", flush=True)
    if not (same and native.LAST_PARSER == "native" and equal):
        raise AssertionError("checkpoint or native parser failed")


def profile_block(label, fn):
    """``fn()`` under ``torch.profiler``: wall time, the summed device time
    of every kernel, the device's idle share, the host's launches and the
    kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [(e.key, e.count, e.self_device_time_total / 1e3)
               for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(e.count for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU and e.key in LAUNCH_APIS)
    busy_ms = sum(ms for _, _, ms in kernels)
    top = sorted(kernels, key=lambda k: -k[2])[:6]
    print(f"profile {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%, {sum(c for _, c, _ in kernels)} kernels on "
          f"the device, {launches} host launches | "
          + "; ".join(f"{name[:60]} {c}x {ms:.3f} ms" for name, c, ms in top), flush=True)


def phase_alternation(device, smi):
    """Phase 21 (see the module docstring): per-variable alternation, the
    views, the runner cache, export, checkpoint and the native parser.
    Returns the launch counts and the B6 records per path."""
    import nllstpu_torch as nt
    from nllstpu_torch.models.bal import PT

    launches, inputs = phase_singles(device, smi)
    _, problem, _ = singles_problem("Dubrovnik-class", device)
    profile_block("Dubrovnik-class singles (LM, float32)",
                  lambda: nt.optimize_singles(problem, nt.Options(), targets=PT))
    del problem
    mark("alternation: optimize_singles")
    view_launches, view_inputs = phase_views(device, smi)
    launches.update(view_launches)
    inputs.update(view_inputs)
    mark("alternation: subset views")
    phase_cache(device, smi)
    phase_utils(device, smi)
    records = {label: b6_case(label, data, st) for label, (data, st) in inputs.items()}
    mark("alternation: runner cache, export, checkpoint, native parser, B6 records")
    return launches, records


#: The sharded phase: ``SHARDED_WORLD`` rank processes (started by
#: ``spawn``) through ``nllstpu_torch.parallel.optimize_sharded``, over
#: ``nccl`` with a card per rank, else over ``gloo`` with every rank on
#: ``cuda:0`` (each ``all_reduce`` staged through the host); the paths and
#: the Dubrovnik-class run's iterations.
SHARDED_WORLD = 2
SHARDED_GAUGE = "gauge-fixed pinhole f64 B1"
SHARDED_BIG = "Dubrovnik-class"
SHARDED_BIG_ITERS = 3
SHARDED_PATHS = ("pinhole bench", "bench-realistic", SHARDED_GAUGE, SHARDED_BIG)
#: Seconds the ranks may take in all, and the process group's timeout on
#: every collective (a rank that diverges fails the phase, not hangs it).
SHARDED_DEADLINE = 600
SHARDED_COLLECTIVE_TIMEOUT = 300


def sharded_case(label, device):
    """``(problem, options, unfixed, needs, never)`` of a sharded path:
    the kernels every rank must launch and those it must not."""
    generic = ("place_w", "reduce_s", "fused_obs_leg")
    if label == "pinhole bench":
        return (bench_problem(device), bench_options(), None,
                ("fused_obs_all", "segment_block_sum", "reduce_s_damped"),
                ("fused_obs_all_into", "reduce_s_lm", *generic))
    if label == "bench-realistic":
        return (bal_problem(label, device), bench_options(), None,
                ("fused_obs_all_into", "segment_block_sum", "reduce_s_damped"),
                ("fused_obs_all", "reduce_s_lm", *generic))
    if label == SHARDED_GAUGE:
        problem, route = gauge_problem(torch.float64, device)
        return (problem, bench_options(), route["unfixed"],
                ("fused_obs_all", "segment_block_sum", "reduce_s_lm"),
                ("fused_obs_all_into", "reduce_s_damped", *generic))
    opts = dataclasses.replace(implicit_options(label), max_iters=SHARDED_BIG_ITERS)
    return (bal_problem(label, device), opts, None, ("segment_block_sum",),
            ("fused_obs_all", "fused_obs_all_into", "reduce_s_damped", "reduce_s_lm", *generic))


def shard_bytes(par, problem):
    """This rank's landmark system against the one-card one: one local
    assembly (outside any counted run) gives ``h_ll`` and W (the implicit
    solve: its coupling blocks); asserts that the rank holds its ``Lc``
    landmark slots, 1/n of the landmarks up to the pad (strided ownership:
    up to one slot per degree bucket), and never the global W.  The
    implicit solve's coupling blocks are set against the sum of every
    rank's (one collective): their share follows the costs of the rank's
    landmarks, which the JAX package's contiguous ownership does not
    balance."""
    _, sys_ = par.local.assemble(problem.stacked_variables())
    h_ll, w = sys_[2], sys_[4]
    L, lc, n = par.num_elim, par.num_elim_local, par.n_devices
    info = par.info
    elt = h_ll.element_size()
    route = par.plan.route
    slack = 0 if route is None or par.gid_table is None else len(par.plan.buckets[route])
    if not (h_ll.shape[-1] == lc and lc * n >= L and lc <= -(-L // n) + slack):
        raise AssertionError(f"sharded: h_ll {tuple(h_ll.shape)} holds not 1/{n} of {L} "
                             f"landmarks (Lc {lc})")
    out = dict(L=L, lc=lc, h_ll=h_ll.numel() * elt,
               h_ll_global=L * info.dof_elim ** 2 * elt)
    if isinstance(w, torch.Tensor):
        if w.shape[0] != lc:
            raise AssertionError(f"sharded: W {tuple(w.shape)} is not this rank's {lc} slots")
        out.update(w=w.numel() * elt, w_global=L * info.dof_elim * info.dim_reduced * elt)
    else:
        mine = sum(wp.w_blk.numel() for wp in w)
        total = par.mesh.all_reduce(torch.tensor(float(mine), dtype=torch.float64,
                                                 device=h_ll.device))
        out.update(w=mine * elt, w_global=int(total.item()) * elt)
    return out


def shard_vs_plain(label, par, problem, opts, unfixed):
    """This rank's shard through the kernels against the same shard through
    the plain versions (``compile_sharded(plain=True)``), both held to a
    float64 plain yardstick of the same inputs: the local assembly (B1 or
    B2 with B6; a_rr and b_r summed over the ranks; the implicit solve's
    coupling blocks), then at λ = 0 and 1e-2 the rank's own reduction of
    its local W (B3, or B4 within ``TOL_B57_F64``) and the direct solve's
    reduced system (S and its rhs summed over the ranks, the landmarks'
    damped inverses; scaled as phase 3 scales them), or the implicit solve's PCG
    pieces at λ = 1e-6 and 1e-7 of max diag (B6 in every sum: the
    Schur-Jacobi inverses, the preconditioned residual, the right-hand
    side's and one reduced matvec's W terms, the matvec) and one damped
    solve's PCG iterations.  In float64 the
    kernels hold ``TOL_F64``; in float32 each error stays within the
    larger of ``TOL_B1_F32`` (assembly) or ``TOL_B3_F32`` (solve) and 10x
    the plain float32 shard's own error (phase 3's rule).  Every rank runs
    it, in the same order (its collectives are the ranks').  Returns the
    kernels' largest error per stage and, on the implicit solve, one damped
    solve's PCG iterations at each of those λ."""
    from nllstpu_torch.ops import schur_reduce
    from nllstpu_torch.parallel import schur_shard

    mesh, device = par.mesh, par.device
    f64 = problem.dtype == torch.float64
    v = problem.stacked_variables()
    yard = schur_shard.compile_sharded(problem, mesh, opts, unfixed, plain=True,
                                       dtype=torch.float64)
    same = None if f64 else schur_shard.compile_sharded(problem, mesh, opts, unfixed, plain=True)
    v64 = {k: x.double() for k, x in v.items()}
    out = {}

    def held(what, tol, errs, got, plain_out, ref):
        e_k = errs(got, ref)
        e_p = [0.0] * len(e_k) if plain_out is None else errs(plain_out, ref)
        tols = [max(tol, 10 * e) for e in e_p]
        if not all(e <= t for e, t in zip(e_k, tols)):
            raise AssertionError(f"sharded {label} rank {mesh.rank}: {what}: the kernels' errors "
                                 f"{e_k} exceed {tols} (plain {e_p})")
        out[what] = max(e_k)
        print(f"sharded {label} rank {mesh.rank} {what} against the float64 plain shard: "
              f"kernels {['%.2e' % e for e in e_k]}, plain "
              f"{'(is the yardstick)' if plain_out is None else ['%.2e' % e for e in e_p]}, "
              f"tolerance {['%.2e' % t for t in tols]}", flush=True)

    def rel_errs(a, b):
        return [rel_err(x, y) for x, y in zip(a, b)]

    def flat(sys_):
        a, b, h, g, w = sys_
        if not isinstance(w, torch.Tensor):
            w = torch.cat([wp.w_blk.reshape(-1) for wp in w])
        return a, b, h, g, w

    sys_k, sys_y = par._assemble(v)[1], yard._assemble(v64)[1]
    sys_p = None if f64 else same._assemble(v)[1]
    tol = TOL_F64 if f64 else TOL_B1_F32
    held("assembly a_rr/b_r/h_ll/g_l/W", tol, rel_errs, flat(sys_k),
         None if f64 else flat(sys_p), flat(sys_y))
    tol = TOL_F64 if f64 else TOL_B3_F32
    if not par.info.implicit:
        ops = par.ops()
        _, _, h, g, w = sys_k
        h = ops._damped_h(h)
        rows = par.local.schur_info.w_rows
        for lam in (0.0, 1e-2):
            lam_t = torch.full((), lam, dtype=torch.float64, device=device)
            # The rank's own reduction (B3 in float32, B4 over float64
            # inverses) on its local W, before the sum over the ranks.
            if f64:
                h_inv = ops.damped_inverse(h, lam_t)
                held(f"local B4 lam={lam} s_sum/rhs_sum", TOL_B57_F64, rel_errs,
                     ops.reduce_lm(w, h_inv, g, rows), None,
                     schur_reduce.reduce_s_reference(w, h_inv, g))
            else:
                held(f"local B3 lam={lam} s_sum/rhs_sum/h_inv", tol, scaled_errs,
                     ops.reduce(w, h, g, lam_t, rows),
                     schur_reduce.reduce_s_damped_reference(w, h, g, lam),
                     schur_reduce.reduce_s_damped_reference(w.double(), h.double(),
                                                            g.double(), lam))
            held(f"reduced lam={lam} S/rhs/h_inv", tol, scaled_errs,
                 ops.reduced(sys_k, lam_t),
                 None if f64 else same.ops().reduced(sys_p, lam_t),
                 yard.ops().reduced(sys_y, lam_t))
        return out
    ops_k, ops_y = par.ops(opts), yard.ops(opts)
    diag = float(ops_y.diag_max(sys_y))
    gen = torch.Generator().manual_seed(11)
    vec = torch.randn(par.info.dim_reduced, generator=gen, dtype=torch.float64).to(device)

    def pieces(ops, sys_, lam):
        # The right-hand side's W term Σ W H⁻¹ g_l and the matvec's
        # Σ W H⁻¹ Wᵀ v (B6 over each rank's coupling blocks, then over the
        # ranks) apart from what they are subtracted from, whose float32
        # cancellation would hide them.
        _, _, _, g_l, wparts = sys_
        h_inv, inv, _, state = ops.pcg_setup(sys_, lam)
        u = vec.to(sys_[0].dtype)
        hu = torch.einsum("del,el->dl", h_inv, ops._wt_apply(wparts, u))
        return (torch.cat([i.reshape(-1) for i in inv]), state[2],
                ops._reduce(ops._w_apply(wparts, torch.einsum("del,el->dl", h_inv, g_l))),
                ops._reduce(ops._w_apply(wparts, hu)), ops.s_matvec(sys_, h_inv, lam, u))

    # The LM's first λ (1e-6·max diag, core.rules.lm_start) and a tenth of
    # it: the damping of the run's solves, where the preconditioner's W
    # correction shapes its blocks.
    out.update(solve_lams=[], solve_iters=[])
    for rel in (1e-6, 1e-7):
        lam = rel * diag
        held(f"PCG pieces lam={rel}*max diag inverses/z/W H^-1 g/W H^-1 W^T v/S v", tol,
             rel_errs,
             pieces(ops_k, sys_k, lam),
             None if f64 else pieces(same.ops(opts), sys_p, lam), pieces(ops_y, sys_y, lam))
        ops_k.solve(sys_k, lam)
        out["solve_lams"].append(lam)
        out["solve_iters"].append(ops_k.cg_iters[-1])
    return out


def sharded_rank(rank, world, backend, store, outdir):
    """One rank of the sharded phase (a spawned process): join the group,
    then for every path build the problem on this rank's card, measure its
    shard (:func:`shard_bytes`), hold its kernels to their plain versions
    on the shard's inputs (:func:`shard_vs_plain`; on a bucketed shard
    also B2 over the local bucket plan, :func:`b2_case`, timed by rank 0),
    run the implicit solve once through ``ShardedSchurCompiled.run`` for
    its PCG iterations, and run it through ``optimize_sharded``
    with the launch counts set to 0 just before and read just after,
    collectives timed by CUDA events; writes its rows as JSON to
    ``outdir``.  It loads the library the build phase made and builds
    nothing."""
    import datetime
    import os

    from nllstpu_torch.core import structs
    from nllstpu_torch.ops import _build
    from nllstpu_torch.parallel import distributed, make_mesh, optimize_sharded, schur_shard

    distributed.initialize(backend, f"file://{store}", world_size=world, rank=rank,
                           timeout=datetime.timedelta(seconds=SHARDED_COLLECTIVE_TIMEOUT))
    mesh = make_mesh(world)
    device = mesh.device
    torch.cuda.set_device(device)
    rows = []
    for label in SHARDED_PATHS:
        problem, opts, unfixed, needs, never = sharded_case(label, device)
        par = schur_shard.compile_sharded(problem, mesh, opts, unfixed)
        if _build.BUILD_SECONDS:
            raise AssertionError(f"sharded rank {rank}: built the kernel library itself")
        sizes = shard_bytes(par, problem)
        checks = shard_vs_plain(label, par, problem, opts, unfixed)
        b2 = None
        if par.plan.route is not None and par.gid_table is not None:
            # B2 over this rank's local bucket plan; rank 0 times it while
            # the others wait in the collective after it.
            loc = par.local.schur_info
            b2, _, _ = b2_case(f"sharded {label} rank {rank} local buckets",
                               par.local.batches[par.plan.route], loc, loc.fast[par.plan.route],
                               problem.stacked_variables(), timed=rank == 0)
            mesh.all_reduce(torch.zeros(1, device=device))
        pcg_run = None
        if par.info.implicit:
            pcg_run = par.run(problem.stacked_variables(), opts)["cg_iters"]
        del par
        gc.collect()
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
        _reset_counts()
        n_coll = mesh.collectives
        with mesh.timed() as coll:
            result = optimize_sharded(problem, mesh, opts, unfixed=unfixed)
            torch.cuda.synchronize(device)
        launches = _read_counts()
        if not all(launches[k] > 0 for k in needs) or any(launches[k] for k in never):
            raise AssertionError(f"sharded {label} rank {rank}: launches {launches}; needed "
                                 f"{needs}, never {never}")
        final = problem.stacked_variables()
        nan = structs.TERM_COST_NAN | structs.TERM_STEP_NAN
        rows.append(dict(
            label=label, rank=rank, device=str(device), iterations=result.num_iterations,
            start=result.start_cost, best=result.best_cost, costs=result.costs,
            termination=result.termination, nan=bool(result.termination & nan),
            finite=all(bool(torch.isfinite(v).all()) for v in final.values()),
            loop=result.time_total - result.time_init, init=result.time_init,
            phases=[result.time_gradient, result.time_solver, result.time_cost],
            collectives=mesh.collectives - n_coll, collective_s=sum(coll),
            peak=torch.cuda.max_memory_allocated(device) - held, launches=launches, **sizes,
            checks=checks, b2=b2, pcg_run=pcg_run,
        ))
        del problem, result, final
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(rows, f)
    torch.distributed.destroy_process_group()


def phase_sharded(device, smi):
    """The sharded phase: the one-rank port runs of the four paths
    (``nt.optimize``), then ``SHARDED_WORLD`` ranks through
    ``optimize_sharded`` (:func:`sharded_rank`).  Gates: both ranks end
    with the same bits (costs, best cost, iterations); the pinhole bench
    and bench-realistic meet phase 6's JAX constants with its slack and
    the one-rank run's best cost within 1e-4; the gauge-fixed float64 trace
    lies within 1e-9 of ``GAUGE_REF`` and of the one-rank run; the
    Dubrovnik-class implicit run is finite and its best cost within 1e-3
    of the one-rank run's (sharding reorders the float32 sums, and the
    PCG stops at ``linear_tol``), one damped solve of its start system
    takes the one-card PCG iterations ±1 and the run's iterations per
    solve stay within 2 of the one-card range under a one-ulp change of
    the start; every rank's kernels hold their plain versions on its
    shard (:func:`shard_vs_plain`, raised in the rank).  Every path is
    printed before a failed gate raises.  The one-rank runs take the
    stepped driver, as the ranks do, so that their rates compare.  Returns
    rank 0's launches per path and B2's record over rank 0's local bucket
    plan."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    import nllstpu_torch as nt

    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= SHARDED_WORLD else "gloo"
    on = [f"cuda:{r % cards}" for r in range(SHARDED_WORLD)]
    how = ("" if backend == "nccl" else "; the ranks share one card and gloo stages every "
           "all_reduce through the host: no NCCL or NVLink time")
    print(f"sharded: {SHARDED_WORLD} ranks over {backend} on {on} ({cards} card(s)){how} "
          f"| {smi}", flush=True)
    from nllstpu_torch.core.optimize import compile_problem

    single, big = {}, None
    for label in SHARDED_PATHS:
        problem, opts, unfixed, _, _ = sharded_case(label, device)
        res = nt.optimize(problem, dataclasses.replace(opts, store_trajectory=True),
                          unfixed=unfixed)
        torch.cuda.synchronize()
        single[label] = res
        print(f"sharded {label} one rank (nt.optimize): {res.num_iterations} iterations, "
              f"{res.num_iterations / (res.time_total - res.time_init):.3f} it/s, start cost "
              f"{res.start_cost!r}, best cost {res.best_cost!r}", flush=True)
        if label == SHARDED_BIG:
            # The one-card PCG iterations per damped solve from the start
            # and from it scaled by 1 ± 2^-23 (its own range under a
            # one-ulp change), and the system for one damped solve at the
            # ranks' λ.
            problem, opts, _, _, _ = sharded_case(label, device)
            comp = compile_problem(problem, solver=opts.solver, schur_family=opts.schur_family)
            v = problem.stacked_variables()
            spread = [run_driver("stepped", comp, opts, {k: x * f for k, x in v.items()})
                      ["cg_iters"] for f in (1.0, 1 + 2**-23, 1 - 2**-23)]
            big = (comp.ctx(opts).linops, comp.assemble(v)[1], spread)
        del problem, res
    gc.collect()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            sharded_rank, args=(SHARDED_WORLD, backend, os.path.join(tmp, "store"), tmp),
            nprocs=SHARDED_WORLD, join=False, start_method="spawn",
        )
        deadline = time.perf_counter() + SHARDED_DEADLINE
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() > deadline:
                    raise AssertionError(f"sharded: the ranks ran past {SHARDED_DEADLINE} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        ranks = []
        for r in range(SHARDED_WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    launches, b2, failed = {}, {}, []
    for i, label in enumerate(SHARDED_PATHS):
        rows = [rk[i] for rk in ranks]
        one = single[label]
        for row in rows:
            print(f"sharded {label} rank {row['rank']}: the kernels' largest error against the "
                  f"float64 plain shard per stage {row['checks']}", flush=True)
        if rows[0]["b2"] is not None:
            b2[f"sharded {label} rank 0"] = rows[0]["b2"]
        for row in rows:
            loop = row["loop"]
            print(f"sharded {label} rank {row['rank']} on {row['device']}: "
                  f"{row['iterations']} iterations in {loop:.3f} s = "
                  f"{row['iterations'] / loop:.3f} it/s (set-up {row['init']:.3f} s; assemble, "
                  f"solve, cost {['%.3f' % t for t in row['phases']]} s), best cost "
                  f"{row['best']!r}; {row['collectives']} collectives taking "
                  f"{row['collective_s'] * 1e3:.3f} ms = {100 * row['collective_s'] / loop:.1f}% "
                  f"of the loop; Lc {row['lc']} of L {row['L']}: h_ll "
                  f"{row['h_ll'] / 2**20:.3f} MiB of {row['h_ll_global'] / 2**20:.3f} MiB, "
                  f"{'W' if label != SHARDED_BIG else 'coupling blocks'} "
                  f"{row['w'] / 2**20:.3f} MiB of {row['w_global'] / 2**20:.3f} MiB; peak "
                  f"device memory {row['peak'] / 2**20:.1f} MiB above the process; launches "
                  f"{row['launches']} | {smi}", flush=True)
            if row["nan"] or not row["finite"]:
                failed.append(f"{label} rank {row['rank']}: a NaN cost or step")
        for key in ("iterations", "start", "best", "costs"):
            if any(row[key] != rows[0][key] for row in rows):
                failed.append(f"{label}: the ranks' {key} differ")
        got = rows[0]
        rel = abs(got["best"] - one.best_cost) / abs(one.best_cost)
        if label == SHARDED_GAUGE:
            ref = GAUGE_REF["costs"]
            n = min(len(ref), len(got["costs"]))
            errs = [abs(a - b) / abs(b) for a, b in zip(got["costs"], ref)]
            mine = [abs(a - b) / abs(b) for a, b in zip(got["costs"], one.costs)]
            start = abs(got["start"] - GAUGE_REF["start"]) / GAUGE_REF["start"]
            print(f"sharded {label}: rel err per iteration against GAUGE_REF "
                  f"{['%.2e' % e for e in errs]}, against the one-rank run "
                  f"{['%.2e' % e for e in mine]}", flush=True)
            if not (start <= 1e-12 and n >= len(ref) - 1 and max(errs) <= 1e-9
                    and len(mine) >= n and max(mine) <= 1e-9):
                failed.append(f"{label}: the trace departs from GAUGE_REF or the one-rank run")
        elif label == SHARDED_BIG:
            print(f"sharded {label}: best cost {got['best']!r} against the one-rank run's "
                  f"{one.best_cost!r}, rel {rel:.2e}", flush=True)
            if not rel <= 1e-3:
                failed.append(f"{label}: best cost {got['best']} departs from the one-rank "
                              f"run's {one.best_cost}")
            # PCG iterations: one damped solve of the start system at the
            # same λ, two ranks against one card (±1); the runs' iterations
            # per solve against the one-card range under a one-ulp change
            # of the start, widened by 2 (the ranks' summation order moves
            # a float64 CPU run's counts by up to 2:
            # tests/test_torch_parallel.py).
            ops, sys_, spread = big
            one_solve = []
            for lam in got["checks"]["solve_lams"]:
                ops.solve(sys_, lam)
                one_solve.append(ops.cg_iters[-1])
            two_solve = got["checks"]["solve_iters"]
            lo = [min(c) for c in zip(*spread)]
            hi = [max(c) for c in zip(*spread)]
            run = got["pcg_run"]
            print(f"sharded {label}: PCG iterations of one damped solve of the start system at "
                  f"lam {got['checks']['solve_lams']!r}: two ranks {two_solve}, one card "
                  f"{one_solve}; per damped solve of a run: two ranks {run}, one card "
                  f"{spread[0]} (from the start scaled by 1 ± 2^-23: {spread[1]}, "
                  f"{spread[2]})", flush=True)
            if any(abs(a - b) > 1 for a, b in zip(one_solve, two_solve)):
                failed.append(f"{label}: one damped solve took {two_solve} PCG iterations on "
                              f"two ranks, {one_solve} on one card")
            if not (len(set(map(len, spread))) == 1 and len(run) == len(lo)
                    and all(a - 2 <= r <= b + 2 for r, a, b in zip(run, lo, hi))):
                failed.append(f"{label}: the run's PCG iterations {run} leave the one-card "
                              f"range {lo}..{hi} by more than 2")
            del big, ops, sys_
        else:
            start_ref, best_ref, slack = ((REF_START_COST, REF_BEST_COST, 1e-3)
                                          if label == "pinhole bench" else BAL[label][1:])
            print(f"sharded {label}: start {got['start']!r}, best {got['best']!r} against the "
                  f"JAX package's {start_ref!r}, {best_ref!r}, the one-rank run's best "
                  f"{one.best_cost!r} (rel {rel:.2e})", flush=True)
            if not (abs(got["start"] - start_ref) <= 1e-4 * abs(start_ref)
                    and got["best"] <= best_ref + slack * abs(best_ref) and rel <= 1e-4):
                failed.append(f"{label}: best cost {got['best']} misses the JAX constants or "
                              "the one-rank run")
        launches[f"sharded {label} rank 0"] = got["launches"]
    if failed:
        raise AssertionError("sharded: " + "; ".join(failed))
    return launches, b2


_CLOCK = [time.perf_counter()]


#: Phase 23's paths (``scripts_torch/shapes_reference.py``: the planar
#: dl = 2 problem at the pinhole bench's size and the stereo three-row
#: problem over bench-realistic) and the JAX package's CPU references
#: (``JAX_PLATFORMS=cpu python scripts_torch/shapes_reference.py``): float32
#: start and best cost after 30 LM iterations, the float64 trace at
#: ``rel_dcost=1e-6``.
PLANAR = "planar dl=2"
PLANAR_F64 = "planar dl=2 f64"
PLANAR_FUSED = "planar dl=2 fused"
STEREO = "stereo bench-realistic"
SHAPES_REF = {
    PLANAR: dict(start=297.6598205566406, best=0.09593155980110168),
    PLANAR_F64: dict(start=297.6598322962617, best=0.09593161726761104,
                     costs=[0.09928079074833866, 0.0959316172753191, 0.09593161726761104]),
    STEREO: dict(start=1397342.25, best=0.11985284090042114),
}
#: Phase 23's kernel tolerances, ``tests/test_torch_cuda.py``'s: of the
#: largest entry, against the float64 plain version.
TOL_SHAPE_F32, TOL_SHAPE_F64 = 1e-5, 1e-12


@functools.lru_cache(maxsize=None)
def shapes_data(kind):
    from scripts_torch import shapes_reference

    return shapes_reference.full_data(kind)


def shapes_problem(kind, dtype, device):
    """Phase 23's ``kind`` ("planar" or "stereo") problem in ``dtype``,
    its points perturbed as the bench's."""
    import nllstpu_torch as nt
    from nllstpu_torch.models.ba import perturb_ba
    from scripts_torch import shapes_reference

    problem, _, points = shapes_reference.build(nt, kind, shapes_data(kind), dtype, device)
    perturb_ba(problem, points, 0.05, seed=5)
    return problem


def shapes_options(kind, f64=False):
    """The bench options over ``kind``'s landmark family; float64: the
    trace gate's (``rel_dcost=1e-6``)."""
    import nllstpu_torch as nt

    fam = nt.Euclidean(2 if kind == "planar" else 3)
    if f64:
        return nt.Options(solver="schur", schur_family=fam, rel_dcost=1e-6,
                          max_time=float("inf"))
    return dataclasses.replace(bench_options(), schur_family=fam)


def synthetic_tile(gen, n, dr_s, dl, device, K=14):
    """A bench-sized B1/B8 tile ``[n, S, K, L]`` (``NLMK`` landmarks over
    ``NCAM`` cameras) of shape (n, dr_s, dl),
    every landmark seeing a camera twice and every third one a dustbin
    slot (zero weights), as ``(floats, ints)``: B1's ``(vc, cpos, cstarts,
    n_r, dr_s, dl, e_start)``, the landmark after the camera."""
    from nllstpu_torch.ops import fused_obs

    s, L, n_r = dr_s + dl, NLMK, NCAM
    floats = [
        torch.randn(n, s, K, L, generator=gen, dtype=torch.float64),
        torch.randn(s, K, L, generator=gen, dtype=torch.float64),
        torch.rand(K, L, generator=gen, dtype=torch.float64) + 0.05,
        -0.2 * torch.rand(K, L, generator=gen, dtype=torch.float64),
    ]
    vc = torch.randint(0, n_r, (K, L), generator=gen, dtype=torch.int32)
    vc[1] = vc[0]
    vc[K - 1, ::3] = n_r
    floats[2][K - 1, ::3] = 0.0
    floats[3][K - 1, ::3] = 0.0
    vc = vc.to(device)
    return ([t.to(device) for t in floats],
            (vc, *fused_obs.camera_tables(vc, n_r), n_r, dr_s, dl, dr_s))


def synthetic_batch(gen, n, dr_s, dl, device):
    """A B2 input of shape (n, dr_s, dl) over bench-realistic's observation
    pattern (the stereo problem's cameras and points of each observation,
    in its order; random values, the landmark after the camera): ``(head,
    tail, fast, L, n_obs)``, ``fast`` the camera runs."""
    import numpy as np

    from nllstpu_torch.ops import fused_obs

    data = shapes_data("stereo")
    lid, vc = data["pt_idx"], data["cam_idx"]
    L, n_r, b = int(lid.max()) + 1, int(vc.max()) + 1, lid.shape[0]
    s = dr_s + dl
    cpos, cstarts = fused_obs.camera_order(vc, n_r)
    slots = fused_obs.slot_tables(lid, vc, L, n_r)
    floats = [torch.randn(n, s, b, generator=gen, dtype=torch.float64),
              torch.randn(b, s, generator=gen, dtype=torch.float64).T,
              torch.rand(b, generator=gen, dtype=torch.float64) + 0.05,
              -0.2 * torch.rand(b, generator=gen, dtype=torch.float64)]
    head = ([t.to(device) for t in floats]
            + [torch.as_tensor(x, dtype=torch.int32, device=device) for x in (vc, cpos)]
            + [fused_obs.SlotTables(*(torch.as_tensor(t, device=device) for t in slots))])
    fast = types.SimpleNamespace(cam_starts=np.asarray(cstarts),
                                 cstarts=torch.as_tensor(cstarts, device=device))
    return head, (n_r, dr_s, dl, dr_s), fast, L, b


def tile_case(label, floats, ints, n_obs, dtypes=(torch.float32,)):
    """B1 (with B6 over its camera rows) and B8 against their plain
    versions on one tile: float64 within ``TOL_SHAPE_F64`` and float32
    within ``TOL_SHAPE_F32`` of the largest entry, two launches the same
    bits; each one's times (events and graph) in each of ``dtypes``, its
    plain version's and its bound.  Returns a record per kernel and
    timed dtype."""
    from nllstpu_torch.ops import fused_obs

    vc, cpos, cstarts, n_r, dr_s, dl, e_start = ints
    n = floats[0].shape[0]
    f64, f32 = [t.double() for t in floats], [t.float() for t in floats]
    records = {}
    for name, kern, plain, tail, cam in (
        ("fused_obs_all", fused_obs.fused_obs_all, fused_obs.fused_obs_all_reference,
         (vc, cpos, cstarts, n_r, dr_s, dl, e_start), True),
        ("fused_obs_leg", fused_obs.fused_obs_leg, fused_obs.fused_obs_leg_reference,
         (vc, n_r, dr_s, dl, e_start), False),
    ):
        ref = plain(*f64, *tail)
        out64, out32, again = kern(*f64, *tail), kern(*f32, *tail), kern(*f32, *tail)
        torch.cuda.synchronize()
        e64 = check(f"{name} f64 {label}", out64, ref, TOL_SHAPE_F64)
        e32 = check(f"{name} f32 {label}", out32, ref, TOL_SHAPE_F32)
        if not all(torch.equal(a, b) for a, b in zip(out32, again)):
            raise AssertionError(f"{name} {label}: two launches differ")
        print(f"{'B1' if cam else 'B8'} {label} ((n, dr_s, dl) = ({n}, {dr_s}, {dl}), "
              f"{n_obs} observations, W {tuple(out32[2].shape)}): rel err f64 "
              f"{['%.2e' % e for e in e64]} f32 {['%.2e' % e for e in e32]}, two launches "
              f"bit-identical", flush=True)
        records[name] = {}
        for dt, x, out in ((torch.float32, f32, out32), (torch.float64, f64, out64)):
            if dt not in dtypes:
                continue
            ms = time_ms(lambda: kern(*x, *tail))
            device_ms = graph_ms(lambda: kern(*x, *tail))
            plain_ms = time_ms(lambda: plain(*x, *tail))
            ins = (vc, cpos, cstarts) if cam else (vc,)
            b = bound(nbytes(*x, *ins, *out), assembly_flops(n_obs, dr_s, dl, n, cam), dt)
            print(f"{'B1' if cam else 'B8'} {label} {dt} time: kernel {ms:.4f} ms (in a CUDA "
                  f"graph {device_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']})", flush=True)
            records[name][dt] = dict(max_abs_err=max(abs_err(a, r) for a, r in zip(out, ref)),
                                     ms=ms, plain_ms=plain_ms, **b, graph_ms=device_ms)
    return records


def external_case(name, label, inputs, tables, device):
    """B4 (``reduce_s_lm``) or B5 (``reduce_s``) against their plain
    version on a W past the unrolled dl (``inputs``: W, the inverses, g_l
    in float64, the inverses then laid out as the solve's are; ``tables``
    its structure, host or uploaded): float64
    within ``TOL_SHAPE_F64`` and float32 within ``TOL_SHAPE_F32`` of the
    largest entry, two launches the same bits, s_sum exactly symmetric;
    the float32 times, the structural bound, the plain version's and
    cuBLAS's ``Yᵀ W``.  Returns the record."""
    from nllstpu_torch.ops import schur_reduce

    if tables.device is None:
        tables = schur_reduce.upload_tables(tables, device)
    kern = getattr(schur_reduce, name)
    plain = schur_reduce.reduce_s_reference
    inputs = [t.to(device) for t in inputs]
    # The inverses as the solve gives them: landmark-major underneath.
    inputs[1] = inputs[1].permute(2, 0, 1).contiguous().permute(1, 2, 0)
    f64, f32 = [t.double() for t in inputs], [t.float() for t in inputs]
    ref = plain(*f64)
    out64, out32, again = kern(*f64, tables), kern(*f32, tables), kern(*f32, tables)
    torch.cuda.synchronize()
    e64 = check(f"{name} f64 {label}", out64, ref, TOL_SHAPE_F64)
    e32 = check(f"{name} f32 {label}", out32, ref, TOL_SHAPE_F32)
    if not all(torch.equal(x, y) for x, y in zip(out32, again)):
        raise AssertionError(f"{name} {label}: two launches differ")
    if not (torch.equal(out32[0], out32[0].T) and torch.equal(out64[0], out64[0].T)):
        raise AssertionError(f"{name} {label}: s_sum is not exactly symmetric")
    ms = time_ms(lambda: kern(*f32, tables))
    device_ms = graph_ms(lambda: kern(*f32, tables))
    plain_ms = time_ms(lambda: plain(*f32))
    library_ms = time_ms(gemm_call(*f32[:2]))
    L, dl, wc = f32[0].shape
    pb, pf = struct_work(tables, dl, 4)
    b = bound(pb + nbytes(*out32), pf)
    dense = bound(nbytes(*f32, *out32), reduce_flops(L, dl, wc))
    print(f"{'B4' if name == 'reduce_s_lm' else 'B5'} {label} (W {tuple(f32[0].shape)}, "
          f"{tables.links.shape[0]} links in {tables.items.shape[0]} items): rel err s_sum/rhs "
          f"f64 {['%.2e' % e for e in e64]} f32 {['%.2e' % e for e in e32]}, two launches "
          f"bit-identical, s_sum symmetric | kernel {ms:.4f} ms (in a CUDA graph "
          f"{device_ms:.4f} ms), plain {plain_ms:.4f} ms, cuBLAS Y^T W {library_ms:.4f} ms, "
          f"structural bound {b['bound_ms']:.4f} ms ({b['bound_by']}), dense bound "
          f"{dense['bound_ms']:.4f} ms", flush=True)
    return dict(max_abs_err=max(abs_err(x, y) for x, y in zip(out32, ref)), ms=ms,
                plain_ms=plain_ms, **b, dense_bound_ms=dense["bound_ms"], graph_ms=device_ms,
                library_ms=library_ms)


def phase_shapes(device, smi):
    """Phase 23 (see the module docstring): the planar dl = 2 and stereo
    three-row paths at full width, then each kernel at this slice's shapes
    against its plain version.  Returns the main paths' launch counts and
    the kernels' records, by kernel and shape (each with ``path``: the main
    path whose launches its row gives)."""
    import nllstpu_torch as nt
    from nllstpu_torch.core.optimize import compile_problem
    from nllstpu_torch.ops import schur

    launches = {}
    ref = SHAPES_REF[PLANAR]
    problem = shapes_problem("planar", torch.float32, device)
    needs = ("fused_obs_all", "segment_block_sum", "reduce_s_damped")
    launches[PLANAR] = phase_main(PLANAR, problem, ref["start"], ref["best"], 1e-3, needs=needs,
                                  never=_never(needs), options=shapes_options("planar"))[0]
    needs = ("fused_obs_leg", "reduce_s_damped")
    launches[PLANAR_FUSED] = phase_main(
        PLANAR_FUSED, shapes_problem("planar", torch.float32, device), ref["start"],
        ref["best"], 1e-3, needs=needs, never=_never(needs), options=shapes_options("planar"),
        w_impl="fused")[0]
    ref = SHAPES_REF[PLANAR_F64]
    needs = ("fused_obs_all", "reduce_s_lm")
    launches[PLANAR_F64], result = phase_main(
        PLANAR_F64, shapes_problem("planar", torch.float64, device), ref["start"], ref["best"],
        1e-9, needs=needs, never=_never(needs, ("segment_block_sum",)),
        options=shapes_options("planar", f64=True))
    trace_gate(PLANAR_F64, result, ref)
    ref = SHAPES_REF[STEREO]
    needs = ("fused_obs_all_into", "segment_block_sum", "reduce_s_damped")
    stereo = shapes_problem("stereo", torch.float32, device)
    launches[STEREO] = phase_main(STEREO, stereo, ref["start"], ref["best"], 1e-2, needs=needs,
                                  never=_never(needs), options=shapes_options("stereo"))[0]
    print(f"phase 23 main paths | {smi}", flush=True)
    mark("shapes: main paths")
    records = collections.defaultdict(dict)

    def add(name, shape, path, record):
        records[name][shape] = dict(record, path=path)

    # B1 and B8: the planar path's own tile, then synthetic bench-sized
    # tiles of three residual rows.
    problem = shapes_problem("planar", torch.float32, device)
    comp = compile_problem(problem, solver="schur", schur_family=nt.Euclidean(2))
    (batch,), (fast,) = comp.batches, comp.schur_info.fast
    _, args = schur.fused_inputs(batch, problem.stacked_variables(), comp.schur_info, fast,
                                 torch.float32)
    planar_sys = comp.assemble(problem.stacked_variables())[1], comp.schur_info.w_rows
    gen = torch.Generator().manual_seed(23)
    tiles = {f"{PLANAR} (2,6,2)": (list(args[:4]), (args[4], fast.cpos, fast.cstarts, *args[5:]),
                                   batch.n)}
    for n, dr_s, dl in ((3, 6, 3), (3, 9, 3)):
        floats, ints = synthetic_tile(gen, n, dr_s, dl, device)
        tiles[f"synthetic ({n},{dr_s},{dl}) K=14 L={NLMK}"] = (
            floats, ints, int((ints[0] < ints[3]).sum()))
    for label, (floats, ints, n_obs) in tiles.items():
        # The float64 times of the any-shape instance: the planar path's
        # own tile (the float64 planar path runs it) and (3, 9, 3).
        f64 = label.startswith(PLANAR) or "(3,9,3)" in label
        recs = tile_case(label, floats, ints, n_obs,
                         (torch.float32, torch.float64) if f64 else (torch.float32,))
        for name, path in (("fused_obs_all", PLANAR), ("fused_obs_leg", PLANAR_FUSED)):
            add(name, label, path, recs[name][torch.float32])
            if f64:
                add(name, f"{label} f64", PLANAR_F64 if name == "fused_obs_all" else path,
                    recs[name][torch.float64])
    del tiles
    # B2: the stereo path's own batch, then synthetic values over its
    # observation pattern.
    comp = compile_problem(stereo, solver="schur", schur_family=nt.Euclidean(3))
    (batch,), (fast,) = comp.batches, comp.schur_info.fast
    _, head, tail = schur.batch_inputs(batch, stereo.stacked_variables(), comp.schur_info,
                                       fast, torch.float32)
    label = f"{STEREO} (3,9,3)"
    add("fused_obs_all_into", label, STEREO,
        b2_check(label, head, tail, fast, comp.schur_info.num_elim, batch.n,
                 f"{len(fast.buckets)} buckets in one launch", tol64=TOL_SHAPE_F64,
                 tol32=TOL_SHAPE_F32))
    del head
    for n, dr_s, dl in ((2, 6, 2), (3, 6, 3), (3, 9, 3)):
        head, tail, fast, L, n_obs = synthetic_batch(gen, n, dr_s, dl, device)
        label = f"synthetic ({n},{dr_s},{dl}) over bench-realistic's pattern"
        record = b2_check(label, head, tail, fast, L, n_obs, "bench-realistic's observations",
                          tol64=TOL_SHAPE_F64, tol32=TOL_SHAPE_F32,
                          f64_timed=(n, dr_s, dl) == (3, 9, 3))
        record64 = record.pop("f64", None)
        add("fused_obs_all_into", label, STEREO, record)
        if record64 is not None:
            add("fused_obs_all_into", f"{label} f64", STEREO, record64)
    del stereo, comp, batch, fast
    mark("shapes: B1, B2, B8")
    # B3 at dl = 2 (the planar system) and dl = 1; B4 and B5 past the
    # unrolled dl.
    b3 = phase_b3(device, {PLANAR: planar_sys},
                  synthetic={"synthetic dl=1": row_case(gen, NLMK, 1, NCAM, 6, device,
                                                        inverse=False)},
                  rel_tol=TOL_SHAPE_F32)
    for label, record in b3.items():
        add("reduce_s_damped", label, PLANAR, record)
    # B4 on the float64 planar system, as its solve takes it.
    problem = shapes_problem("planar", torch.float64, device)
    comp = compile_problem(problem, solver="schur", schur_family=nt.Euclidean(2))
    _, sys_ = comp.assemble(problem.stacked_variables())
    lam = 1e-2 * comp.ctx().linops.diag_max(sys_).item()
    h_inv = schur.SchurOps.damped_inverse(sys_[2], lam)
    add("reduce_s_lm", PLANAR_F64, PLANAR_F64,
        b4_f64_case(PLANAR_F64, sys_[4], h_inv, sys_[3], comp.schur_info.w_rows, TOL_SHAPE_F64))
    del problem, comp, sys_, h_inv
    for dl, (L, n_blocks, width) in ((7, (NLMK, NCAM, 6)), (16, (4096, 80, 9))):
        *inputs, rows = row_case(gen, L, dl, n_blocks, width, device, inverse=True)
        add("reduce_s_lm", f"synthetic dl={dl}", PLANAR_F64,
            external_case("reduce_s_lm", f"synthetic dl={dl}", inputs, rows, device))
        *inputs, tables = structured_case(gen, 4096, dl, [9] * 40 + [3, 16, 1], 2)
        add("reduce_s", f"synthetic dl={dl}", ADAPTIVE,
            external_case("reduce_s", f"synthetic dl={dl}", inputs, tables, device))
    print(f"phase 23 kernels | {smi}", flush=True)
    mark("shapes: B3, B4, B5")
    return launches, records


#: Phase 24's paths (``scripts_torch/anydl_reference.py``: trajectory-space
#: NRSfM, K DCT-II coefficients per axis, so dl = 3K, at the pinhole bench's
#: size): through the obs-major route (B1 at (2, 6, 3K), B6, the damped
#: inverses, B4) at K = 3 and 6, through the dual-sorted route at K = 3 (B8,
#: B4), and the adaptive form at K = 3 through the generic route (B6, B7,
#: the damped inverses, B5's tiled instance); the JAX package's CPU
#: references (``JAX_PLATFORMS=cpu python scripts_torch/anydl_reference.py``):
#: float32 start and best cost after 30 LM iterations at K = 3 and 6 (the
#: dual-sorted route shares K = 3's), the float64 trace at K = 6 to
#: ``rel_dcost=1e-6``, and the adaptive form's float32 start, best cost and
#: recovered (σ1, σ2, w) after 30 iterations (``adaptive_k3_f32``).
NRSFM3 = "NRSfM K=3"
NRSFM6 = "NRSfM K=6"
NRSFM6_F64 = "NRSfM K=6 f64"
NRSFM3_FUSED = "NRSfM K=3 fused"
NRSFM_ADAPTIVE = "adaptive NRSfM K=3"
ANYDL = {NRSFM3: (3, torch.float32), NRSFM6: (6, torch.float32), NRSFM6_F64: (6, torch.float64),
         NRSFM3_FUSED: (3, torch.float32), NRSFM_ADAPTIVE: (3, torch.float32)}
ANYDL_REF = {
    NRSFM3: dict(start=1792637.0, best=16914.21484375),
    NRSFM6: dict(start=3533587.25, best=7881.513671875),
    NRSFM6_F64: dict(start=3533587.0315783885, best=7887.0030997294125,
                     costs=[9120.30069638757, 7887.0102194808005, 7887.0030997294125]),
    NRSFM_ADAPTIVE: dict(start=200385.71875, best=37630.31640625,
                         sigmas_weight=(0.5489867329597473, 69.76701354980469,
                                        0.8971962928771973)),
}
ANYDL_REF[NRSFM3_FUSED] = ANYDL_REF[NRSFM3]
#: Phase 24's B7 case whose float64 row (18·1620·8 = 233,280 bytes) is past
#: the 232,448 bytes of shared memory a block holds: landmarks, dl, dr_s,
#: cameras (180 Snavely cameras), observations a landmark.
B7_SPAN = dict(L=4096, dl=18, dr_s=9, n_r=180, per=13)
#: Phase 24's synthetic shapes of B1, B8 and B2 past the old caps n ≤ 4,
#: dr_s ≤ 16, dl ≤ 6 besides NRSfM's own: five residual rows, a camera of
#: 17 dof.
LIFTED_SYNTHETIC = ((5, 6, 3), (2, 17, 3))


def anydl_problem(label, device):
    """Phase 24's ``label`` problem, its points perturbed as the bench's
    (the adaptive form: with its outliers and kernel, perturbed as the
    adaptive bench-realistic path's), its options, its route and its
    kernel's handle (None but for the adaptive form)."""
    import nllstpu_torch as nt
    from nllstpu_torch.models.ba import perturb_ba
    from scripts_torch import anydl_reference

    K, dtype = ANYDL[label]
    kh = None
    if label == NRSFM_ADAPTIVE:
        problem, _, points, kh = anydl_reference.build(
            nt, anydl_reference.with_outliers(anydl_data(K)), dtype, device, adaptive=True)
        perturb_ba(problem, points, anydl_reference.ADAPTIVE_PERTURB, seed=5)
    else:
        problem, _, points = anydl_reference.build(nt, anydl_data(K), dtype, device)
        perturb_ba(problem, points, 0.05, seed=5)
    fam = nt.Euclidean(3 * K)
    if dtype == torch.float64:
        opts = nt.Options(solver="schur", schur_family=fam, rel_dcost=1e-6,
                          max_time=float("inf"))
    else:
        opts = dataclasses.replace(bench_options(), schur_family=fam)
    return problem, opts, dict(w_impl="fused") if label == NRSFM3_FUSED else {}, kh


@functools.lru_cache(maxsize=None)
def anydl_data(K):
    from scripts_torch import anydl_reference

    return anydl_reference.full_data(K)


@contextlib.contextmanager
def no_plain_kernels():
    """Fail when a plain version of B1, B2, B8, B4 or B5 runs (the
    dispatchers on CUDA tensors must launch the kernel)."""
    from nllstpu_torch.ops import fused_obs, schur_reduce

    names = [(fused_obs, n) for n in ("fused_obs_all_reference", "fused_obs_all_into_reference",
                                      "fused_obs_leg_reference")]
    names += [(schur_reduce, n) for n in ("reduce_s_reference", "reduce_s_rows_reference")]
    real = [getattr(m, n) for m, n in names]

    def refuse(*args):
        raise AssertionError("a plain version of B1/B2/B8/B4/B5 ran on a main path")

    for m, n in names:
        setattr(m, n, refuse)
    try:
        yield
    finally:
        for (m, n), fn in zip(names, real):
            setattr(m, n, fn)


def obs_major_inputs(problem, opts):
    """What an obs-major direct path hands B1 (its tile, as phase 23 takes
    the planar path's) and B4 in one assembly and one damped solve of its
    compiled problem (a recorder in place of B4): ``((floats, ints,
    n_obs), (w, h_inv, g_l, rows))``."""
    from nllstpu_torch.core.optimize import compile_problem
    from nllstpu_torch.ops import schur

    comp = compile_problem(problem, solver=opts.solver, schur_family=opts.schur_family)
    (batch,), (fast,) = comp.batches, comp.schur_info.fast
    variables = problem.stacked_variables()
    _, args = schur.fused_inputs(batch, variables, comp.schur_info, fast,
                                 problem.dtype)
    tile = (list(args[:4]), (args[4], fast.cpos, fast.cstarts, *args[5:]), batch.n)
    kern, seen = comp.kernels.reduce_lm, {}

    def record(w, h_inv, g_l, rows):
        seen["in"] = (w.clone(), h_inv.clone(), g_l.clone(), rows)
        return kern(w, h_inv, g_l, rows)

    comp.kernels = dataclasses.replace(comp.kernels, reduce_lm=record)
    _, sys_ = comp.assemble(variables)
    ctx = comp.ctx(opts)
    ctx.linops.solve(sys_, 1e-2 * ctx.linops.diag_max(sys_).item())
    return tile, seen["in"]


def b7_span_case(device):
    """B7 against its plain version where a float64 row is past a block's
    shared memory (:data:`B7_SPAN`: the row built in column spans), runs
    of ``per`` costs with repeated cameras and dropped costs; float64 within
    ``TOL_B57_F64``, float32 (whose row fits) within ``TOL_B57_F32``, two
    launches the same bits; the float64 times (the span path), the bound,
    the plain version's and ``index_add_`` into a zeroed W.  Returns the
    record."""
    from nllstpu_torch.ops import w_place

    c = B7_SPAN
    gen = torch.Generator().manual_seed(24)
    L, dl, dr_s, n_r = c["L"], c["dl"], c["dr_s"], c["n_r"]
    wc = n_r * dr_s
    lstarts = (torch.arange(L + 1) * c["per"]).int()
    n = L * c["per"]
    colbase = (torch.randint(0, n_r, (n,), generator=gen) * dr_s).int()
    colbase[::11] = -1
    colbase[5::13] = wc - dr_s + 1
    we = torch.randn(n, dl, dr_s, generator=gen, dtype=torch.float64).to(device)
    lst, cb = lstarts.to(device), colbase.to(device)
    kern, plain = w_place.place_w, w_place.place_w_reference
    ref = plain(we, lst, cb, wc)
    out64, again = kern(we, lst, cb, wc), kern(we, lst, cb, wc)
    out32 = kern(we.float(), lst, cb, wc)
    torch.cuda.synchronize()
    e64 = check("B7 f64 span path", [out64], [ref], TOL_B57_F64)[0]
    e32 = check("B7 f32 span case", [out32], [ref], TOL_B57_F32)[0]
    if not torch.equal(out64, again):
        raise AssertionError("B7 span path: two launches differ")
    del out32, again
    keep, idx = w_place.flat_index(lst, cb, dl, dr_s, wc)
    vals = torch.where(keep, we.reshape(-1), 0)
    wz = torch.zeros(out64.numel(), dtype=torch.float64, device=device)
    ms = time_ms(lambda: kern(we, lst, cb, wc))
    device_ms = graph_ms(lambda: kern(we, lst, cb, wc))
    plain_ms = time_ms(lambda: plain(we, lst, cb, wc))
    library_ms = time_ms(lambda: wz.index_add_(0, idx, vals))
    b = bound(nbytes(we, lst, cb, out64), int(keep.sum()), torch.float64)
    print(f"B7 span path (float64 row {dl * wc * 8} bytes; B {n}, W {tuple(out64.shape)}): rel "
          f"err f64 {e64:.2e} f32 {e32:.2e}, deterministic | kernel {ms:.4f} ms (in a CUDA "
          f"graph {device_ms:.4f} ms), plain {plain_ms:.4f} ms, index_add_ into a zeroed W "
          f"{library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})", flush=True)
    return dict(max_abs_err=abs_err(out64, ref), ms=ms, plain_ms=plain_ms, **b,
                graph_ms=device_ms, library_ms=library_ms)


def phase_anydl(device, smi):
    """Phase 24 (see the module docstring): the NRSfM paths at full width
    through the obs-major route (B1, B4), the dual-sorted route (B8, B4)
    and, in the adaptive form, the generic route (B6, B7, B5's tiled
    instance), with no plain version of those kernels; then B1 and B8 on
    the paths' own tiles and on synthetic tiles past the old caps, B2 at
    those shapes over bench-realistic's pattern, B4 on the obs-major paths'
    own reductions and B5 at dl = 33 against their plain versions, and
    B7's span path.  Returns the main paths'
    launch counts and the kernels' records, by kernel and shape (each with
    ``path``)."""
    import nllstpu_torch as nt

    launches, inputs = {}, {}
    obs_major = ("fused_obs_all", "segment_block_sum", "reduce_s_lm")
    needs_of = {NRSFM3_FUSED: ("fused_obs_leg", "reduce_s_lm"),
                NRSFM_ADAPTIVE: ("segment_block_sum", "place_w", "reduce_s")}
    for label in ANYDL:
        ref = ANYDL_REF[label]
        problem, opts, route, kh = anydl_problem(label, device)
        f64 = ANYDL[label][1] == torch.float64
        needs = needs_of.get(label, obs_major)
        slack = 1e-9 if f64 else 1e-2 if label == NRSFM_ADAPTIVE else 1e-3
        with no_plain_kernels():
            launches[label], result = phase_main(
                label, problem, ref["start"], ref["best"], slack, needs=needs,
                never=_never(needs), options=opts, **route)
        if f64:
            trace_gate(label, result, ref)
        elif label == NRSFM_ADAPTIVE:
            sw = nt.ContaminatedGaussian.sigmas_weight(problem.get_value(kh)).double().tolist()
            print(f"{label} main path: (sigma1, sigma2, w) {sw} against the JAX package's "
                  f"{list(ref['sigmas_weight'])} | {smi}", flush=True)
        elif not route:
            inputs[label] = obs_major_inputs(anydl_problem(label, device)[0], opts)
        del problem, result
    print(f"phase 24 main paths | {smi}", flush=True)
    mark("anydl: main paths")
    records = collections.defaultdict(dict)

    def add(name, shape, path, record):
        records[name][shape] = dict(record, path=path)

    # B1 and B8: the obs-major paths' own tiles (2, 6, 9) and (2, 6, 18),
    # then synthetic bench-sized tiles past the old caps; both float types
    # timed.
    gen = torch.Generator().manual_seed(24)
    tiles = {f"{label} (2,6,{3 * ANYDL[label][0]})": (inputs[label][0], label)
             for label in (NRSFM3, NRSFM6)}
    for n, dr_s, dl in LIFTED_SYNTHETIC:
        floats, ints = synthetic_tile(gen, n, dr_s, dl, device)
        tiles[f"synthetic ({n},{dr_s},{dl}) K=14 L={NLMK}"] = (
            (floats, ints, int((ints[0] < ints[3]).sum())), NRSFM3)
    for label, ((floats, ints, n_obs), path) in tiles.items():
        recs = tile_case(label, floats, ints, n_obs, (torch.float32, torch.float64))
        add("fused_obs_all", label, path, recs["fused_obs_all"][torch.float32])
        add("fused_obs_all", f"{label} f64", NRSFM6_F64 if path == NRSFM6 else path,
            recs["fused_obs_all"][torch.float64])
        for dt, suffix in ((torch.float32, ""), (torch.float64, " f64")):
            add("fused_obs_leg", label + suffix, NRSFM3_FUSED, recs["fused_obs_leg"][dt])
    del tiles
    # B2 at NRSfM's shapes and the synthetic ones, random values over
    # bench-realistic's observation pattern (its degree buckets).
    for n, dr_s, dl in ((2, 6, 9), (2, 6, 18), *LIFTED_SYNTHETIC):
        head, tail, fast, L, n_obs = synthetic_batch(gen, n, dr_s, dl, device)
        label = f"synthetic ({n},{dr_s},{dl}) over bench-realistic's pattern"
        record = b2_check(label, head, tail, fast, L, n_obs, "bench-realistic's observations",
                          tol64=TOL_SHAPE_F64, tol32=TOL_SHAPE_F32, f64_timed=True)
        add("fused_obs_all_into", f"{label} f64", STEREO, record.pop("f64"))
        add("fused_obs_all_into", label, STEREO, record)
        del head
    mark("anydl: B1, B2, B8")
    # B4 on the obs-major paths' own reductions (their inverses formed in
    # float64 as the float32 solve forms them); B5 on a synthetic dl = 33
    # structure (the adaptive path's own reduction cancels: its S holds
    # 1e-12 of its largest entry only to about 1e-10 between any two
    # summation orders).
    for label in (NRSFM3, NRSFM6):
        w, h_inv, g_l, rows = inputs.pop(label)[1]
        dl = w.shape[1]
        add("reduce_s_lm", f"{label} dl={dl}", label,
            external_case("reduce_s_lm", f"{label} dl={dl}",
                          (w.double(), h_inv.double(), g_l.double()), rows, device))
        del w, h_inv, g_l, rows
    *synthetic, tables = structured_case(gen, 4096, 33, [9] * 40 + [3, 16, 1], 2)
    add("reduce_s", "synthetic dl=33", NRSFM_ADAPTIVE,
        external_case("reduce_s", "synthetic dl=33", synthetic, tables, device))
    add("place_w", "span path dl=18 wc=1620 f64", NRSFM_ADAPTIVE, b7_span_case(device))
    print(f"phase 24 kernels | {smi}", flush=True)
    mark("anydl: B4, B5, B7")
    return launches, records


def mark(what):
    """Print the seconds since the previous mark: where the run's time
    goes, against its 1,200 s limit."""
    now = time.perf_counter()
    print(f"seconds {what}: {now - _CLOCK[0]:.1f}", flush=True)
    _CLOCK[0] = now


def main():
    device, smi = phase_device()
    phase_build(device)
    mark("device and build")
    sharded_launches, sharded_b2 = phase_sharded(device, smi)
    mark("sharded")
    shapes_launches, shapes = phase_shapes(device, smi)
    mark("shapes")
    anydl_launches, anydl = phase_anydl(device, smi)
    mark("anydl")
    b1, bench_sys, cam1 = phase_b1(device)
    b2, bal_systems, cam2 = phase_b2(device)
    b2.update(sharded_b2)
    b3 = phase_b3(device, {"pinhole bench": bench_sys, **bal_systems})
    del bench_sys, bal_systems
    b6 = phase_b6(device, {**cam1, **cam2})
    del cam1, cam2
    place_in, reduce_in = adaptive_inputs(device)
    b7 = phase_b7(device, place_in)
    b5 = phase_b5(device, reduce_in)
    del place_in, reduce_in
    b8 = phase_b8(device)
    b4 = phase_b4(device, *b4_inputs(device))
    phase_determinism(device)
    mark("kernels against their plain versions, determinism")
    generic = ("place_w", "reduce_s", "fused_obs_leg", "reduce_s_lm")
    launches = {"pinhole bench": phase_main(
        "pinhole bench", bench_problem(device), REF_START_COST, REF_BEST_COST, 1e-3,
        needs=("fused_obs_all", "segment_block_sum", "reduce_s_damped"), never=generic,
    )[0]}
    for name, (_, start_ref, best_ref, slack) in BAL.items():
        launches[name] = phase_main(
            name, bal_problem(name, device), start_ref, best_ref, slack,
            needs=("fused_obs_all_into", "segment_block_sum", "reduce_s_damped"),
            never=("fused_obs_all", *generic),
        )[0]
    for name, (_, _, start_ref, best_ref, slack) in IMPLICIT.items():
        launches[name] = phase_main(
            name, bal_problem(name, device), start_ref, best_ref, slack,
            needs=("segment_block_sum",),
            never=("fused_obs_all", "fused_obs_all_into", "reduce_s_damped", *generic),
            options=implicit_options(name),
        )[0]
        print(f"{name} main path: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | {smi}", flush=True)
    launches[ADAPTIVE] = phase_adaptive_main(device, smi)
    launches[GAUGE] = phase_gauge_main(device, smi)
    problem, route = dual_problem(FUSED, device)
    launches[FUSED] = phase_main(
        FUSED, problem, REF_START_COST, REF_BEST_COST, 1e-3,
        needs=("fused_obs_leg", "reduce_s_damped"),
        never=("fused_obs_all", "fused_obs_all_into", "reduce_s_lm", "place_w", "reduce_s",
               "segment_block_sum"),
        **route,
    )[0]
    mark("main paths of slices 1-5")
    phase_drivers(device, smi)
    mark("drivers")
    iter_launches, iter_results = phase_iter_main(device, smi)
    dense_launches, dense_results, b6_dense_in = phase_dense(device, smi)
    b6.update(phase_b6_dense(device, b6_dense_in))
    del b6_dense_in
    launches[POSEGRAPH] = dense_launches[f"{POSEGRAPH} LM"]
    phase_iter_determinism(device, {**iter_results, **dense_results})
    phase_iter_drivers(device, smi, iter_results)
    phase_posegraph_times(device, smi)
    cg_launches, _, b6_cg_in = phase_cg(device, smi, dense_results)
    b6.update(phase_b6_dense(device, b6_cg_in))
    del b6_cg_in
    launches[f"{POSEGRAPH} cg"] = cg_launches[f"{POSEGRAPH} cg LM"]
    mark("iterators, dense and cg backends")
    generic_launches = phase_generic_main(device, smi)
    launches.update(generic_launches)
    mark("generic Schur main paths")
    adaptive_launches = phase_adaptive_everywhere(device, smi, DIRECT_SIGMAS)
    launches.update(adaptive_launches)
    mark("adaptive kernels on every backend, cluster-Jacobi")
    # The two drivers and the plain versions in turns, then one run of
    # each with per-phase events (the events cost host time, so rates come
    # from the runs without them), then each driver profiled.  A timed loop
    # leaves its problem's values as they were, so one problem serves every
    # run of a path.
    implicit = "bench-realistic implicit"
    for label, make, opts in (
        ("pinhole bench", lambda d: (bench_problem(d), {}), None),
        (FUSED, lambda d: dual_problem(FUSED, d), None),
        (GAUGE, lambda d: dual_problem(GAUGE, d), None),
        ("Ladybug-49", lambda d: (bal_problem("Ladybug-49", d), {}), None),
        (implicit, lambda d: (bal_problem(implicit, d), {}), implicit_options(implicit)),
        (ADAPTIVE, lambda d: (adaptive_problem(d)[0], {}), None),
    ):
        problem, route = make(device)
        for driver, phases in (("graph", False), ("stepped", False), ("plain", False),
                               ("graph", True), ("stepped", True), ("plain", True)):
            phase_timed(label, problem, driver, phases=phases, options=opts, **route)
        for driver in ("graph", "stepped"):
            phase_profile(label, problem, driver, options=opts, **route)
    mark("timed loops of slices 1-5")
    # This slice's paths: the drivers and the plain versions in turns, each
    # driver profiled; the pose graph's stepped driver once with phase
    # events (its assembly, solve and cost per call).
    import nllstpu_torch as nt

    for label, make, opts in (
        ("gauge-fixed f64", lambda d: gauge_problem(torch.float64, d), iter_options(nt.NEWTON)),
        ("gauge-fixed f32", lambda d: gauge_problem(torch.float32, d), iter_options(nt.NEWTON)),
        ("gauge-fixed f64", lambda d: gauge_problem(torch.float64, d), iter_options(nt.DOGLEG)),
        ("pinhole bench", lambda d: (bench_problem(d), {}), iter_options(nt.DOGLEG)),
        (implicit, lambda d: (bal_problem(implicit, d), {}),
         iter_options(nt.DOGLEG, implicit_options(implicit))),
        ("pinhole bench", lambda d: (bench_problem(d), {}), iter_options(nt.GRADIENT_DESCENT)),
        (POSEGRAPH, posegraph_problem, posegraph_options(nt.LEVENBERG_MARQUARDT)),
        (POSEGRAPH, posegraph_problem, posegraph_options(nt.DOGLEG)),
        (f"{POSEGRAPH} cg", posegraph_problem, posegraph_options(nt.LEVENBERG_MARQUARDT, "cg")),
        (f"{POSEGRAPH} cg", posegraph_problem, posegraph_options(nt.DOGLEG, "cg")),
        (PERCOST, percost_problem, generic_options("schur")),
        (PERCOST_CG, percost_problem, generic_options("schur_cg")),
        (RIDERS, riders_problem, None),
    ):
        problem, route = make(device)
        # A second graph run for the generic paths only: the older ones
        # were timed in turns by earlier slices' runs.
        generic = label in (PERCOST, PERCOST_CG, RIDERS)
        turns = [("graph", False), ("stepped", False), ("plain", False)]
        turns += [("graph", False)] * generic
        turns += [("stepped", True)] * (label.startswith(POSEGRAPH) or generic)
        turns += [("graph", True)] * (label == f"{POSEGRAPH} cg")
        for driver, phases in turns:
            phase_timed(label, problem, driver, phases=phases, options=opts, **route)
        for driver in ("graph", "stepped"):
            phase_profile(label, problem, driver, options=opts, **route)
    mark("timed loops of slices 10-12")
    # The Dubrovnik-class loop through both drivers: its rate, its phase
    # split, PCG iterations and matvec time, then its idle share.
    big = "Dubrovnik-class"
    problem = bal_problem(big, device)
    for driver in ("graph", "stepped"):
        for phases in (False, True):
            phase_timed(big, problem, driver, phases=phases, options=implicit_options(big))
        phase_profile(big, problem, driver, options=implicit_options(big))
    mark("Dubrovnik-class timed loop")
    alternation_launches, alternation_b6 = phase_alternation(device, smi)
    b6.update(alternation_b6)
    # One row per kernel and main-path shape: the times are that shape's,
    # the launches those of that shape's main-path run.
    src = "nllstpu_torch/ops/csrc/"
    # Phases 23's and 24's rows name the main path whose launches they give
    # (``path``).
    rows = [("fused_obs_all", "fused_obs.cu", "fused_obs.py:264",
             {"pinhole bench": b1, **shapes["fused_obs_all"], **anydl["fused_obs_all"]}),
            ("fused_obs_all_into", "fused_obs.cu", "fused_obs.py:397",
             {**b2, **shapes["fused_obs_all_into"], **anydl["fused_obs_all_into"]}),
            ("reduce_s_damped", "schur_reduce.cu", "schur_reduce.py:505",
             {**b3, **shapes["reduce_s_damped"]}),
            ("reduce_s_lm", "schur_reduce.cu", "schur_reduce.py:375",
             {**b4, **shapes["reduce_s_lm"], **anydl["reduce_s_lm"]}),
            ("reduce_s", "schur_reduce.cu", "schur_reduce.py:568",
             {**b5, **shapes["reduce_s"], **anydl["reduce_s"]}),
            ("segment_block_sum", "segment_sum.cu", "segment_sum.py:103", b6),
            ("place_w", "w_place.cu", "w_place.py:98", {**b7, **anydl["place_w"]}),
            ("fused_obs_leg", "fused_obs.cu", "fused_obs.py:482",
             {**b8, **shapes["fused_obs_leg"], **anydl["fused_obs_leg"]})]
    # Beside each row, the launches of the later slices' main paths
    # (Newton, dogleg, gradient descent; the dense and cg backends; the
    # generic Schur assembly's) that launched the kernel.
    slice_launches = {**iter_launches, **dense_launches, **cg_launches, **generic_launches,
                      **adaptive_launches, **alternation_launches, **sharded_launches,
                      **shapes_launches, **anydl_launches}
    launches.update(alternation_launches)
    launches.update(sharded_launches)
    launches.update(shapes_launches)
    launches.update(anydl_launches)
    kernels = [
        dict(name=name, shape=shape, route="cuda", source=src + source,
             replaces="nllstpu/ops/pallas/" + replaces,
             launches=launches[record.get("path", shape.split(" D=")[0])][name],
             slice_launches={p: c[name] for p, c in slice_launches.items() if c[name]},
             **{"library_ms": None, **record})
        for name, source, replaces, records in rows
        for shape, record in records.items()
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
