"""Time the direct assembly kernels and solves of ``chip_smoke.py``'s
problems on one CUDA card, for the port found under ``--root``.

    python3 scripts_torch/time_assembly.py [--root PATH] [--reps 50]

``--root`` is a checkout of this repository (default: the one holding
this script), whose ``nllstpu_torch`` is imported, so that two versions
of the port can be compared in one call on one card: unpack the other
commit with ``git archive`` into a directory ``.gitignore`` lists and run
this script for each in turns.  For each problem it prints the mean time
per call, by CUDA events around ``--reps`` calls after two warm-ups and,
for a kernel's wrapper, also the host's time to enqueue one call (a host
clock around the same calls, no synchronisation inside) and the calls
replayed from one CUDA graph (the device's time without the host's launch
rate).  Where the enqueue time passes the graph time, the event time is
the host's:

- B1 with its B6 camera sum on the pinhole bench problem's tiles
  (``fused_obs.fused_obs_all``), B8 on the same tiles
  (``fused_obs.fused_obs_leg``, float32) and on the gauge-fixed float64
  problem's;
- one whole direct assembly (``CompiledProblem.assemble``) of Ladybug-49,
  bench-realistic (B2, then B6) and the pinhole bench (B1);
- one damped solve (``SchurOps.solve``, λ = 1e-2·max diag) of the adaptive
  bench-realistic system (B5 and a Cholesky), and its reduction alone
  (``damped_inverse`` then B5; events, host enqueue, graph);
- the reduction that the solve takes, alone (events, host enqueue, graph),
  and the whole damped solve (events; its Cholesky reads the device, so it
  cannot be captured): B3 on the float32 pinhole bench, Ladybug-49 and
  bench-realistic systems, ``damped_inverse`` then B4 on the gauge-fixed
  float64 system.  The reduction is called as the port under ``--root``
  calls it (with its row tables where ``SchurOps`` has them, and λ as a
  0-d float64 tensor on the card where its kernel B3 reads λ from device
  memory, as its drivers give it).

With ``--cases anydl`` it times instead B4 and B5 past the unrolled dl ≤
6 (events, host enqueue, graph, each pass's mean device time by
torch.profiler, and cuBLAS's dense ``Yᵀ W`` beside them; the inverses laid
out as the solve gives them, landmark-major underneath):
the synthetic W of ``chip_smoke.py``'s phases 23 and 24 at dl 7 and 16
(B4: ``row_case``; B5: ``structured_case``) and dl 33 (B5), and the NRSfM problem's damped
reduction (``scripts_torch/anydl_reference.py``, float32, damped_inverse
then B5 on the generic route, B4 on the obs-major one) at K = 3 and 6 (dl
9 and 18), where the port under ``--root`` compiles it.

With ``--cases shapes`` it times instead every shape of ``chip_smoke.py``'s
phase 23 in both float types (events, host enqueue, graph; each kernel's
mean device time by torch.profiler beside B1, B2, B3 and B4), with the
unrolled instances' hot shapes and B3 at dl 3 beside them, after printing
the registers and spill of the assembly and links kernels from the build
(nvcc's ``-Xptxas -v``):

- B1 with its B6 camera sum and B8 on one tile: the planar problem's (2,
  6, 2), synthetic bench-sized (3, 6, 3) and (3, 9, 3) tiles, and the hot
  (2, 6, 3) (the pinhole bench's) and (2, 9, 3) (synthetic);
- one whole B2 assembly (zeroed buffers, B2, the camera sum): the stereo
  problem's (3, 9, 3) batch, random values at (2, 6, 2), (3, 6, 3) and (3,
  9, 3) over its observation pattern, and the hot (2, 9, 3) of
  bench-realistic;
- the reductions over the planar system's W (dl 2): B3 (float32) and B4
  over inverses formed in float64 (both types), B3 at dl 1 (synthetic),
  and the hot B3 on the pinhole bench (dl 3) and B4 on the gauge-fixed
  float64 system.

With ``--cases lifted`` it times instead trajectory-space NRSfM
(``chip_smoke.py``'s phase 24 problems, built here: K = 3 and 6 in
float32, K = 6 in float64) on the route that the port under ``--root`` compiles for it
(printed: a port with the caps n ≤ 4, dr_s ≤ 16, dl ≤ 6 takes the generic
route, B6/B7/B5; one without them the obs-major route, B1/B4): one whole
assembly and the reduction of one damped solve (events, host enqueue,
graph, each kernel's passes by torch.profiler), then ten LM iterations
through the graph and the stepped drivers (it/s), and through the graph
driver with events around every replay (its assembly and damped trial
per call).

The problems are chip_smoke.py's (its constants), built by the port
under ``--root``.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def events_ms(fn, reps):
    for _ in range(2):
        fn()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def host_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def graph_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    g.replay()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def passes_ms(fn, reps):
    """Each kernel's mean device time per call of ``fn`` (torch.profiler
    over ``reps`` calls), by kernel name: ``"name ms, ..."``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        if us > 0:
            name = re.sub(r"^(void )?(\(anonymous namespace\)::)?", "", e.key)
            out.append(f"{re.split(r'[<(]', name)[0]} {us / reps / 1e3:.4f}")
    return ", ".join(out) or "no device time"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--cases", choices=("all", "anydl", "shapes", "lifted"), default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_assembly: no CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)
    import chip_smoke as cs  # the problems' constants

    from nllstpu_torch.core.optimize import compile_problem
    from nllstpu_torch.ops import fused_obs, schur, schur_reduce

    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(fused_obs.__file__)))
    assert pkg_root == root, fused_obs.__file__
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    tag = f"[{os.path.basename(root) or root}] {smi}"
    reps = args.reps
    if args.cases == "anydl":
        return anydl_cases(cs, dev, tag, reps)
    if args.cases == "shapes":
        return shapes_cases(cs, dev, tag, reps)
    if args.cases == "lifted":
        return lifted_cases(cs, dev, tag, reps)
    fam = cs.bench_options().schur_family

    def tiles(problem, comp):
        """A uniform batch's B8 arguments, its B1 camera-order rows and
        the batch's tables."""
        (batch,), (fast,) = comp.batches, comp.schur_info.fast
        _, a = schur.fused_inputs(batch, problem.stacked_variables(), comp.schur_info,
                                  fast, comp.dtype)
        if isinstance(a, list):  # a port that gave a list of bucket tiles
            return a[0], fast.cpos[0], fast
        return a, fast.cpos, fast

    problem = cs.bench_problem(dev)
    comp = compile_problem(problem, solver="schur", schur_family=fam)
    a, cpos, fast = tiles(problem, comp)
    b1 = lambda: fused_obs.fused_obs_all(*a[:5], cpos, fast.cstarts, *a[5:])  # noqa: E731
    print(f"{tag} B1 + B6 pinhole bench: events {events_ms(b1, reps):.4f} ms, host enqueue "
          f"{host_ms(b1, reps):.4f} ms, graph {graph_ms(b1, reps):.4f} ms", flush=True)
    v = problem.stacked_variables()
    print(f"{tag} assemble pinhole bench (B1): events "
          f"{events_ms(lambda: comp.assemble(v), reps):.4f} ms", flush=True)
    for name in (cs.FUSED, cs.GAUGE):
        problem, route = cs.dual_problem(name, dev)
        comp = compile_problem(problem, route["unfixed"], solver="schur", schur_family=fam,
                               w_impl="fused")
        a, _, _ = tiles(problem, comp)
        b8 = lambda: fused_obs.fused_obs_leg(*a)  # noqa: E731
        print(f"{tag} B8 {name}: events {events_ms(b8, reps):.4f} ms, host enqueue "
              f"{host_ms(b8, reps):.4f} ms, graph {graph_ms(b8, reps):.4f} ms", flush=True)
    for name in cs.BAL:
        problem = cs.bal_problem(name, dev)
        comp = compile_problem(problem, solver="schur", schur_family=fam)
        v = problem.stacked_variables()
        print(f"{tag} assemble {name} (B2): events "
              f"{events_ms(lambda: comp.assemble(v), reps):.4f} ms", flush=True)
    def reduction(ops, sys_, lam):
        """The reduction ``ops.solve`` takes for this system."""
        _, _, h_ll, g_l, w = sys_
        tables = (ops.rows,) if hasattr(ops, "rows") else ()
        if w.dtype == torch.float32:
            return lambda: ops.reduce(w, h_ll, g_l, lam, *tables)
        return lambda: ops.reduce_lm(w, ops.damped_inverse(h_ll, lam), g_l, *tables)

    solves = [("pinhole bench", "B3", lambda: (cs.bench_problem(dev), {}))]
    solves += [(name, "B3", lambda name=name: (cs.bal_problem(name, dev), {})) for name in cs.BAL]
    solves.append((cs.GAUGE, "damped_inverse + B4", lambda: cs.dual_problem(cs.GAUGE, dev)))
    for name, what, make in solves:
        problem, route = make()
        comp = compile_problem(problem, route.get("unfixed"), solver="schur", schur_family=fam,
                               w_impl=route.get("w_impl", "fused_all"))
        _, sys_ = comp.assemble(problem.stacked_variables())
        ops = comp.ctx().linops
        lam = 1e-2 * ops.diag_max(sys_).item()
        if hasattr(schur_reduce, "lam_tensor"):  # B3 reads λ from device memory
            lam = schur_reduce.lam_tensor(lam, dev)
        red = reduction(ops, sys_, lam)
        print(f"{tag} reduction {name} ({what}): events {events_ms(red, reps):.4f} ms, host "
              f"enqueue {host_ms(red, reps):.4f} ms, graph {graph_ms(red, reps):.4f} ms; damped "
              f"solve: events {events_ms(lambda: ops.solve(sys_, lam), reps):.4f} ms", flush=True)
        del comp, sys_, ops, red
    problem, _ = cs.adaptive_problem(dev)
    opts = cs.adaptive_options()
    comp = compile_problem(problem, solver=opts.solver, schur_family=opts.schur_family)
    _, sys_ = comp.assemble(problem.stacked_variables())
    ops = comp.ctx(opts).linops
    lam = 1e-2 * ops.diag_max(sys_).item()
    _, _, h_ll, g_l, w = sys_
    red = lambda: ops.reduce_external(w, ops.damped_inverse(h_ll, lam), g_l, ops.pairs)  # noqa: E731
    print(f"{tag} reduction {cs.ADAPTIVE} (damped_inverse + B5): events "
          f"{events_ms(red, reps):.4f} ms, host enqueue {host_ms(red, reps):.4f} ms, graph "
          f"{graph_ms(red, reps):.4f} ms; damped solve (B5): events "
          f"{events_ms(lambda: ops.solve(sys_, lam), reps):.4f} ms", flush=True)


def anydl_cases(cs, dev, tag, reps):
    """B4 and B5 past the unrolled dl: the synthetic W at dl 7, 16 and 33,
    and the NRSfM reductions at dl 9 and 18 (see the module docstring)."""
    import nllstpu_torch as nt
    from nllstpu_torch.core.optimize import compile_problem
    from nllstpu_torch.models.ba import perturb_ba
    from nllstpu_torch.ops import schur_reduce
    from scripts_torch import anydl_reference as ar

    def report(label, kern, w, h_inv, g_l, tables):
        f = lambda: kern(w, h_inv, g_l, tables)  # noqa: E731
        pb, pf = cs.struct_work(tables, w.shape[1], w.element_size())
        b = cs.bound(pb + cs.nbytes(*f()), pf)
        print(f"{tag} {label} (W {tuple(w.shape)}, {tables.links.shape[0]} links): events "
              f"{events_ms(f, reps):.4f} ms, host enqueue {host_ms(f, reps):.4f} ms, graph "
              f"{graph_ms(f, reps):.4f} ms; cuBLAS Y^T W "
              f"{events_ms(cs.gemm_call(w, h_inv), reps):.4f} ms; structural bound {b['bound_ms']:.4f} ms ({b['bound_by']}); passes "
              f"{passes_ms(f, reps)}", flush=True)

    def as_solved(h):
        """``h`` [dl, dl, L] laid out as the solve's inverses are (a view
        of landmark-major memory)."""
        return h.permute(2, 0, 1).contiguous().permute(1, 2, 0)

    def attempt(*args):
        try:
            report(*args)
        except ValueError as err:  # a port that refuses the shape
            print(f"{tag} {args[0]}: refused ({err})", flush=True)

    gen = torch.Generator().manual_seed(23)
    for dl, shape in ((7, (cs.NLMK, cs.NCAM, 6)), (16, (4096, 80, 9)), (33, None)):
        if shape is not None:
            L, n_blocks, width = shape
            w, h_inv, g_l, rows = cs.row_case(gen, L, dl, n_blocks, width, dev, inverse=True)
            attempt(f"B4 synthetic dl={dl}", schur_reduce.reduce_s_lm, w.float(),
                    as_solved(h_inv.float()), g_l.float(), rows)
        w, h_inv, g_l, tables = cs.structured_case(gen, 4096, dl, [9] * 40 + [3, 16, 1], 2)
        w, h_inv, g_l = (t.to(dev, torch.float32) for t in (w, h_inv, g_l))
        attempt(f"B5 synthetic dl={dl}", schur_reduce.reduce_s, w, as_solved(h_inv), g_l,
                schur_reduce.upload_tables(tables, dev))
        del w, h_inv, g_l
    for K in ar.KS:
        problem, _, pts = ar.build(nt, ar.full_data(K), torch.float32, dev)
        perturb_ba(problem, pts, 0.05, seed=5)
        try:
            comp = compile_problem(problem, solver="schur", schur_family=nt.Euclidean(3 * K))
        except ValueError as err:
            print(f"{tag} NRSfM K={K}: the port refuses the direct solve ({err})", flush=True)
            continue
        _, sys_ = comp.assemble(problem.stacked_variables())
        ops = comp.ctx().linops
        _, _, h_ll, g_l, w = sys_
        h_inv = ops.damped_inverse(h_ll, 1e-2 * ops.diag_max(sys_).item())
        if getattr(ops, "pairs", None) is not None:  # the generic route
            report(f"B5 NRSfM K={K} dl={3 * K}", schur_reduce.reduce_s, w, h_inv, g_l, ops.pairs)
        else:  # the obs-major route
            report(f"B4 NRSfM K={K} dl={3 * K}", schur_reduce.reduce_s_lm, w, h_inv, g_l,
                   ops.rows)
        del comp, sys_, ops, w, h_inv


def build_resources(tag):
    """Build (or load) the library of the port under ``--root`` and print
    each assembly and links kernel's registers and spill, once."""
    from nllstpu_torch.ops import _build

    _build.library()
    print(f"{tag} build {_build.BUILD_SECONDS:.2f} s", flush=True)
    if hasattr(_build, "resources"):
        for name, regs, st, ld in _build.resources():
            if "assemble" in name or "reduce_links_kernel" in name:
                print(f"{tag} {regs} registers, spill {st} / {ld} bytes: {name}", flush=True)
    else:  # a port that keeps no parsed report: nvcc's own lines
        lines = _build.BUILD_LOG.splitlines()
        for i, line in enumerate(lines):
            if "assemble" in line and "Function properties" in line:
                print(f"{tag} {' '.join(x.strip() for x in lines[i:i + 3])}", flush=True)


def shapes_cases(cs, dev, tag, reps):
    """Phase 23's shapes in both float types, the hot instances beside
    them (see the module docstring)."""
    import nllstpu_torch as nt
    from nllstpu_torch.core.optimize import compile_problem
    from nllstpu_torch.ops import fused_obs, schur, schur_reduce, segment_sum

    build_resources(tag)

    def timed(label, fn, profile=False):
        line = (f"{tag} {label}: events {events_ms(fn, reps):.4f} ms, host enqueue "
                f"{host_ms(fn, reps):.4f} ms, graph {graph_ms(fn, reps):.4f} ms")
        if profile:
            line += f"; passes {passes_ms(fn, reps)}"
        print(line, flush=True)

    def tile_of(problem, fam):
        comp = compile_problem(problem, solver="schur", schur_family=fam)
        (batch,), (fast,) = comp.batches, comp.schur_info.fast
        _, a = schur.fused_inputs(batch, problem.stacked_variables(), comp.schur_info, fast,
                                  torch.float32)
        return list(a[:4]), (a[4], fast.cpos, fast.cstarts, *a[5:])

    gen = torch.Generator().manual_seed(23)
    tiles = {"planar (2,6,2)": tile_of(cs.shapes_problem("planar", torch.float32, dev),
                                       nt.Euclidean(2))}
    for shape in ((3, 6, 3), (3, 9, 3), (2, 9, 3)):
        tiles[f"synthetic {shape} K=14".replace(", ", ",")] = cs.synthetic_tile(gen, *shape, dev)
    tiles["pinhole bench (2,6,3)"] = tile_of(cs.bench_problem(dev), nt.Euclidean(3))
    for label, (floats, ints) in tiles.items():
        vc, cpos, cstarts, n_r, dr_s, dl, e_start = ints
        for dt in (torch.float32, torch.float64):
            x = [t.to(dt) for t in floats]
            b1 = lambda: fused_obs.fused_obs_all(*x, vc, cpos, cstarts, n_r, dr_s, dl, e_start)  # noqa: E731
            b8 = lambda: fused_obs.fused_obs_leg(*x, vc, n_r, dr_s, dl, e_start)  # noqa: E731
            timed(f"B1 + B6 {label} {dt}", b1, profile=True)
            timed(f"B8 {label} {dt}", b8)
        del x
    del tiles
    kern = (fused_obs.fused_obs_all_into, segment_sum.segment_block_sum)
    stereo = cs.shapes_problem("stereo", torch.float32, dev)
    comp = compile_problem(stereo, solver="schur", schur_family=nt.Euclidean(3))
    (batch,), (fast,) = comp.batches, comp.schur_info.fast
    _, head, tail = schur.batch_inputs(batch, stereo.stacked_variables(), comp.schur_info, fast,
                                       torch.float32)
    batches = {"stereo (3,9,3)": (head, tail, fast, comp.schur_info.num_elim)}
    for shape in ((2, 6, 2), (3, 6, 3), (3, 9, 3)):
        head_s, tail_s, fast_s, L, _ = cs.synthetic_batch(gen, *shape, dev)
        batches[f"synthetic {shape} over bench-realistic's pattern".replace(", ", ",")] = (
            head_s, tail_s, fast_s, L)
    problem = cs.bal_problem("bench-realistic", dev)
    comp = compile_problem(problem, solver="schur", schur_family=nt.Euclidean(3))
    (batch,), (fast,) = comp.batches, comp.schur_info.fast
    _, head, tail = schur.batch_inputs(batch, problem.stacked_variables(), comp.schur_info, fast,
                                       torch.float32)
    batches["bench-realistic (2,9,3)"] = (head, tail, fast, comp.schur_info.num_elim)
    for label, (head, tail, fast, L) in batches.items():
        for dt in (torch.float32, torch.float64):
            timed(f"B2 + B6 assembly {label} {dt}",
                  lambda: cs._assemble_batch(kern, fast, head, tail, dt, L), profile=True)
    del batches, head, stereo, problem, comp

    def system(problem, fam, **route):
        comp = compile_problem(problem, route.get("unfixed"), solver="schur",
                               schur_family=fam, w_impl=route.get("w_impl", "fused_all"))
        _, sys_ = comp.assemble(problem.stacked_variables())
        ops = comp.ctx().linops
        lam = 1e-2 * ops.diag_max(sys_).item()
        _, _, h_ll, g_l, w = sys_
        return w, h_ll, g_l, lam, comp.schur_info.w_rows

    def reductions(label, w, h_ll, g_l, lam, rows, b3=True, types=(torch.float32, torch.float64)):
        if b3:
            lam_dev = schur_reduce.lam_tensor(lam, dev)
            x = [t.float() for t in (w, h_ll, g_l)]
            timed(f"B3 {label} (W {tuple(w.shape)})",
                  lambda: schur_reduce.reduce_s_damped(*x, lam_dev, rows), profile=True)
        h_inv = schur.SchurOps.damped_inverse(h_ll.double(), lam)
        for dt in types:
            x = [t.to(dt) for t in (w, h_inv, g_l)]
            timed(f"B4 {label} (W {tuple(w.shape)}) {dt}",
                  lambda: schur_reduce.reduce_s_lm(*x, rows), profile=True)

    reductions("planar dl=2", *system(cs.shapes_problem("planar", torch.float64, dev),
                                      nt.Euclidean(2)))
    w, h_ll, g_l, rows = cs.row_case(gen, cs.NLMK, 1, cs.NCAM, 6, dev, inverse=False)
    reductions("synthetic dl=1", w, h_ll, g_l, 1e-2, rows, types=())
    reductions("pinhole bench dl=3", *system(cs.bench_problem(dev), nt.Euclidean(3)), types=())
    problem, route = cs.dual_problem(cs.GAUGE, dev)
    reductions("gauge-fixed dl=3", *system(problem, nt.Euclidean(3), **route), b3=False,
               types=(torch.float64,))


def lifted_cases(cs, dev, tag, reps):
    """NRSfM on the route the port compiles for it (see the module
    docstring)."""
    import dataclasses

    import nllstpu_torch as nt
    from nllstpu_torch.core.optimize import compile_problem
    from nllstpu_torch.models.ba import perturb_ba
    from scripts_torch import anydl_reference as ar

    build_resources(tag)
    # The drivers' linear-algebra library, under which the damped inverses
    # past dl 3 (``inv_ex``) can be captured.
    torch.backends.cuda.preferred_linalg_library("cusolver")
    for K, dtype in ((3, torch.float32), (6, torch.float32), (6, torch.float64)):
        label = f"NRSfM K={K}{' f64' if dtype == torch.float64 else ''}"
        problem, _, pts = ar.build(nt, ar.full_data(K), dtype, dev)
        perturb_ba(problem, pts, 0.05, seed=5)
        fam = nt.Euclidean(3 * K)
        opts = (nt.Options(solver="schur", schur_family=fam, rel_dcost=1e-6,
                           max_time=float("inf")) if dtype == torch.float64
                else dataclasses.replace(cs.bench_options(), schur_family=fam))
        comp = compile_problem(problem, solver=opts.solver, schur_family=opts.schur_family)
        info = comp.schur_info
        route = (f"generic ({info.generic_why})" if info.w_rows is None
                 else f"obs-major ({type(info.fast[0]).__name__})")
        print(f"{tag} {label}: route {route}", flush=True)
        v = problem.stacked_variables()
        asm = lambda: comp.assemble(v)  # noqa: E731
        print(f"{tag} {label} assembly: events {events_ms(asm, reps):.4f} ms, host enqueue "
              f"{host_ms(asm, reps):.4f} ms, graph {graph_ms(asm, reps):.4f} ms; passes "
              f"{passes_ms(asm, reps)}", flush=True)
        _, sys_ = comp.assemble(v)
        ops = comp.ctx(opts).linops
        lam = 1e-2 * ops.diag_max(sys_).item()
        _, _, h_ll, g_l, w = sys_
        if info.w_rows is None:
            red = lambda: ops.reduce_external(w, ops.damped_inverse(h_ll, lam), g_l, ops.pairs)  # noqa: E731
        else:
            red = lambda: ops.reduce_lm(w, ops.damped_inverse(h_ll, lam), g_l, ops.rows)  # noqa: E731
        print(f"{tag} {label} reduction (damped_inverse + B{'5' if info.w_rows is None else '4'}):"
              f" events {events_ms(red, reps):.4f} ms, host enqueue {host_ms(red, reps):.4f} ms, "
              f"graph {graph_ms(red, reps):.4f} ms; damped solve: events "
              f"{events_ms(lambda: ops.solve(sys_, lam), reps):.4f} ms", flush=True)
        del comp, sys_, ops, red, asm, w, h_ll, g_l
        for driver, phases in (("graph", False), ("stepped", False), ("graph", True)):
            print(tag, end=" ", flush=True)
            cs.phase_timed(label, problem, driver, phases=phases, options=opts)
        del problem


if __name__ == "__main__":
    main()
