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

The problems are chip_smoke.py's (its constants), built by the port
under ``--root``.
"""

from __future__ import annotations

import argparse
import os
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=50)
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


if __name__ == "__main__":
    main()
