"""Worker of tests/test_torch_parallel.py: one rank of a two-process
``gloo`` job of the PyTorch port on the CPU, in float64.  Run as

    python tests/_torch_parallel_worker.py <file-store path> <world size> <rank>

Every rank builds the same problems from the same seeds, runs every case
of the sharded port (``nllstpu_torch.parallel``) and prints one JSON line
with what the test asserts on: the replicated results (bit for bit the
same on every rank), the rank-local shapes, and the errors against the
unsharded port computed here.  Imports neither ``jax`` nor ``nllstpu``.
"""

import dataclasses
import datetime
import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

LMK_DOF = 3


def digest(*tensors) -> str:
    """The bits of ``tensors``, hashed."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def pinhole(batched=False, noise=0.0, handles=False):
    """The JAX package's sharded tests' pinhole problem: 6 cameras, 41
    landmarks (not a multiple of 8), visibility 0.6, landmarks perturbed
    by 0.01 (seed 3); with ``handles``, its camera and landmark handles
    too."""
    from nllstpu_torch.models.ba import make_pinhole_ba, perturb_ba

    p, cams, lmks = make_pinhole_ba(6, 41, 0.6, noise=noise, dtype=torch.float64,
                                    batched=batched, device="cpu")
    perturb_ba(p, lmks, 0.01, seed=3)
    return (p, cams, lmks) if handles else p


def realistic():
    """A skewed-degree BAL problem (the bucketed layout): 10 cameras, 180
    points, as the JAX package's sharded tests make it."""
    from nllstpu_torch.models import bal
    from nllstpu_torch.models.ba import perturb_ba

    data = bal.make_realistic_bal(ncameras=10, npoints=180, seed=3, noise=1e-3,
                                  track_alpha=2.0)
    p, _, pts = bal.make_bal_problem(data, dtype=torch.float64, device="cpu")
    perturb_ba(p, pts, 0.02, seed=5)
    return p


def run(problem, mesh, opts, unfixed=None):
    """``optimize_sharded`` and what the test reads of it."""
    from nllstpu_torch.parallel import optimize_sharded

    res = optimize_sharded(problem, mesh, opts, unfixed=unfixed)
    return dict(
        iterations=res.num_iterations, start=res.start_cost, best=res.best_cost,
        costs=res.costs, solves=res.linear_solves,
        variables={k: v.reshape(-1).tolist() for k, v in problem.stacked_variables().items()},
        times=[res.time_cost, res.time_gradient, res.time_solver],
    )


def assembly_case(compiled, par, variables):
    """The summed system of ``parallelize`` against the unsharded port's."""
    c1, sys1 = compiled.assemble(variables)
    c2, sys2 = par.assemble(variables)
    err = max([abs(float(c1) - float(c2))]
              + [float((a - b).abs().max()) for a, b in zip(sys1, sys2)])
    return dict(err=err, cost=float(c2), bits=digest(c2, *sys2),
                local_rows=[int(b.mask.shape[0]) for b in par.local.batches])


def rel(a, b) -> float:
    """max |a − b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max())


def data_parallel_run(make, mesh, opts, **compile_args):
    """``parallelize(...).run`` (the stepped driver over the summed system)
    against ``optimize``'s stepped run of the unsharded port, from the same
    start: the two-rank trace, its largest relative departure per
    iteration, and the bits of what is replicated."""
    import nllstpu_torch as nt
    from nllstpu_torch.parallel import parallelize

    p = make()
    par = parallelize(nt.compile_problem(p, **compile_args), mesh)
    final = par.run(p.stacked_variables(), opts)
    one = nt.optimize(make(), opts)
    costs = [float(c) for c in final["trace"]]
    return dict(
        iterations=final["iternum"], start=float(final["startcost"]),
        best=float(final["bestcost"]), costs=costs, one_iterations=one.num_iterations,
        one_err=max(abs(a - b) / abs(b) for a, b in zip(costs, one.costs)),
        bits=digest(*final["variables"].values()),
    )


def implicit_pieces(mesh, opts):
    """The implicit solve's PCG pieces on the noisy pinhole problem, this
    rank's shard against the unsharded port's, at the LM's first λ (1e-6·max
    diag): the
    Schur-Jacobi inverses (each block's W correction summed over the
    ranks), the right-hand side, the preconditioned residual and one
    reduced matvec S v; then the PCG iterations per damped solve of a
    two-rank run, a one-rank run of the sharded code and the unsharded
    stepped run."""
    import nllstpu_torch as nt
    from nllstpu_torch.core.optimize import run_stepped
    from nllstpu_torch.parallel import schur_shard
    from nllstpu_torch.parallel.mesh import Mesh

    p = pinhole(noise=1e-3)
    comp = nt.compile_problem(p, solver="schur_cg", schur_family=opts.schur_family)
    par = schur_shard.compile_sharded(p, mesh, opts)
    v = p.stacked_variables()
    _, sys1 = comp.assemble(v)
    _, sys2 = par._assemble(v)
    ops1, ops2 = comp.ctx(opts).linops, par.ops(opts)
    lam = 1e-6 * float(ops1.diag_max(sys1))  # the LM's first λ (core.rules.lm_start)
    h1, inv1, _, st1 = ops1.pcg_setup(sys1, lam)
    h2, inv2, _, st2 = ops2.pcg_setup(sys2, lam)
    vec = torch.randn(comp.schur_info.dim_reduced, generator=torch.Generator().manual_seed(7),
                      dtype=torch.float64)
    corrected = [s is not None for s in comp.schur_info.cg.corr]
    solve_iters = {}
    for tol in (1e-6, 1e-9, None):
        o = dataclasses.replace(opts, linear_tol=tol)
        for name, c, sys_ in (("one", comp.ctx(o).linops, sys1), ("two", par.ops(o), sys2)):
            c.solve(sys_, lam)
            solve_iters[f"{name} {tol}"] = c.cg_iters[-1]
    runs = {
        "two ranks": par.run(v, opts),
        "one rank": schur_shard.compile_sharded(pinhole(noise=1e-3), Mesh(None, 0, 1, "cpu"),
                                                opts).run(v, opts),
        "unsharded": run_stepped(comp, opts, v),
    }
    return dict(
        corrected=corrected,
        inv_err=max(rel(b, a) for a, b in zip(inv1, inv2)),
        rhs_err=rel(st2[1], st1[1]), z_err=rel(st2[2], st1[2]),
        matvec_err=rel(ops2.s_matvec(sys2, h2, lam, vec), ops1.s_matvec(sys1, h1, lam, vec)),
        cg_iters={k: list(f["cg_iters"]) for k, f in runs.items()}, solve_iters=solve_iters,
    )


def main():
    store, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)

    import nllstpu_torch as nt
    from nllstpu_torch.parallel import distributed, make_mesh, parallelize, parallelize_schur

    distributed.initialize("gloo", f"file://{store}", world_size=world, rank=rank,
                           timeout=datetime.timedelta(seconds=60))
    mesh = make_mesh(world, device="cpu")
    lmk = nt.Euclidean(LMK_DOF)
    out = {"rank": mesh.rank, "size": mesh.size}

    # 1. The collective alone: the sum of the ranks' (rank + 1).
    out["psum"] = float(mesh.all_reduce(torch.tensor(float(rank + 1), dtype=torch.float64)))

    # 2. Data-parallel sums: the dense system and the direct Schur system
    # (obs-major rows, where a rank's block qualifies) against the
    # unsharded port.
    p = pinhole()
    dense = nt.compile_problem(p, solver="dense")
    out["dense"] = assembly_case(dense, parallelize(dense, mesh), p.stacked_variables())
    for form in (False, "cm"):
        p = pinhole(batched=form)
        direct = nt.compile_problem(p, solver="schur", schur_family=lmk)
        key = "schur_sum" if form == "cm" else "schur_sum_per_cost"
        out[key] = assembly_case(direct, parallelize(direct, mesh), p.stacked_variables())
    # ... and the optimization over them (``ParallelCompiled.run``) on the
    # noisy problem, against the unsharded stepped run.
    noisy = dict(max_iters=30, rel_dcost=1e-6, store_trajectory=True, max_time=float("inf"))
    out["run_dense"] = data_parallel_run(lambda: pinhole(noise=1e-3), mesh,
                                         nt.Options(solver="dense", **noisy), solver="dense")
    for form in (False, "cm"):
        out[f"run_schur_{form}"] = data_parallel_run(
            lambda: pinhole(batched=form, noise=1e-3), mesh,
            nt.Options(solver="schur", schur_family=lmk, **noisy),
            solver="schur", schur_family=lmk)

    # 3. Landmark-sharded direct system: each rank's blocks are the
    # unsharded system's for its own landmarks, bit for bit.
    for form in (False, "cm"):
        p = pinhole(batched=form)
        comp = nt.compile_problem(p, solver="schur", schur_family=lmk)
        par = parallelize_schur(comp, mesh)
        v = p.stacked_variables()
        c1, (a1, b1, h1, g1, w1) = comp.assemble(v)
        c2, (a2, b2, h2, g2, w2) = par.assemble(v)
        gids = torch.as_tensor(par.plan.gids(rank))
        own = gids < par.num_elim
        x1 = comp.ctx().linops.solve((a1, b1, h1, g1, w1), 0.1)
        x2 = par.ops().solve((a2, b2, h2, g2, w2), 0.1)
        out[f"sharded_system_{form}"] = dict(
            lc=par.num_elim_local, L=par.num_elim, h_shape=list(h2.shape),
            w_shape=list(w2.shape), g_shape=list(g2.shape),
            cost_err=abs(float(c1) - float(c2)),
            a_err=float((a1 - a2).abs().max()), b_err=float((b1 - b2).abs().max()),
            h_equal=bool(torch.equal(h2[:, :, own], h1[:, :, gids[own]])),
            g_equal=bool(torch.equal(g2[:, own], g1[:, gids[own]])),
            w_equal=bool(torch.equal(w2[own], w1[gids[own]])),
            pads_zero=not (h2[:, :, ~own].any() or g2[:, ~own].any() or w2[~own].any()),
            x_err=float((x1 - x2).abs().max()), bits=digest(c2, a2, b2, x2),
        )

    # 4. optimize_sharded: LM on the pinhole problem in both batch forms,
    # dogleg, the implicit solve, the bucketed realistic problem, and the
    # trace of the noisy pinhole problem (against the JAX package's sharded
    # run), each replicated result bitwise the same on every rank.
    lm = nt.Options(solver="schur", schur_family=lmk, max_iters=30)
    out["lm"] = run(pinhole(), mesh, lm)
    out["lm_cm"] = run(pinhole(batched="cm"), mesh, lm)
    out["dogleg"] = run(pinhole(), mesh, nt.Options(solver="schur", schur_family=lmk,
                                                     iterator=nt.DOGLEG, max_iters=40))
    out["trace"] = run(pinhole(noise=1e-3), mesh, nt.Options(
        solver="schur", schur_family=lmk, max_iters=30, rel_dcost=1e-6,
        store_trajectory=True, max_time=float("inf")))
    out["implicit"] = run(pinhole(noise=1e-3), mesh, nt.Options(
        solver="schur_cg", schur_family=lmk, max_iters=30, rel_dcost=1e-6,
        max_time=float("inf")))
    out["implicit_pieces"] = implicit_pieces(mesh, nt.Options(
        solver="schur_cg", schur_family=lmk, max_iters=30, rel_dcost=1e-6,
        max_time=float("inf")))
    # Fixed variables: two cameras (their costs' camera column the
    # dustbin) and five landmarks (their costs on no landmark, spread over
    # the ranks by the balanced fill).
    p, cams, lmks = pinhole(batched="cm", noise=1e-3, handles=True)
    out["fixed"] = run(p, mesh, nt.Options(
        solver="schur", schur_family=lmk, max_iters=30, rel_dcost=1e-6, store_trajectory=True,
        max_time=float("inf")), unfixed=cams[2:] + lmks[5:])
    from nllstpu_torch.models import bal

    p = realistic()
    comp = nt.compile_problem(p, solver="schur", schur_family=bal.PT)
    par = parallelize_schur(comp, mesh)
    _, (_, _, h2, _, w2) = par.assemble(p.stacked_variables())
    out["realistic_plan"] = dict(
        strided=par.gid_table is not None, lc=par.num_elim_local, L=par.num_elim,
        buckets=[list(map(int, b)) for b in par.plan.buckets[par.plan.route]],
        h_shape=list(h2.shape), w_shape=list(w2.shape),
    )
    out["realistic"] = run(realistic(), mesh, nt.Options(
        solver="schur", schur_family=bal.PT, max_iters=15, max_time=float("inf")))
    print(json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
