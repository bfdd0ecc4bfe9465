"""Three cases of ROADMAP Queue 3, measured in both packages on the CPU:

    JAX_PLATFORMS=cpu python scripts_torch/queue3_faults.py [pcg_leg] [first_leg] [reduced_f32]

``pcg_leg`` (open item 2, the float32 free-gauge implicit dogleg ending
higher in the port, and the "Not reproduced" non-finite PCG leg): the
float32 implicit dogleg on ``make_realistic_bal(12, 300, seed=s,
noise=1e-3, track_alpha=1.6)``, every variable free, ``solver="schur_cg"``,
s = 1…5, from the points as made and from ``perturb_ba(points, 0.05,
seed=5)``; per run and package the iterations, the termination bits,
whether any cost or step went non-finite, the best cost and (port) the PCG
iterations of every solve.

``first_leg`` ("Shared with the reference": PCG at λ = 0 on a free gauge
in float32 runs to the cap): both packages' reduced PCG at λ = 0 on the
first dogleg leg of the same runs (the start state, the same in both),
step by step: the iterations to the float32 tolerance 1e-5 (cap 500) and
|r|/|rhs| along the way.

``reduced_f32`` ("Shared with the reference": the float32 reduced direct
system singular to float32): the system of
``tests/test_torch_bal.py::test_float32_reduced_solve_is_equilibrated``
(chunk-bucket BAL, three float64 LM iterations, then float32, λ = 1e-10 ·
max diag): the JAX package's float32 step through its own reduction and
solve (``SchurOps._solve``), the port's, an exact solve of the same
float32 system (float64 LU of its entries) and the float64 step; for
each step its distance from the exact float32 solve, its model cost
change against the float64 step's, and its largest entry's distance.
(``scripts_torch/reduced_f32_step.py`` measures the test's own state and
λ, without the JAX package where it is absent.)"""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import nllstpu as nt  # noqa: E402
import nllstpu_torch as pt  # noqa: E402
from nllstpu_torch.core import structs  # noqa: E402

SEEDS = (1, 2, 3, 4, 5)
NONFINITE = (structs.TERM_COST_INF | structs.TERM_COST_NAN
             | structs.TERM_STEP_INF | structs.TERM_STEP_NAN)


def _pair(seed, perturb):
    from nllstpu.models import bal as jbal
    from nllstpu.models.ba import perturb_ba as jperturb
    from nllstpu_torch.models import bal as tbal
    from nllstpu_torch.models.ba import perturb_ba

    data = tbal.make_realistic_bal(12, 300, seed=seed, noise=1e-3, track_alpha=1.6)
    tp, _, tpts = tbal.make_bal_problem(data, dtype=torch.float32, device="cpu")
    jp, _, jpts = jbal.make_bal_problem(data, dtype=jnp.float32)
    if perturb:
        perturb_ba(tp, tpts, perturb, seed=5)
        jperturb(jp, jpts, perturb, seed=5)
    return jp, tp


def _opts(pkg, **kw):
    return pkg.Options(iterator=pkg.DOGLEG, solver="schur_cg", schur_family=pkg.Euclidean(3),
                       max_time=float("inf"), **kw)


def _port_run(tp, opts):
    """The port's graph driver; its final state keeps the PCG iterations of
    every solve."""
    from nllstpu_torch.core.optimize import compile_problem, run_graphs

    comp = compile_problem(tp, solver="schur_cg", schur_family=pt.Euclidean(3))
    return run_graphs(comp, opts, tp.stacked_variables())


def pcg_leg():
    for perturb in (0.0, 0.05):
        for seed in SEEDS:
            jp, tp = _pair(seed, perturb)
            r_j = nt.optimize(jp, _opts(nt, store_trajectory="jit"))
            final = _port_run(tp, _opts(pt))
            c_t = np.asarray(final["trace"], dtype=np.float64)
            c_j = np.asarray(r_j.trajectory.costs, dtype=np.float64)
            bad_t = bool(final["converged"] & NONFINITE) or not np.isfinite(c_t).all()
            bad_j = bool(r_j.termination & NONFINITE) or not np.isfinite(c_j).all()
            print(f"seed {seed} perturb {perturb}: jax {r_j.num_iterations} it, bits "
                  f"{r_j.termination}, non-finite {bad_j}, best {r_j.best_cost!r} | port "
                  f"{final['iternum']} it, bits {final['converged']}, non-finite {bad_t}, best "
                  f"{float(final['bestcost'])!r}, PCG per solve {final['cg_iters']}",
                  flush=True)


def _jax_pcg_history(ops, sys_, lam):
    """The JAX package's reduced PCG (``SchurCGOps.solve``, its
    Schur-Jacobi branch) run step by step, with |r|/|rhs| after every
    iteration."""
    from nllstpu.core.linearsolver import batched_inv_spd_cm

    a_rr, b_r, h_ll, g_l, wparts = sys_
    dtype = b_r.dtype
    dl = ops.dof_elim
    h_inv = batched_inv_spd_cm(h_ll + lam * jnp.eye(dl, dtype=dtype)[:, :, None]
                               + ops._h_damp_extra(dtype))

    def s_matvec(v):
        u = jnp.einsum("del,el->dl", h_inv, ops._wt_apply(wparts, v))
        return a_rr @ v + lam * v - ops._reduce(ops._w_apply(wparts, u))

    rhs = b_r - ops._reduce(ops._w_apply(wparts, jnp.einsum("del,el->dl", h_inv, g_l)))
    inv_blocks = ops.precond_inverses(sys_, lam, h_inv)

    def precond(r):
        rp = jnp.concatenate([r, jnp.zeros(ops.pad + 1, dtype=dtype)])
        z = jnp.zeros(ops.dim_reduced + ops.pad + 1, dtype=dtype)
        for (_, offs, dof), inv in zip(ops.fam_offsets, inv_blocks):
            idx = jnp.minimum(jnp.asarray(offs)[:, None] + jnp.arange(dof)[None, :],
                              ops.dim_reduced + ops.pad)
            z = z.at[idx].add(jnp.einsum("nst,nt->ns", inv, rp[idx]))
        return z[: ops.dim_reduced]

    matvec, precond = jax.jit(s_matvec), jax.jit(precond)
    r = rhs
    z = precond(r)
    p, rz = z, r @ z
    tol2 = jnp.asarray(ops._tol(dtype), dtype) ** 2 * (rhs @ rhs)
    hist, norm0 = [], float(jnp.linalg.norm(rhs))
    while float(r @ r) > float(tol2) and len(hist) < ops.max_iters:
        ap = matvec(p)
        denom = p @ ap
        alpha = rz / jnp.where(denom == 0, jnp.ones_like(denom), denom)
        r = r - alpha * ap
        z2 = precond(r)
        rz2 = r @ z2
        p = z2 + rz2 / jnp.where(rz == 0, jnp.ones_like(rz), rz) * p
        rz = rz2
        hist.append(float(jnp.linalg.norm(r)) / norm0)
    return hist


def _port_pcg_history(ops, sys_):
    """The port's reduced PCG at λ = 0 (``pcg_setup``, then one-iteration
    chunks), with |r|/|rhs| after every iteration."""
    from nllstpu_torch.core import linearsolver

    linearsolver.CG_CHECK_EVERY = 1
    h_inv, inv, tol2, state = ops.pcg_setup(sys_, torch.zeros((), dtype=torch.float64))
    norm0 = float(state[1].norm())
    hist = []
    while True:
        state, flag = ops.pcg_chunk(sys_, 0.0, h_inv, inv, tol2, state)
        more, k = flag.tolist()
        if int(k) > len(hist):
            hist.append(float(state[1].norm()) / norm0)
        if not more:
            return hist


def first_leg():
    """Both packages' reduced PCG at λ = 0 on the first dogleg leg (the
    start state, the same in both), per seed and start."""
    from nllstpu.core.optimize import compile_problem as jcompile
    from nllstpu_torch.core.optimize import compile_problem

    marks = (1, 10, 25, 50, 100, 250, 500)
    for perturb in (0.0, 0.05):
        for seed in SEEDS:
            jp, tp = _pair(seed, perturb)
            jc = jcompile(jp, solver="schur_cg", schur_family=nt.Euclidean(3))
            _, sys_j = jax.jit(jc.assemble)(jp.stacked_variables())
            h_j = _jax_pcg_history(jc.ctx(nt.Options()).ops(), sys_j, jnp.float32(0))
            tc = compile_problem(tp, solver="schur_cg", schur_family=pt.Euclidean(3))
            _, sys_t = tc.assemble(tp.stacked_variables())
            h_t = _port_pcg_history(tc.ctx(pt.Options()).linops, sys_t)

            def at(h):
                return " ".join(f"{h[m - 1]:.2e}" if m <= len(h) else "-" for m in marks)

            print(f"seed {seed} perturb {perturb}: jax {len(h_j)} iterations, |r|/|rhs| at "
                  f"{marks}: {at(h_j)} | port {len(h_t)} iterations: {at(h_t)}", flush=True)


def reduced_f32():
    """Item 2 (see the module docstring)."""
    import test_torch_bal as tb
    from nllstpu.core.optimize import compile_problem as jcompile
    from nllstpu_torch.core import linearsolver
    from nllstpu_torch.core.optimize import run_loop
    from nllstpu_torch.models import bal as tbal
    from nllstpu_torch.ops import schur_reduce

    jp, tp = tb._pair("chunk bucket")
    tc = pt.compile_problem(tp, solver="schur", schur_family=tbal.PT)
    st = run_loop(tc.assemble, tc.cost, tc.ctx(), pt.Options(
        schur_family=tbal.PT, max_iters=3, rel_dcost=0.0, abs_dcost=0.0,
    ), tp.stacked_variables())
    lam = float(st["itdata"]["lm_lambda"])
    v = st["variables"]
    cost0, sys64 = tc.assemble(v)
    ops = tc.ctx().linops
    x64 = ops.solve(sys64, lam)
    x_port = ops.solve(tuple(t.float() for t in sys64), lam).double()
    # The test's exact float32 solve: S over float32 closed-form inverses.
    a_rr, b_r, h_ll, g_l, w = (t.float() for t in sys64)
    h_inv = linearsolver.batched_inv_spd_cm(h_ll + lam * torch.eye(3)[:, :, None])
    s_sum, rhs_sum = schur_reduce.reduce_s_reference(w, h_inv, g_l)
    s32 = a_rr + lam * torch.eye(a_rr.shape[0]) - s_sum
    exact = np.linalg.solve(s32.double().numpy(), (b_r - rhs_sum).double().numpy())
    dr = exact.shape[0]
    # The JAX package's float32 step: its own assembly at the same state
    # (float64), cast to float32, through its reduction and solve.
    jp.set_values({k: t.numpy() for k, t in v.items()})
    jc = jcompile(jp, solver="schur", schur_family=nt.Euclidean(3))
    _, sys_j = jax.jit(jc.assemble)(jp.stacked_variables())
    sys_j32 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a, sys_j)
    x_jax = jax.jit(jc.ctx(nt.Options()).ops().solve)(sys_j32, jnp.float32(lam))
    x_jax = torch.from_numpy(np.asarray(x_jax, dtype=np.float64))
    x_jax64 = torch.from_numpy(np.asarray(jax.jit(jc.ctx(nt.Options()).ops().solve)(sys_j, lam)))
    d64 = float(tc.cost(tc.apply(v, x64)) - cost0)
    print(f"state after 3 float64 LM iterations, λ = {lam!r}; the two float64 steps lie "
          f"{float((x_jax64 - x64).abs().max() / x64.abs().max()):.3e} apart; float64 step's "
          f"cost change {d64!r}", flush=True)
    for name, x in (("port", x_port), ("jax", x_jax)):
        d = float(tc.cost(tc.apply(v, x)) - cost0)
        off = np.abs(x[:dr].numpy() - exact).max() / np.abs(exact).max()
        print(f"{name} float32 step: reduced part off the exact float32 solve by {off:.3e} of "
              f"its largest entry; cost change {d!r}, {abs(d - d64) / abs(d64):.3e} from the "
              f"float64 step's (same sign {d * d64 > 0}); largest entry "
              f"{float((x - x64).abs().max() / x64.abs().max()):.3e} apart", flush=True)


if __name__ == "__main__":
    todo = sys.argv[1:] or ["pcg_leg", "first_leg", "reduced_f32"]
    for name in todo:
        print(f"== {name}", flush=True)
        globals()[name]()
