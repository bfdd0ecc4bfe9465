"""Adaptive robust kernels on every backend and batch form of the port,
and cluster-Jacobi, against the JAX package on the CPU in float64.

The problem is the one the JAX package takes on all eight combinations of
the two batch forms of an adaptive BAL batch (components-major
``batched="cm"``, per-cost ``batched=False``) and the four solvers
(``schur``, ``schur_cg``, ``dense``, ``cg``): Snavely BAL, 6 cameras and 40
points, one ``ContaminatedGaussian`` (1, 10, 0.8).  Per combination: the
per-cost ``rho_dkernel``, the assembled system within 1e-10, the damped
step held to an exact solve of the JAX package's dense system (backward
error within a small multiple of ε, forward error within 16·κ·ε, the JAX
package's step meeting both too), and a short LM trace within 1e-9 with
the same counts (PCG iterations included).  Cluster-Jacobi: its blocks,
the PCG counts of its solves and its fallbacks, on the 16/256 pinhole
problem of ``tests/test_torch_slice.py``."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import nllstpu as nt
from nllstpu.core import iterators as jax_iterators
from nllstpu.core.optimize import compile_problem as jax_compile
from nllstpu.models import bal as jbal
from nllstpu.models.ba import make_pinhole_ba as jax_make_ba
from nllstpu.models.ba import perturb_ba as jax_perturb_ba
from nllstpu.ops import cg as jax_cg
from nllstpu.ops import schur as jax_schur
import nllstpu_torch as pt
from nllstpu_torch.core.optimize import _GraphRunner
from nllstpu_torch.models import bal as tbal
from nllstpu_torch.models.ba import make_pinhole_ba, perturb_ba

SOLVERS = ("schur", "schur_cg", "dense", "cg")
#: (batch form, solver): every combination the port refused before but one.
CASES = [f"{b}-{s}" for b in ("cm", "percost") for s in SOLVERS]
KP = np.asarray(nt.ContaminatedGaussian.make_params(1.0, 10.0, 0.8))
#: PCG tolerance of the iterative backends in these runs (their steps then
#: lie within the problem's own rounding spread).
TOL = 1e-13
EPS = np.finfo(np.float64).eps


def pair(case):
    """The case's (JAX, port) problems, built from one data set, the points
    perturbed alike."""
    form, _ = case.split("-")
    batched = "cm" if form == "cm" else False
    data = jbal.make_synthetic_bal(6, 40, noise=1e-2)
    jp, _, jpts, _ = jbal.make_bal_problem(data, kernel=nt.ContaminatedGaussian(),
                                           kernel_params=KP, batched=batched)
    jax_perturb_ba(jp, jpts, 0.01, seed=7)
    tp, _, tpts, _ = tbal.make_bal_problem(data, device="cpu", kernel=pt.ContaminatedGaussian(),
                                           kernel_params=KP, batched=batched)
    perturb_ba(tp, tpts, 0.01, seed=7)
    return jp, tp


def _family(solver, pkg):
    if not solver.startswith("schur"):
        return {}
    return {"schur_family": (jbal if pkg is nt else tbal).PT}


def lm_options(case):
    """The (JAX, port) options of the case's short LM trace: two
    iterations, stopped before the float64 floor."""
    solver = case.split("-")[1]
    kw = dict(solver=solver, max_iters=2, rel_dcost=1e-6)
    if solver in ("schur_cg", "cg"):
        kw["linear_tol"] = TOL
    return (nt.Options(store_trajectory="jit", **kw, **_family(solver, nt)),
            pt.Options(max_time=float("inf"), **kw, **_family(solver, pt)))


class _Proxy:
    """``base`` with some attributes replaced."""

    def __init__(self, base, **over):
        self._base, self._over = base, over

    def __getattr__(self, name):
        return self._over[name] if name in self._over else getattr(self._base, name)


@pytest.fixture
def jax_pcg_iters(monkeypatch):
    """The PCG iterations of every JAX implicit or cg solve, in order: the
    one ``while_loop`` of ``nllstpu.ops.schur`` and of ``nllstpu.ops.cg``
    is the PCG, whose state ends with its iteration count."""
    iters = []

    def counting(cond, body, init):
        out = jax.lax.while_loop(cond, body, init)
        jax.debug.callback(lambda k: iters.append(int(k)), out[-1], ordered=True)
        return out

    proxy = _Proxy(jax, lax=_Proxy(jax.lax, while_loop=counting))
    monkeypatch.setattr(jax_schur, "jax", proxy)
    monkeypatch.setattr(jax_cg, "jax", proxy)
    return iters


@pytest.mark.parametrize("kernel", ["ContaminatedGaussian", "Barron", "ScaledAdaptive"])
def test_rho_dkernel_matches_jax(kernel):
    """The per-cost ``rho_dkernel`` (value, gradient and Hessian in [kernel
    tangent, s]) against the JAX package's autodiff one, within 1e-10, on
    both sides of the outlier knee and with the mixture's sigmas in either
    stored order."""
    if kernel == "Barron":
        jk, tk, kps = nt.Barron(), pt.Barron(), [[1.0, 1.0], [0.4, 2.5], [1.7, 0.3]]
    else:
        jk, tk = nt.ContaminatedGaussian(), pt.ContaminatedGaussian()
        kps = [KP, [0.2, 1.5, 0.3], [3.0, 0.5, 0.6]]
        if kernel == "ScaledAdaptive":
            jk, tk = nt.ScaledAdaptive(jk, 2.5), pt.ScaledAdaptive(tk, 2.5)
    for kp in kps:
        for s in (0.0, 1e-3, 0.7, 4.0, 60.0):
            ref = jk.rho_dkernel(jnp.asarray(kp, dtype=jnp.float64), jnp.float64(s))
            got = tk.rho_dkernel(torch.tensor(kp, dtype=torch.float64),
                                 torch.tensor(s, dtype=torch.float64))
            for name, a, b in zip(("rho", "grad", "hess"), got, ref):
                b = np.asarray(b)
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-10,
                                           atol=1e-10 * np.abs(b).max(),
                                           err_msg=f"{kernel} {kp} s={s} {name}")


def _by_family(x, layout, manifolds):
    """Flat step → per family ``[n, dof]`` in variable order."""
    x = np.asarray(x)
    return {name: x[np.asarray(off)[:, None] + np.arange(manifolds[name].dof)]
            for name, off in layout.offsets.items()}


def _refined_solve(a, b, rounds=3):
    """``a⁻¹ b`` in float64, refined over residuals taken in long double."""
    x = np.linalg.solve(a, b)
    al, bl = a.astype(np.longdouble), b.astype(np.longdouble)
    for _ in range(rounds):
        x = x + np.linalg.solve(a, (bl - al @ x.astype(np.longdouble)).astype(np.float64))
    return x


def _jax_linops(jc):
    """The JAX package's linear ops of a compiled problem, PCG at ``TOL``."""
    ops = jc.ctx().linops
    if ops is None:
        return jax_iterators.DenseOps(jc.layout.dof_total)
    return dataclasses.replace(ops, tol=TOL) if hasattr(ops, "tol") else ops


@pytest.mark.parametrize("case", CASES)
def test_system_and_step_match_jax(case, jax_pcg_iters):
    """The case's assembled system against the JAX package's (direct:
    cost, a_rr, b_r, h_ll, g_l, W; implicit: cost, a_rr, b_r, h_ll, g_l;
    dense: cost, H, g; cg: cost, g) within 1e-10, and the damped step at
    λ = 1e-2 of both packages held to an exact solve of the JAX package's
    dense system H + λI (κ ≈ 1e8): backward error within 64·ε for the
    direct solves and within the PCG tolerance for the iterative ones,
    forward error within 16·κ·max(ε, that bound); on the iterative
    backends, the PCG iterations of one solve."""
    solver = case.split("-")[1]
    jp, tp = pair(case)
    jc = jax_compile(jp, solver=solver, **_family(solver, nt))
    tc = pt.compile_problem(tp, solver=solver, **_family(solver, pt))
    for name, off in jc.layout.offsets.items():
        assert np.array_equal(np.asarray(off), tc.layout.offsets[name]), name
    cost_j, sys_j = jax.jit(jc.assemble)(jp.stacked_variables())
    cost_t, sys_t = tc.assemble(tp.stacked_variables())
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-12)
    if solver == "schur":
        pairs = list(zip("a_rr b_r h_ll g_l".split(), sys_t[:4], sys_j[:4]))
        pairs.append(("w", sys_t[4], np.asarray(sys_j[4]).transpose(1, 0, 2)))
    elif solver == "schur_cg":
        pairs = list(zip("a_rr b_r h_ll g_l".split(), sys_t[:4], sys_j[:4]))
    elif solver == "dense":
        pairs = list(zip(("h", "g"), sys_t, sys_j))
    else:
        pairs = [("g", tc.ctx().linops.grad(sys_t), jc.ctx().linops.grad(sys_j))]
    for name, a, b in pairs:
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-10, atol=1e-10 * np.abs(b).max(),
                                   err_msg=f"{case} {name}")
    # The reference: the JAX package's dense system of the same variables.
    jd = jax_compile(jp, solver="dense")
    _, (h, g) = jax.jit(jd.assemble)(jp.stacked_variables())
    lam = 1e-2
    a = np.asarray(h) + lam * np.eye(h.shape[0])
    g = np.asarray(g)
    ref = _refined_solve(a, g)
    ev = np.linalg.eigvalsh(a)
    kappa = np.abs(ev).max() / np.abs(ev).min()  # H + λI is indefinite here
    iterative = solver in ("schur_cg", "cg")
    bound = 10 * TOL if iterative else 64 * EPS
    mans = {n: tp.manifold_of(n) for n in tp.family_names()}
    errs = {}
    for who, comp, x in (
        ("port", tc, tc.ctx(pt.Options(linear_tol=TOL)).linops.solve(sys_t, lam).numpy()),
        ("jax", jc, np.asarray(_jax_linops(jc).solve(sys_j, jnp.asarray(lam)))),
    ):
        fam = _by_family(x, comp.layout, mans)
        flat = np.zeros_like(ref)
        for name, off in jd.layout.offsets.items():
            flat[np.asarray(off)[:, None] + np.arange(mans[name].dof)] = fam[name]
        bwd = np.linalg.norm(a @ flat - g) / (np.linalg.norm(a, 2) * np.linalg.norm(flat)
                                              + np.linalg.norm(g))
        errs[who] = (bwd, np.abs(flat - ref).max() / np.abs(ref).max())
    msg = f"{case}: κ={kappa:.3e}, (backward, forward) error: {errs}"
    for who, (bwd, fwd) in errs.items():
        assert bwd <= bound and fwd <= 16 * kappa * max(EPS, bound), f"{who}: {msg}"
    if iterative:
        # The PCG iterations of one solve at λ = 1 and tolerance 1e-6 (H +
        # λI is indefinite at 1e-2, where the count turns on rounding),
        # within one of the JAX package's plus the JAX package's own spread
        # over its system scaled by 1 and 1 ± 2⁻⁵².
        ops = tc.ctx(pt.Options(linear_tol=1e-6)).linops
        ops.solve(sys_t, 1.0)
        jax_pcg_iters.clear()
        for scale in (1.0, 1.0 + 2.0**-52, 1.0 - 2.0**-52):
            scaled = jax.tree_util.tree_map(
                lambda t: t * scale if jnp.issubdtype(t.dtype, jnp.floating) else t, sys_j)
            dataclasses.replace(jc.ctx().linops, tol=1e-6).solve(scaled, jnp.asarray(1.0))
        jax.effects_barrier()
        spread = max(jax_pcg_iters) - min(jax_pcg_iters)
        assert abs(ops.cg_iters[-1] - jax_pcg_iters[0]) <= 1 + spread, (
            f"PCG iterations port {ops.cg_iters}, jax {jax_pcg_iters}")


@pytest.mark.parametrize("case", CASES)
def test_lm_trace_matches_jax(case):
    """Two LM iterations (six damped solves): the same iterations, linear
    solves and termination as the JAX package,
    the cost trace within 1e-9 relative and the recovered kernel
    parameters within 1e-7.  The JAX package moves from itself by at most
    6.2e-12 of this trace when its start is scaled by 1 ± 2⁻⁵²
    (``scripts_torch/trace_spread.py adaptive``); over four iterations its
    self-spread reaches 1.2e-9 (9.4e-8 with a PCG tolerance of 1e-10), so
    a longer trace could not be held to 1e-9."""
    jp, tp = pair(case)
    jo, to = lm_options(case)
    r_j = nt.optimize(jp, jo)
    jax.effects_barrier()
    comp = pt.compile_problem(tp, solver=to.solver, schur_family=to.schur_family)
    runner = _GraphRunner(comp, to, tp.stacked_variables())
    fin = runner.run()
    counts = [(int(fin["iternum"]), int(fin["nsolve"]), int(fin["converged"])),
              (r_j.num_iterations, r_j.linear_solves, r_j.termination)]
    msg = f"{case}: (iterations, solves, termination) port, jax: {counts}"
    assert counts[0] == counts[1], msg
    np.testing.assert_allclose(float(fin["startcost"]), r_j.start_cost, rtol=1e-12, err_msg=msg)
    np.testing.assert_allclose([float(c) for c in fin["trace"]],
                               np.asarray(r_j.trajectory.costs), rtol=1e-9, err_msg=msg)
    kname = "ContaminatedGaussianManifold()"
    np.testing.assert_allclose(fin["variables"][kname].numpy(),
                               np.asarray(jp.stacked_variables()[kname]), rtol=1e-7)


def _pinhole_pair(ncam=16, nlmk=256, vis=0.3):
    jp, _, jl = jax_make_ba(ncam, nlmk, vis, noise=1e-3, dtype=jnp.float64, batched="cm")
    jax_perturb_ba(jp, jl, 0.03, seed=5)
    tp, _, tl = make_pinhole_ba(ncam, nlmk, vis, noise=1e-3, dtype=torch.float64, batched="cm",
                                device="cpu")
    perturb_ba(tp, tl, 0.03, seed=5)
    return jp, tp, jl, tl


def test_cluster_jacobi_matches_jax(jax_pcg_iters):
    """``Options(schur_cluster_size=4)`` on the 16/256 pinhole problem
    (four clusters of four cameras): the inverted cluster blocks within
    16·κ·ε of the JAX package's (κ the blocks' largest condition number),
    and at λ ∈ {1e-3, 1e-1} the PCG iterations within one of the JAX
    package's plus its own spread over its system scaled by 1 ± 2⁻⁵²,
    fewer than Schur-Jacobi's; the step within 1e-8 of max|x|."""
    jp, tp, _, _ = _pinhole_pair()
    jc = jax_compile(jp, solver="schur_cg", schur_family=nt.Euclidean(3))
    tc = pt.compile_problem(tp, solver="schur_cg", schur_family=pt.Euclidean(3))
    _, sys_j = jax.jit(jc.assemble)(jp.stacked_variables())
    _, sys_t = tc.assemble(tp.stacked_variables())
    for lam in (1e-3, 1e-1):
        counts = {}
        for m in (0, 4):
            ops_j = dataclasses.replace(jc.ctx().linops, tol=1e-10, cluster_size=m)
            ops_t = tc.ctx(pt.Options(linear_tol=1e-10, schur_cluster_size=m)).linops
            assert (ops_t.cluster is None) == (m == 0) == (ops_j._cluster_layout() is None)
            jax_pcg_iters.clear()
            for scale in (1.0, 1.0 + 2.0**-52, 1.0 - 2.0**-52):
                scaled = jax.tree_util.tree_map(
                    lambda t: t * scale if jnp.issubdtype(t.dtype, jnp.floating) else t, sys_j)
                x_j = np.asarray(ops_j.solve(scaled, jnp.asarray(lam)))
                if scale == 1.0:
                    x_j1 = x_j
            jax.effects_barrier()
            x_t = ops_t.solve(sys_t, lam).numpy()
            spread = max(jax_pcg_iters) - min(jax_pcg_iters)
            counts[m] = (ops_t.cg_iters[-1], list(jax_pcg_iters))
            assert abs(ops_t.cg_iters[-1] - jax_pcg_iters[0]) <= 1 + spread, (lam, counts)
            np.testing.assert_allclose(x_t, x_j1, rtol=0, atol=1e-8 * np.abs(x_j1).max())
            if m:
                h_inv = ops_t.damped_inverse(sys_t[2], lam)
                inv_t = ops_t.cluster_inverses(sys_t, lam, h_inv).numpy()
                inv_j = np.asarray(ops_j.cluster_inverses(
                    sys_j, jnp.asarray(lam), jnp.asarray(h_inv.numpy()), ops_j._cluster_layout()))
                kappa = max(np.linalg.cond(b) for b in inv_j)
                np.testing.assert_allclose(inv_t, inv_j, rtol=0,
                                           atol=16 * kappa * EPS * np.abs(inv_j).max())
        assert counts[4][0] < counts[0][0], counts


def test_cluster_jacobi_falls_back_as_jax():
    """Where the JAX package's ``_cluster_layout`` declines cluster-Jacobi,
    the port keeps Schur-Jacobi: a fixed camera (the offsets no longer
    contiguous), more than 64 clusters, an adaptive batch; where it takes
    it, the port does too."""
    cases = [((16, 64, 0.5), False, 4), ((16, 64, 0.5), True, 4), ((66, 32, 0.5), False, 1),
             ((66, 32, 0.5), False, 2)]
    for shape, fix_one, m in cases:
        jp, tp, _, _ = _pinhole_pair(*shape)
        masks = {name: np.ones(len(v), dtype=bool) for name, v in tp.stacked_variables().items()}
        if fix_one:
            masks["SE3()"][0] = False
        jc = jax_compile(jp, masks, solver="schur_cg", schur_family=nt.Euclidean(3))
        tc = pt.compile_problem(tp, masks, solver="schur_cg", schur_family=pt.Euclidean(3))
        taken = dataclasses.replace(jc.ctx().linops, cluster_size=m)._cluster_layout() is not None
        assert taken == (not fix_one and -(-shape[0] // m) <= 64), (shape, fix_one, m)
        assert (tc.ctx(pt.Options(schur_cluster_size=m)).linops.cluster is not None) == taken
    jp, tp = pair("cm-schur_cg")
    jc = jax_compile(jp, solver="schur_cg", schur_family=jbal.PT)
    tc = pt.compile_problem(tp, solver="schur_cg", schur_family=tbal.PT)
    assert dataclasses.replace(jc.ctx().linops, cluster_size=2)._cluster_layout() is None
    assert tc.ctx(pt.Options(schur_cluster_size=2)).linops.cluster is None
