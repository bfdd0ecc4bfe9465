"""The port's ``parallel/`` against the JAX package, on the CPU in
float64: the landmark-sharded host plan against the JAX
``parallelize_schur``'s (one process), the sharded paths in a two-process
``gloo`` job (one spawn of ``tests/_torch_parallel_worker.py`` for the
module) against the unsharded port and the JAX package's single-device
``optimize`` (its own tests hold its sharded result to that), the
two-rank cost trace against ONE JAX ``optimize_sharded`` run, and the
refusals."""

import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import nllstpu as nt
from nllstpu.core.optimize import compile_problem as jax_compile
from nllstpu.core.optimize import optimize as jax_optimize
from nllstpu.models import bal as jbal
from nllstpu.models.ba import make_pinhole_ba as jax_make_ba
from nllstpu.models.ba import perturb_ba as jax_perturb_ba
from nllstpu.parallel import make_mesh as jax_make_mesh
from nllstpu.parallel import optimize_sharded as jax_optimize_sharded
from nllstpu.parallel import parallelize_schur as jax_parallelize_schur
import nllstpu_torch as pt
from nllstpu_torch.core.optimize import schur_routes
from nllstpu_torch.models import bal as tbal
from nllstpu_torch.models.ba import make_pinhole_ba, perturb_ba
from nllstpu_torch.parallel import (
    distributed, make_mesh, optimize_sharded, parallelize, parallelize_schur, schur_shard,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "_torch_parallel_worker.py"
LMK = nt.Euclidean(3)
TLMK = pt.Euclidean(3)
#: Seconds a worker may take (it takes a few); the process group's own
#: timeout (60 s) ends a rank stuck in a collective first.
WORKER_TIMEOUT = 240


def _jax_pinhole(batched=False, noise=0.0, handles=False):
    p, cams, lmks = jax_make_ba(ncameras=6, nlandmarks=41, prop_visible=0.6, noise=noise,
                                dtype=jnp.float64, batched=batched)
    jax_perturb_ba(p, lmks, 0.01, seed=3)
    return (p, cams, lmks) if handles else p


def _port_pinhole(batched=False, noise=0.0):
    p, _, lmks = make_pinhole_ba(6, 41, 0.6, noise=noise, dtype=torch.float64,
                                 batched=batched, device="cpu")
    perturb_ba(p, lmks, 0.01, seed=3)
    return p


REALISTIC = dict(ncameras=10, npoints=180, seed=3, noise=1e-3, track_alpha=2.0)


def _jax_realistic():
    p, _, pts = jbal.make_bal_problem(jbal.make_realistic_bal(**REALISTIC), dtype=jnp.float64)
    jax_perturb_ba(p, pts, 0.02, seed=5)
    return p


def _port_realistic():
    p, _, pts = tbal.make_bal_problem(tbal.make_realistic_bal(**REALISTIC),
                                      dtype=torch.float64, device="cpu")
    perturb_ba(p, pts, 0.02, seed=5)
    return p


# ---------------------------------------------------------------------------
# (a) The host plan against the JAX package's, in one process
# ---------------------------------------------------------------------------

PLANS = [("pinhole", False, 2), ("pinhole", False, 8), ("pinhole", "cm", 2),
         ("pinhole", "cm", 8), ("realistic", "cm", 8)]


@pytest.mark.parametrize("problem,batched,n", PLANS)
def test_shard_plan_matches_jax(problem, batched, n):
    """Ownership, local numbering, the strided maps, each rank's rows and
    the local buckets, as the JAX ``parallelize_schur`` lays them out on
    the host.  The per-cost pinhole batch is obs-major in the JAX package
    and landmark-sorted in the port (its generic route): there the rows are
    compared by the (camera, landmark) pairs of each rank's real costs."""
    if problem == "pinhole":
        jp, tp = _jax_pinhole(batched), _port_pinhole(batched)
        fam, tfam = LMK, TLMK
    else:
        jp, tp = _jax_realistic(), _port_realistic()
        fam, tfam = jbal.PT, tbal.PT
    jpar = jax_parallelize_schur(jax_compile(jp, solver="schur", schur_family=fam),
                                 jax_make_mesh(n))
    _, info, batches, buckets, route = schur_routes(tp, tfam)
    plan = schur_shard.shard_plan(info, batches, buckets, route, n)
    assert plan.num_elim == jpar.num_elim
    assert plan.num_elim_local == jpar.num_elim_local
    np.testing.assert_array_equal(plan.elim_ids, np.asarray(jpar.elim_ids))
    for got, want in ((plan.gid_table, jpar.gid_table), (plan.gid_pos, jpar.gid_pos)):
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, np.asarray(want))
    (bi,) = range(len(batches))
    idx, _, mask = (np.asarray(a) if not isinstance(a, tuple) else tuple(map(np.asarray, a))
                    for a in jpar.batch_args[bi])
    exact = plan.route == bi
    assert exact == (batched == "cm")
    for s in range(n):
        shard = plan.shard(batches, bi, s)
        if exact:
            # The JAX package pads every rank to the longest; the port
            # keeps each rank's own multiple of 8 rows.
            rows = shard.mask.shape[0]
            assert rows % 8 == 0 and rows <= mask.shape[1] and not mask[s][rows:].any()
            np.testing.assert_array_equal(shard.mask, mask[s][:rows])
            for a, b in zip(shard.idx, idx):
                np.testing.assert_array_equal(np.where(shard.mask, a, -1),
                                              np.where(mask[s][:rows], b[s][:rows], -1))
        else:
            got = set(zip(*(a[shard.mask].tolist() for a in shard.idx)))
            want = set(zip(*(b[s][mask[s]].tolist() for b in idx)))
            assert got == want and len(got) == int(shard.mask.sum())
    meta = jpar.fast_meta[bi]
    if problem == "realistic":
        assert plan.gid_table is not None
        assert tuple(plan.buckets[bi]) == tuple(meta.buckets)
    elif exact:
        assert plan.buckets[bi] == ((0, plan.num_elim_local, meta.obs_k, 0),)


# ---------------------------------------------------------------------------
# (b) Two gloo ranks, one spawn for the module
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks():
    """The two ranks' JSON results (rank order)."""
    with tempfile.TemporaryDirectory() as tmp:
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        procs = [
            subprocess.Popen(
                [sys.executable, str(WORKER), os.path.join(tmp, "store"), "2", str(r)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=env,
            )
            for r in range(2)
        ]
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=WORKER_TIMEOUT)
                assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
                outs.append(json.loads(out.splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    return outs


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's single-device runs that the two-rank runs are held
    to, and its one sharded run (two virtual devices)."""
    lm = nt.Options(solver="schur", schur_family=LMK, max_iters=30)
    noisy = dict(rel_dcost=1e-6, max_iters=30, max_time=float("inf"))
    refs = {}
    for key, form in (("lm", False), ("lm_cm", "cm")):
        p = _jax_pinhole(form)
        res = jax_optimize(p, lm)
        refs[key] = (res, {k: np.asarray(v) for k, v in p.stacked_variables().items()})
    refs["dogleg"] = jax_optimize(_jax_pinhole(), nt.Options(
        solver="schur", schur_family=LMK, iterator=nt.DOGLEG, max_iters=40))
    refs["implicit"] = jax_optimize(_jax_pinhole(noise=1e-3), nt.Options(
        solver="schur_cg", schur_family=LMK, **noisy))
    p, cams, lmks = _jax_pinhole("cm", 1e-3, handles=True)
    refs["fixed"] = jax_optimize(p, nt.Options(
        solver="schur", schur_family=LMK, store_trajectory=True, **noisy),
        unfixed=cams[2:] + lmks[5:])
    refs["realistic"] = jax_optimize(_jax_realistic(), nt.Options(
        solver="schur", schur_family=jbal.PT, max_iters=15, max_time=float("inf")))
    for form in (False, "cm"):
        refs[f"run_schur_{form}"] = jax_optimize(_jax_pinhole(form, 1e-3), nt.Options(
            solver="schur", schur_family=LMK, store_trajectory=True, **noisy))
    refs["run_dense"] = jax_optimize(_jax_pinhole(noise=1e-3), nt.Options(
        solver="dense", store_trajectory=True, **noisy))
    refs["trace"] = jax_optimize_sharded(_jax_pinhole(noise=1e-3), jax_make_mesh(2), nt.Options(
        solver="schur", schur_family=LMK, store_trajectory=True, **noisy))
    return refs


#: What every rank must hold bit for bit the same.
REPLICATED = ("iterations", "start", "best", "costs", "solves", "variables")


def test_psum_over_two_ranks(ranks):
    assert [o["rank"] for o in ranks] == [0, 1]
    assert all(o["size"] == 2 and o["psum"] == 3.0 for o in ranks)


@pytest.mark.parametrize("case", ["dense", "schur_sum", "schur_sum_per_cost"])
def test_parallelize_sums_the_unsharded_system(ranks, case):
    """``parallelize``: every rank's sum of the two row blocks equals the
    unsharded port's system within 1e-12, the same bits on both ranks (the
    per-cost batch: the generic route on every rank)."""
    for o in ranks:
        assert o[case]["err"] <= 1e-12, o[case]["err"]
        assert sum(o[case]["local_rows"]) > 0
    assert ranks[0][case]["bits"] == ranks[1][case]["bits"]


@pytest.mark.parametrize("form", ["False", "cm"])
def test_landmark_sharded_system(ranks, form):
    """Each rank holds Lc = ceil(L/2) landmarks' h_ll, g_l and W, equal bit
    for bit to the unsharded port's rows of its landmarks, zero on its pad
    slots; a_rr, b_r and the damped step (λ = 0.1) agree with the
    unsharded ones, the same bits on both ranks."""
    for o in ranks:
        c = o[f"sharded_system_{form}"]
        lc = -(-c["L"] // 2)
        assert c["lc"] == lc and c["h_shape"] == [3, 3, lc] and c["g_shape"] == [3, lc]
        assert c["w_shape"][:2] == [lc, 3]
        assert c["h_equal"] and c["g_equal"] and c["w_equal"] and c["pads_zero"]
        assert c["cost_err"] <= 1e-15 and c["a_err"] <= 1e-12 and c["b_err"] <= 1e-13
        assert c["x_err"] <= 1e-12
    assert ranks[0][f"sharded_system_{form}"]["bits"] == ranks[1][f"sharded_system_{form}"]["bits"]


@pytest.mark.parametrize("case", ["lm", "lm_cm", "dogleg", "trace", "implicit", "fixed",
                                  "realistic"])
def test_ranks_bitwise_equal(ranks, case):
    """The replicated results of every run are the same bits on both
    ranks; the phase times are measured (finite, positive)."""
    for key in REPLICATED:
        assert ranks[0][case][key] == ranks[1][case][key], key
    for o in ranks:
        assert all(np.isfinite(t) and t > 0 for t in o[case]["times"])


@pytest.mark.parametrize("case", ["lm", "lm_cm"])
def test_direct_lm_matches_jax(ranks, jax_refs, case):
    """Direct LM, 30 iterations at most, on the pinhole problem (41
    landmarks over 2 ranks: a pad slot): the JAX single-device run's
    iteration count, and its variables within 1e-9."""
    ref, ref_vars = jax_refs[case]
    got = ranks[0][case]
    assert got["best"] < 1e-25
    assert got["iterations"] == ref.num_iterations
    assert sorted(got["variables"]) == sorted(ref_vars)
    for name, v in ref_vars.items():
        np.testing.assert_allclose(np.asarray(got["variables"][name]), v.reshape(-1), atol=1e-9)


def test_dogleg_matches_jax(ranks, jax_refs):
    """Dogleg (the fused λ = 0 leg and gᵀHg, one more scalar in the
    gather's collective) reaches the single-device optimum."""
    ref = jax_refs["dogleg"]
    assert ranks[0]["dogleg"]["best"] <= max(ref.best_cost * (1 + 1e-9), 1e-25)


@pytest.mark.parametrize("case", ["run_dense", "run_schur_False", "run_schur_cm"])
def test_data_parallel_run_matches(ranks, jax_refs, case):
    """``parallelize(...).run`` (the loop over the summed system, the base
    compile's solve and tables over the summed W, the summed cost in the
    base's context) on the noisy problem: the unsharded port's stepped
    trace within 1e-12 relative, the JAX single-device trace within 1e-9,
    the same bits on both ranks."""
    ref = jax_refs[case]
    got = ranks[0][case]
    assert got["iterations"] == got["one_iterations"] == ref.num_iterations
    for o in ranks:
        assert o[case]["one_err"] <= 1e-12, o[case]["one_err"]
    np.testing.assert_allclose(got["start"], ref.start_cost, rtol=1e-12)
    np.testing.assert_allclose(got["costs"], [float(c) for c in ref.trajectory.costs], rtol=1e-9)
    for key in ("iterations", "costs", "best", "bits"):
        assert ranks[0][case][key] == ranks[1][case][key], key


def test_implicit_sums_over_ranks(ranks):
    """The implicit solve's pieces on each rank's shard equal the unsharded
    port's within 1e-12: the Schur-Jacobi inverses (a corrected family, its
    W correction summed over the ranks), the PCG's right-hand side and
    preconditioned residual, one reduced matvec, at the LM's first λ
    (1e-6·max diag, where the correction shapes the blocks).  One damped
    solve of that system takes the unsharded solve's PCG iterations ±1 at
    the tolerances 1e-6, 1e-9 and the default 1e-12 (measured: 42, 50, 51
    against 42, 49, 50).  Over a whole run the iterations per solve are
    those of a one-rank run of the sharded code and of the unsharded run
    within 2: the ranks' summation order moves them by up to 2 (measured:
    [51, 61, 70] against [50, 60, 72]), as a one-ulp change of the
    unsharded run's start moves them by up to 1, and by up to 7 at 1e-6,
    on this ill-conditioned problem."""
    for o in ranks:
        c = o["implicit_pieces"]
        assert any(c["corrected"])
        for key in ("inv_err", "rhs_err", "z_err", "matvec_err"):
            assert c[key] <= 1e-12, (key, c[key])
        solves = c["solve_iters"]
        for tol in ("1e-06", "1e-09", "None"):
            assert abs(solves[f"two {tol}"] - solves[f"one {tol}"]) <= 1, solves
        iters = c["cg_iters"]
        assert iters["one rank"] == iters["unsharded"], iters
        assert len(iters["two ranks"]) == len(iters["one rank"]) > 0, iters
        assert all(abs(a - b) <= 2 for a, b in zip(iters["two ranks"], iters["one rank"])), iters
    assert ranks[0]["implicit_pieces"]["cg_iters"] == ranks[1]["implicit_pieces"]["cg_iters"]


def test_implicit_matches_jax(ranks, jax_refs):
    """The implicit solve (every W sum of the PCG summed over the ranks)
    on the noisy pinhole problem: the JAX single-device schur_cg run's
    best cost within 1e-7 relative."""
    ref = jax_refs["implicit"]
    np.testing.assert_allclose(ranks[0]["implicit"]["best"], ref.best_cost, rtol=1e-7)


def test_bucketed_realistic_matches_jax(ranks, jax_refs):
    """The skewed-degree problem takes strided ownership with the local
    bucket plan (kernel B2's layout per rank), each rank holding its Lc
    landmarks, and LM for 15 iterations reaches the JAX single-device best
    cost within 1e-8 relative."""
    for o in ranks:
        plan = o["realistic_plan"]
        assert plan["strided"] and len(plan["buckets"]) > 1
        assert plan["h_shape"] == [3, 3, plan["lc"]] and plan["w_shape"][:2] == [plan["lc"], 3]
        assert plan["lc"] <= -(-plan["L"] // 2) + len(plan["buckets"])
    np.testing.assert_allclose(ranks[0]["realistic"]["best"], jax_refs["realistic"].best_cost,
                               rtol=1e-8)


def test_fixed_variables_match_jax(ranks, jax_refs):
    """Two cameras and five landmarks fixed (the fixed landmarks' costs
    spread over the ranks by the balanced fill and summed into a_rr and
    b_r): the JAX single-device trace within 1e-9 relative."""
    ref = jax_refs["fixed"]
    got = ranks[0]["fixed"]
    assert got["iterations"] == ref.num_iterations
    np.testing.assert_allclose(got["start"], ref.start_cost, rtol=1e-12)
    np.testing.assert_allclose(got["costs"], [float(c) for c in ref.trajectory.costs], rtol=1e-9)


def test_trace_matches_jax_sharded(ranks, jax_refs):
    """(c) The two-rank cost trace against the JAX package's own
    two-device ``optimize_sharded`` run, iteration by iteration within
    1e-9 relative (the noisy problem, stopped at rel_dcost 1e-6 above the
    rounding floor)."""
    ref = jax_refs["trace"]
    got = ranks[0]["trace"]
    ref_costs = [float(c) for c in ref.trajectory.costs]
    assert got["iterations"] == ref.num_iterations == len(ref_costs)
    np.testing.assert_allclose(got["start"], ref.start_cost, rtol=1e-12)
    np.testing.assert_allclose(got["costs"], ref_costs, rtol=1e-9)


# ---------------------------------------------------------------------------
# One rank in this process: the sharded code path against optimize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("solver", ["schur", "schur_cg"])
def test_one_rank_mesh_is_optimize(solver):
    """A mesh of one rank (no process group) runs the sharded code with no
    collective and gives ``optimize``'s stepped-driver bits."""
    opts = pt.Options(solver=solver, schur_family=TLMK, max_iters=10, rel_dcost=1e-6,
                      store_trajectory=True)
    p1, p2 = _port_pinhole("cm", 1e-3), _port_pinhole("cm", 1e-3)
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    r1, r2 = pt.optimize(p1, opts), optimize_sharded(p2, mesh, opts)
    assert r1.costs == r2.costs and r1.num_iterations == r2.num_iterations
    for k, v in p1.stacked_variables().items():
        assert torch.equal(v, p2.stacked_variables()[k])
    assert mesh.collectives == 0


# ---------------------------------------------------------------------------
# (d) Refusals
# ---------------------------------------------------------------------------


def test_parallelize_refuses_implicit():
    p = _port_pinhole("cm")
    comp = pt.compile_problem(p, solver="schur_cg", schur_family=TLMK)
    with pytest.raises(ValueError, match="does not support the implicit"):
        parallelize(comp, make_mesh(device="cpu"))


def test_parallelize_schur_requires_schur():
    comp = pt.compile_problem(_port_pinhole(), solver="dense")
    with pytest.raises(ValueError, match="requires a Schur compiled problem"):
        parallelize_schur(comp, make_mesh(device="cpu"))


def test_optimize_sharded_requires_schur_family():
    with pytest.raises(ValueError, match="schur_family"):
        optimize_sharded(_port_pinhole(), make_mesh(device="cpu"), pt.Options(solver="schur"))


def test_nccl_needs_a_card_per_rank():
    """Two ranks on one card over NCCL are refused with the reason, before
    any process group exists; gloo takes them; a mesh of more ranks than
    the group has is refused."""
    with pytest.raises(ValueError, match="share a card"):
        distributed.check_backend("nccl", 2, 1)
    distributed.check_backend("nccl", 2, 2)
    distributed.check_backend("gloo", 2, 1)
    with pytest.raises(ValueError, match="share a card"):
        distributed.initialize("nccl", "file:///nonexistent/store", world_size=2, rank=0)
    with pytest.raises(ValueError, match="one of"):
        distributed.check_backend("mpi", 2, 2)
    with pytest.raises(ValueError, match="one process per rank"):
        make_mesh(2, device="cpu")
