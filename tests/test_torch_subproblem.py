"""Cost subsets, the runner cache and the graph driver's JAX options, on
the CPU in float64 against the JAX package: ``Problem``'s incidence and
subset methods (``varcostmap``, ``var_cost_counts``, ``subset_masks``,
``subproblem``, ``structure_version``), ``SubproblemView`` over the dense
and direct Schur backends (ports of ``tests/test_bulk_api.py``'s two view
tests, the port's compile count standing in for ``trace_count``), the
runner cache, and ``jit_full``, ``jit_max_time`` and ``jit_printout``.
The views' capture count on the card is held by
``tests/test_torch_cuda.py``."""

import gc

import numpy as np
import pytest
import torch

import nllstpu as jt
from nllstpu.models import bal as jbal
from nllstpu.models.ba import perturb_ba as jax_perturb
import nllstpu_torch as nt
from nllstpu_torch.core import optimize as topt
from nllstpu_torch.models import bal as tbal
from nllstpu_torch.models.ba import make_pinhole_ba, perturb_ba

PT = nt.family_name(tbal.PT)


def _prior(t, x):
    return x - t


def _mixed(pkg, balmod, data, **kw):
    """A BAL problem (one components-major batch) with point priors added
    one at a time and in bulk: three groups, single costs before chunks."""
    p, cams, pts = balmod.make_bal_problem(data, **kw)[:3]
    for h in pts[:3]:
        p.add_cost(_prior, (h,), params=np.zeros(3))
    idx = np.arange(5, 20, 2)
    p.add_cost_batch(_prior, [(balmod.PT, idx)], params=np.ones((idx.size, 3)))
    p.add_cost_batch(_prior, [(balmod.PT, idx + 1)], params=np.ones((idx.size, 3)))
    return p, cams, pts


@pytest.fixture(scope="module")
def bal_data():
    return (tbal.make_synthetic_bal(6, 48, obs_per_point=4, noise=1e-3),
            jbal.make_synthetic_bal(6, 48, obs_per_point=4, noise=1e-3))


def test_incidence_and_masks_match_jax(bal_data):
    d, dj = bal_data
    p, cams, pts = _mixed(nt, tbal, d, device="cpu")
    q, jcams, jpts = _mixed(jt, jbal, dj)
    assert p.num_variables() == q.num_variables() and p.num_costs() == q.num_costs()
    assert repr(p) == repr(q)
    assert p.structure_version == q.structure_version == 8
    vp, vq = p.varcostmap(), q.varcostmap()
    assert vp.keys() == vq.keys()
    for name in vp:
        for a, b in zip(vp[name], vq[name]):
            np.testing.assert_array_equal(a, b)
    for name, c in p.var_cost_counts().items():
        np.testing.assert_array_equal(c, q.var_cost_counts()[name])
    for pred, jpred in ((pts[4], jpts[4]), (pts[:7] + cams[:1], jpts[:7] + jcams[:1]),
                        (lambda hs: hs[0].index % 3 == 0, lambda hs: hs[0].index % 3 == 0)):
        for a, b in zip(p.subset_masks(pred), q.subset_masks(jpred)):
            np.testing.assert_array_equal(a, b)
        sp, sq = p.subproblem(pred), q.subproblem(jpred)
        assert sp.num_costs() == sq.num_costs()
        np.testing.assert_allclose(nt.cost(sp), jt.cost(sq), rtol=1e-9)


def test_structure_version_and_set_value():
    """Structure edits bump the version (each ``add_*`` call once), value
    edits do not."""
    p = nt.Problem(dtype=torch.float64, device="cpu")
    v0 = p.structure_version
    x = p.add_variable(nt.Euclidean(2), np.zeros(2))
    p.add_variables(nt.Euclidean(2), np.ones((3, 2)))
    p.add_cost(_prior, (x,), params=np.ones(2))
    p.add_cost_batch(_prior, [(nt.Euclidean(2), np.arange(4))], params=np.ones((4, 2)))
    assert p.structure_version == v0 + 4
    p.set_value(x, [3.0, 4.0])
    p.set_values(p.stacked_variables())
    assert p.structure_version == v0 + 4
    np.testing.assert_array_equal(p.get_value(x), [3.0, 4.0])


def _scalar_problem():
    rng = np.random.default_rng(4)
    sc = nt.Scalar()
    meas = rng.standard_normal(24)
    ia = (np.arange(24) % 6).astype(np.int32)
    p = nt.Problem(dtype=torch.float64, device="cpu")
    p.add_variables(sc, np.zeros(6))
    p.add_cost_batch(lambda t, x: x - t, slots=[(sc, ia)], params=meas)
    return p, sc, meas, ia


def test_subproblem_view_swaps_without_recompile():
    """One view compiled once, two subset swaps through the same compile,
    each optimizing exactly the selected costs (a fresh subproblem's
    result)."""
    opts = nt.Options(iterator=nt.LEVENBERG_MARQUARDT, max_iters=25)
    p, sc, meas, ia = _scalar_problem()
    fam = nt.family_name(sc)
    compiles = topt.COMPILES
    view = nt.SubproblemView(p)
    r0 = view.select(nt.VarHandle(sc, 0)).optimize(opts)
    x = p.stacked_variables()[fam].numpy()
    np.testing.assert_allclose(x[0], meas[ia == 0].mean(), rtol=1e-9)
    np.testing.assert_array_equal(x[1:], 0.0)  # unselected: exactly zero step
    r3 = view.select(nt.VarHandle(sc, 3)).optimize(opts)
    x = p.stacked_variables()[fam].numpy()
    np.testing.assert_allclose(x[3], meas[ia == 3].mean(), rtol=1e-9)
    assert r0.best_cost >= 0 and r3.best_cost >= 0
    assert view.compile_count == 1 and topt.COMPILES == compiles + 1
    assert len(view._runners) == 1
    p2, sc2, _, _ = _scalar_problem()
    sub = p2.subproblem(nt.VarHandle(sc2, 3))
    nt.optimize(sub, opts, unfixed=nt.VarHandle(sc2, 3))
    np.testing.assert_allclose(p2.stacked_variables()[fam].numpy()[3], x[3], rtol=1e-9)
    view.select(nt.VarHandle(sc, 0))
    np.testing.assert_allclose(view.cost(), 0.5 * ((x[0] - meas[ia == 0]) ** 2).sum(),
                               rtol=1e-9)
    p.add_cost(lambda t, v: v - t, (nt.VarHandle(sc, 1),), params=0.5)
    with pytest.raises(ValueError):
        view.select(nt.VarHandle(sc, 0))


def test_subproblem_view_over_schur(bal_data):
    """The direct Schur backend (the obs-major route, kernel B1's plain
    version here): subsets swap as mask values through the obs-major
    repack, matching a fresh subproblem and the JAX package's view."""
    d, dj = bal_data
    opts = dict(iterator=nt.LEVENBERG_MARQUARDT, max_iters=40, solver="schur")

    def build():
        p, cams, pts = tbal.make_bal_problem(d, device="cpu")
        perturb_ba(p, pts, 0.01, seed=7)
        return p, pts

    p, pts = build()
    o = nt.Options(schur_family=tbal.PT, **opts)
    view = nt.SubproblemView(p, solver="schur", schur_family=tbal.PT)
    assert view.compiled.schur_info.w_rows is not None  # the obs-major route
    half = len(pts) // 2
    r1 = view.select(pts[:half]).optimize(o)
    x1 = p.stacked_variables()[PT].numpy().copy()
    p2, pts2 = build()
    r_ref = nt.optimize(p2.subproblem(pts2[:half]), o)
    np.testing.assert_allclose(r1.best_cost, r_ref.best_cost, rtol=1e-12)
    np.testing.assert_allclose(x1, p2.stacked_variables()[PT].numpy(), rtol=0, atol=1e-10)
    r2 = view.select(pts[half:]).optimize(o)
    assert r2.best_cost < r2.start_cost and view.compile_count == 1
    q, _, jpts = jbal.make_bal_problem(dj)
    jax_perturb(q, jpts, 0.01, seed=7)
    jview = jt.SubproblemView(q, solver="schur", schur_family=jbal.PT)
    jo = jt.Options(schur_family=jbal.PT, **opts)
    j1 = jview.select(jpts[:half]).optimize(jo)
    j2 = jview.select(jpts[half:]).optimize(jo)
    for r, j in ((r1, j1), (r2, j2)):
        np.testing.assert_allclose(r.best_cost, j.best_cost, rtol=1e-9)
        assert r.num_iterations == j.num_iterations
    view.select(pts[:half])
    p3, pts3 = build()
    p3.set_values(p.stacked_variables())
    np.testing.assert_allclose(view.cost(), nt.cost(p3.subproblem(pts3[:half])), rtol=1e-12)
    # The JAX view at the same values (the two runs part along the gauge).
    q.set_values({k: v.numpy() for k, v in p.stacked_variables().items()})
    np.testing.assert_allclose(view.cost(), jview.select(jpts[:half]).cost(), rtol=1e-12)


def test_subproblem_view_refuses_implicit(monkeypatch):
    """``solver="schur"`` past the dense-W limit compiles the implicit
    backend, which the view refuses with the JAX package's message."""
    p, _, lmks = make_pinhole_ba(8, 64, 1.0, dtype=torch.float64, batched="cm", device="cpu")
    monkeypatch.setattr(topt, "DENSE_W_BYTE_LIMIT", 1024)
    with pytest.raises(ValueError, match="implicit Schur backend is not supported"):
        nt.SubproblemView(p, solver="schur", schur_family=nt.Euclidean(3))
    with pytest.raises(ValueError, match="solver='dense' or 'schur'"):
        nt.SubproblemView(p, solver="cg")


def _flagship(dtype=torch.float64):
    p, _, lmks = make_pinhole_ba(8, 64, 1.0, noise=1e-3, dtype=dtype, batched="cm",
                                 device="cpu")
    perturb_ba(p, lmks, 0.01, seed=5)
    return p


OPTS = dict(solver="schur", schur_family=nt.Euclidean(3), max_time=float("inf"))


def test_runner_cache_compiles_once():
    """A second optimize of an unchanged problem compiles nothing and
    gives a fresh run's result; a structure edit, or other options, compile
    again; a collected problem's entry is released."""
    p, fresh = _flagship(), _flagship()
    opts = nt.Options(max_iters=5, **OPTS)
    c0 = topt.COMPILES
    nt.optimize(p, opts)
    p.set_values(fresh.stacked_variables())
    again = nt.optimize(p, opts)
    assert topt.COMPILES == c0 + 1
    ref = nt.optimize(_flagship(), opts)
    assert again.costs == ref.costs and again.best_cost == ref.best_cost
    nt.optimize(p, nt.Options(max_iters=4, **OPTS))
    assert topt.COMPILES == c0 + 3
    p.add_cost(_prior, (nt.VarHandle(nt.Euclidean(3), 0),), params=np.zeros(3))
    nt.optimize(p, opts)
    assert topt.COMPILES == c0 + 4
    keys = [k for k in topt._runner_cache if k[0] == id(p)]
    assert len(keys) == 3
    del p
    gc.collect()
    assert not [k for k in topt._runner_cache if k in keys]


def test_runner_cache_evicts_and_releases():
    topt.clear_runner_cache()
    problems = [_flagship() for _ in range(topt._RUNNER_CACHE_SIZE + 1)]
    opts = nt.Options(max_iters=2, **OPTS)
    nt.optimize(problems[0], opts)
    first = next(iter(topt._runner_cache.values()))[0]
    runner = first._runner
    assert runner.bodies
    for p in problems[1:]:
        nt.optimize(p, opts)
    assert len(topt._runner_cache) == topt._RUNNER_CACHE_SIZE
    assert first.compiled is None and not runner.bodies and not runner.graphs
    assert not runner.vars
    topt.clear_runner_cache()
    assert not topt._runner_cache


def test_jit_full_steps_match_stepped_driver():
    """``store_trajectory="jit_full"``: the graph driver's in-graph step
    buffer holds the stepped driver's step vectors."""
    opts = dict(max_iters=8, **OPTS)
    r = nt.optimize(_flagship(), nt.Options(store_trajectory="jit_full", **opts))
    r_s = nt.optimize(_flagship(), nt.Options(store_trajectory=True, **opts))
    assert r.costs == r_s.trajectory.costs
    assert len(r.trajectory.trajectory) == r.num_iterations
    for a, b in zip(r.trajectory.trajectory, r_s.trajectory.trajectory):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(r.trajectory.step_norms,
                               [np.linalg.norm(s) for s in r.trajectory.trajectory],
                               rtol=1e-12)


def test_jit_max_time_and_printout(capsys):
    """``jit_max_time`` records the iterations' times under
    ``store_trajectory="jit"``; ``jit_printout`` prints the header, the
    start row and one row per iteration in ``printout_callback``'s
    format."""
    opts = dict(max_iters=6, **OPTS)
    r = nt.optimize(_flagship(), nt.Options(store_trajectory="jit", jit_max_time=True,
                                            jit_printout=True, **opts))
    out = capsys.readouterr().out.strip().splitlines()
    t = r.trajectory.times_ns
    assert len(t) == r.num_iterations and t == sorted(t) and t[0] > 0
    assert len(out) == r.num_iterations + 2
    assert out[0].split() == ["iter", "cost", "cost", "change", "|step|", "trust"]
    rows = [line.split() for line in out[2:]]
    assert [int(row[0]) for row in rows] == list(range(1, r.num_iterations + 1))
    np.testing.assert_allclose([float(row[1]) for row in rows], r.costs, rtol=1e-8)
    nt.optimize(_flagship(), nt.Options(store_trajectory=True, **opts),
                callback=nt.printout_callback)
    stepped = capsys.readouterr().out.strip().splitlines()
    assert stepped[0] == out[0] and stepped[1] == out[1]
    assert [line.split()[:2] for line in stepped[2:]] == [row[:2] for row in rows]
