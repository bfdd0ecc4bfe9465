"""The port's own spans and counters on the CPU: the ``nt.*`` spans of
``optimize`` under ``torch.profiler`` and their nesting, the counters on
``Result`` (replays per graph piece, PCG iterations per solve, set-up
seconds) and their process totals, an LU retake counted as a ``trial_lu``
replay, and no ``record_function`` while no profiler records."""

import collections
import json
import math

import pytest
import torch

import nllstpu_torch as pt
from nllstpu_torch.core import linearsolver
from nllstpu_torch.models import bal as tbal
from nllstpu_torch.models.ba import perturb_ba
from nllstpu_torch.utils import profiling

TINY_BAL = dict(ncameras=8, npoints=150, seed=3, noise=1e-3, track_alpha=2.3)
SETUP_PHASES = {"setup", "compile.layout", "compile.tables", "compile.upload"}


def _tiny_bal():
    p, _, pts = tbal.make_bal_problem(tbal.make_realistic_bal(**TINY_BAL),
                                      dtype=torch.float64, device="cpu")
    perturb_ba(p, pts, 0.05, seed=5)
    return p


def _opts(solver):
    return pt.Options(solver=solver, schur_family=pt.Euclidean(3), max_iters=6,
                      linear_tol=1e-2, max_time=float("inf"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per route: two ``optimize`` calls on one problem (a compile, then
    the runner cache's hit) under one ``torch.profiler`` session, their
    Results, the ``nt.*`` events inside their ``nt.optimize`` spans as
    ``(name, start, end)`` from the exported trace, and what the calls
    added to the process totals."""
    results, added = {}, {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for solver in ("schur", "schur_cg"):
            problem, opts = _tiny_bal(), _opts(solver)
            before = collections.Counter(profiling.totals())
            results[solver] = [pt.optimize(problem, opts), pt.optimize(problem, opts)]
            added[solver] = {k: v - before[k] for k, v in profiling.totals().items()
                             if v != before[k]}
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = sorted((e["name"], e["ts"], e["ts"] + e["dur"])
                    for e in json.loads(path.read_text())["traceEvents"]
                    if e.get("ph") == "X" and e.get("name", "").startswith("nt."))
    calls = sorted((s, e) for n, s, e in events if n == "nt.optimize")
    assert len(calls) == 4
    out = {}
    for i, solver in enumerate(("schur", "schur_cg")):
        lo, hi = calls[2 * i][0], calls[2 * i + 1][1]
        out[solver] = (results[solver], [ev for ev in events if lo <= ev[1] and ev[2] <= hi],
                       added[solver])
    return out


@pytest.mark.parametrize("solver", ["schur", "schur_cg"])
def test_spans_nest_under_optimize(runs, solver):
    """Every call is one ``nt.optimize`` span holding its ``nt.setup`` (a
    compile's ``nt.compile.*`` inside it), its pieces' spans and
    ``nt.finish``; one ``nt.piece.<piece>`` span per replay."""
    results, events, _ = runs[solver]
    calls = sorted((s, e) for n, s, e in events if n == "nt.optimize")
    assert len(calls) == 2

    def inside(outer, s, e):
        return any(a <= s and e <= b for a, b in outer)

    setups = [(s, e) for n, s, e in events if n == "nt.setup"]
    assert len(setups) == 2 and all(inside(calls, s, e) for s, e in setups)
    compile_spans = [(n, s, e) for n, s, e in events if n.startswith("nt.compile.")]
    assert {n for n, _, _ in compile_spans} == {"nt.compile.layout", "nt.compile.tables",
                                                "nt.compile.upload"}
    assert all(s >= calls[0][0] and e <= setups[0][1] for _, s, e in compile_spans)
    pieces = collections.Counter(n.removeprefix("nt.piece.") for n, s, e in events
                                 if n.startswith("nt.piece.") and inside(calls, s, e))
    assert pieces == sum((collections.Counter(r.replays) for r in results), collections.Counter())
    assert sum(n.startswith("nt.piece.") for n, _, _ in events) == sum(pieces.values())
    finish = [(s, e) for n, s, e in events if n == "nt.finish"]
    assert finish and all(inside(calls, s, e) for s, e in finish)


@pytest.mark.parametrize("solver", ["schur", "schur_cg"])
def test_counters_on_result_and_totals(runs, solver):
    """``replays["assemble"]`` is the iterations; direct, a ``trial`` replay
    per damped solve; implicit, one PCG count per solve and ⌈k/8⌉ chunk
    replays for a solve of k iterations; set-up phases on the compile, the
    ``setup`` span alone on the hit; the totals are the Results' sum."""
    results, _, added = runs[solver]
    for r in results:
        assert r.replays["assemble"] == r.num_iterations >= 2
        if solver == "schur":
            assert r.replays["trial"] == r.linear_solves and not r.pcg_iterations
        else:
            assert len(r.pcg_iterations) == r.linear_solves
            chunks = sum(max(1, math.ceil(k / linearsolver.CG_CHECK_EVERY))
                         for k in r.pcg_iterations)
            assert r.replays["pcg_chunk"] == chunks
            assert r.replays["pcg_setup"] == r.replays["pcg_finish"] == r.linear_solves
    assert set(results[0].setup_seconds) == SETUP_PHASES
    assert all(s > 0 for s in results[0].setup_seconds.values())
    assert set(results[1].setup_seconds) == {"setup"}
    want = collections.Counter(optimize_calls=2)
    for r in results:
        want.update(iterations=r.num_iterations, linear_solves=r.linear_solves,
                    pcg_solves=len(r.pcg_iterations), pcg_iterations=sum(r.pcg_iterations))
        want.update({"replays." + k: n for k, n in r.replays.items()})
        want.update({"setup." + k: s for k, s in r.setup_seconds.items()})
    assert set(added) == {k for k, v in want.items() if v}
    for k, v in added.items():
        assert v == pytest.approx(want[k], rel=1e-12), k


def test_lu_retake_counts_once(monkeypatch):
    """A Cholesky of the reduced system that fails once (its factor
    poisoned, its ``info`` a success) is taken again through LU: one
    ``trial_lu`` replay, and still one damped solve."""
    real, poisoned = torch.linalg.cholesky_ex, []

    def poison_once(a, *args, **kw):
        chol, info = real(a, *args, **kw)
        if a.dim() == 2 and not poisoned:
            poisoned.append(a.shape)
            chol = chol.clone()
            chol[3, 3] = float("nan")
            info = torch.zeros_like(info)
        return chol, info

    monkeypatch.setattr(torch.linalg, "cholesky_ex", poison_once)
    r = pt.optimize(_tiny_bal(), _opts("schur"))
    assert poisoned and r.replays["trial_lu"] == 1
    assert r.replays["trial"] == r.linear_solves


def test_no_record_function_without_a_profiler(monkeypatch):
    """With no profiler recording, a span is the shared null context and
    ``optimize`` creates no ``record_function``; a set-up span times
    itself all the same."""

    def refuse(*args, **kw):
        raise AssertionError("record_function without a profiler")

    monkeypatch.setattr(profiling, "_record_function", refuse)
    assert profiling.span("nt.a") is profiling.span("nt.b")
    r = pt.optimize(_tiny_bal(), _opts("schur"))
    assert set(r.setup_seconds) == SETUP_PHASES and r.replays["assemble"] >= 2
    with profiling.setup_record() as seconds, profiling.setup_span("nt.x") as s:
        pass
    assert seconds == {"x": s.seconds}
