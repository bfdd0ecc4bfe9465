"""The readers of the program's spans and counters, on a synthetic trace and
synthetic process totals; and None where the program has neither."""

import collections

import pytest
from conftest import ROOT

from benchmark import harness, trace

KERNEL = "void (anonymous namespace)::assemble_kernel<float, 2, 9, 3, false, true, false>(AsmArgs<float>)"


def span(name, start, end):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": float(start),
            "dur": float(end - start)}


def spans_trace(program_spans=True):
    # Window 0..100 us (two solves).  Device busy 12..18, 30..35, 62..64,
    # 80..90: idle 0..12, 18..30, 35..62, 64..80, 90..100 (77 us).
    # nt.optimize 5..45 and 55..95; pieces 10..20, 25..40 (a trial and its
    # read), 60..70.  Idle in pieces 2+2+5+5+2+6 = 22; in nt.optimize
    # 7+12+10+7+16+5 = 57, so 35 outside pieces; outside nt.optimize 20.
    events = [span("solve", 0, 50), span("solve", 50, 100),
              span("optimize", 4, 46), span("optimize", 54, 96)]
    if program_spans:
        events += [span("nt.optimize", 5, 45), span("nt.optimize", 55, 95),
                   span("nt.piece.assemble", 10, 20), span("nt.piece.trial", 25, 40),
                   span("nt.piece.trial", 60, 70)]
    events += [{"ph": "X", "cat": "kernel", "name": KERNEL, "ts": s, "dur": d}
               for s, d in ((12.0, 6.0), (30.0, 5.0), (62.0, 2.0), (80.0, 10.0))]
    events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 11.0,
                   "dur": 3.0})
    return trace.parse(events)


def run_with(trace_obj):
    cell = harness.Cell({}, {}, {}, [])
    solves = [dict(wall_s=0.1, iterations=i, linear_solves=i) for i in (3, 2, 4)]
    return harness.Run(cell, {}, setup_s=5.0, time_init_s=2.0, solves=solves, window_s=1.0,
                       peak_bytes=0, trace=trace_obj, profiled=2)


def reader(name):
    return harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py")


def test_idle_split_adds_up_to_the_window_idle():
    from benchmark.metrics._spans import idle_split

    t = spans_trace()
    split = idle_split(t)
    assert split["piece"] == pytest.approx(22e-6) and split["driver"] == pytest.approx(35e-6)
    assert split["outside"] == pytest.approx(20e-6) and split["pieces"] == 3
    idle = t.window_s - t.busy_s
    assert split["piece"] + split["driver"] + split["outside"] == pytest.approx(idle, rel=1e-12)
    # assemble 10..12, 18..20; trial 25..30, 35..40, 60..62, 64..70
    assert split["by_piece"] == pytest.approx({"assemble": 4e-6, "trial": 18e-6})
    # harness optimize outside nt.optimize: 4..5, 45..46, 54..55, 95..96
    assert split["harness"] == pytest.approx(4e-6)
    # profiled solves: 3 + 2 iterations
    run = run_with(t)
    assert reader("replay_idle_ms_per_iter").read(run) == pytest.approx(1e3 * 22e-6 / 5)
    assert reader("driver_idle_ms_per_iter").read(run) == pytest.approx(1e3 * 35e-6 / 5)


def test_counter_readers(monkeypatch):
    from nllstpu_torch.utils import profiling

    direct = collections.Counter({
        "optimize_calls": 4, "iterations": 36, "replays.assemble": 36, "replays.trial": 42,
        "replays.trial_lu": 6, "setup.setup": 11.0, "setup.compile.layout": 5.5,
        "setup.graph.warmup": 1.0, "setup.graph.capture": 0.5, "setup.graph.upload": 0.25})
    monkeypatch.setattr(profiling, "totals", lambda: direct)
    run = run_with(spans_trace())
    assert reader("lu_retakes_per_solve").read(run) == pytest.approx(6 / 4)
    assert reader("capture_s").read(run) == pytest.approx(1.75)
    assert reader("layout_s").read(run) == pytest.approx(5.5)
    assert reader("pcg_iters_per_trial").read(run) is None  # no PCG solve
    implicit = collections.Counter({"optimize_calls": 2, "replays.pcg_chunk": 30,
                                    "pcg_solves": 18, "pcg_iterations": 1800})
    monkeypatch.setattr(profiling, "totals", lambda: implicit)
    assert reader("pcg_iters_per_trial").read(run) == pytest.approx(100.0)
    assert reader("lu_retakes_per_solve").read(run) is None  # no direct trial
    assert reader("capture_s").read(run) is None and reader("layout_s").read(run) is None


NEW = ("replay_idle_ms_per_iter", "driver_idle_ms_per_iter", "capture_s", "layout_s",
       "lu_retakes_per_solve", "pcg_iters_per_trial")


@pytest.mark.parametrize("name", NEW)
def test_none_without_the_programs_spans_and_counters(monkeypatch, name):
    """A program without spans or totals (an earlier commit) gives None,
    and no error; so does a run without a trace."""
    from nllstpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "totals")
    assert reader(name).read(run_with(spans_trace(program_spans=False))) is None
    assert reader(name).read(run_with(None)) is None
