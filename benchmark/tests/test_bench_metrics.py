"""The metric arithmetic: window rate, tail, idle share, roofline counts,
and the readers on synthetic runs."""

import numpy as np
import pytest
from conftest import ROOT

from benchmark import harness, roofline, trace

KERNEL_B2 = "void (anonymous namespace)::assemble_kernel<float, 2, 9, 3, false, true, false>(AsmArgs<float>)"
KERNEL_B3 = "void (anonymous namespace)::incidence_kernel<float, 3, false, true>(float const*)"
KERNEL_LINKS = "void (anonymous namespace)::reduce_links_kernel<float, 3, 9, true>(float const*)"
KERNEL_LIB = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float> >(int)"
KERNEL_LU = "void kernel<getrf_wo_pivot_params_<float, 0, 256> >(int, int, void*)"


def synthetic_trace():
    # window 0..100 us; device busy 10..30, 20..40 (overlap), 60..70
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "solve", "ts": 0.0, "dur": 50.0},
        {"ph": "X", "cat": "user_annotation", "name": "solve", "ts": 50.0, "dur": 50.0},
        {"ph": "X", "cat": "kernel", "name": KERNEL_B2, "ts": 10.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": KERNEL_B3, "ts": 20.0, "dur": 20.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 60.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": KERNEL_LIB, "ts": 95.0, "dur": 20.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 42.0, "dur": 16.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 71.0, "dur": 5.0},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1.0},
    ]
    return trace.parse(events)


def test_idle_share_is_the_union_of_device_intervals():
    t = synthetic_trace()
    assert t.window == (0.0, 100.0)
    assert t.busy_s == pytest.approx((30 + 10 + 5) * 1e-6)  # 10..40, 60..70, 95..100 (clipped)
    assert t.gaps() == [(0.0, 10.0), (40.0, 60.0), (70.0, 95.0)]
    b = t.breakdown()
    names = dict(b["idle_gaps"])
    assert names["cudaGraphLaunch"] == pytest.approx(20e-6)
    assert names["solve"] == pytest.approx(35e-6)  # no operator over 0..10 and 70..95
    assert b["device_ops"][0][0].endswith("assemble_kernel<float, 2, 9, 3, false, true, false>")


def run_with(trace_obj=None, solves=None, **kw):
    cell = harness.Cell({}, {}, {}, [])
    shapes = dict(n_obs=1000, n_cams=10, n_pts=300, n=2, dr=9, dl=3,
                  tracks=np.full(300, 3))
    solves = solves or [dict(wall_s=w, iterations=i, linear_solves=2 * i)
                        for w, i in [(0.2, 10), (0.3, 12), (0.25, 11), (1.0, 30)]]
    base = dict(setup_s=5.0, time_init_s=2.0, window_s=2.0, peak_bytes=2**30)
    base.update(kw)
    return harness.Run(cell, shapes, solves=solves, trace=trace_obj, **base)


def reader(name):
    return harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py")


def test_window_rate_and_tail():
    run = run_with()
    assert reader("solve_s").read(run) == pytest.approx(2.0 / 4)
    walls = [0.2, 0.3, 0.25, 1.0] + [0.1] * 16
    run = run_with(solves=[dict(wall_s=w, iterations=1, linear_solves=1) for w in walls])
    p90 = reader("solve_s_p90").read(run)
    assert p90 == pytest.approx(0.25 + 0.1 * 0.05)  # inclusive: 0.9 of the way over 20 sorted
    assert reader("peak_mem_gib").read(run) == 1.0
    assert reader("lm_iters_per_solve").read(run_with()) == pytest.approx(63 / 4)
    assert reader("iter_ms").read(run_with()) == pytest.approx(1e3 * 1.75 / 63)


def test_trace_readers():
    t = synthetic_trace()
    run = run_with(t, profiled=2)
    assert reader("device_idle_pct").read(run) == pytest.approx(100 * (1 - 45 / 100))
    b2 = reader("b2_roofline_pct").read(run)
    assert b2 == pytest.approx(100 * roofline.bound_s(*roofline.assembly_work(run.shapes)) / 20e-6)
    b3 = reader("b3_roofline_pct").read(run)
    assert b3 == pytest.approx(100 * roofline.bound_s(*roofline.reduction_work(run.shapes)) / 20e-6)
    lib = reader("library_ms_per_iter").read(run)
    assert lib == pytest.approx(1e3 * 20e-6 / 22)
    # nothing to read: left out
    assert reader("reduced_factor_ms").read(run) is None
    assert reader("b6_ms_per_iter").read(run) is None
    assert reader("b2_roofline_pct").read(run_with()) is None


def test_roofline_counts_by_hand():
    shapes = dict(n_obs=2, n_cams=1, n_pts=1, n=2, dr=9, dl=3, tracks=np.array([2]))
    nbytes, ops = roofline.assembly_work(shapes)
    # in: 2 obs x ((2*12 + 2 + 2) floats + 2 ints); out: h_ll+g_l 12, W 2x27, a_rr+b_r 90
    assert nbytes == 2 * (28 * 4 + 8) + 4 * (12 + 54 + 90)
    assert ops == roofline.assembly_flops(2, 9, 3, 2) == 2 * (6 + (6 + 27 + 45) * 9 + 18)
    nbytes, ops = roofline.reduction_work(shapes)
    held = 2 * 9
    assert nbytes == (held * 3 + 9 + 3) * 4 + 2 * 8 + (81 + 9 + 9) * 4
    assert ops == 2 * 3 * (2 * 45 + 81) + 2 * 9 * held + 2 * 3 * held
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)


def test_kernel_names():
    from benchmark.metrics._kernels import port_kernel

    assert port_kernel(KERNEL_B2, "assemble_kernel")
    assert not port_kernel(KERNEL_B2, "assemble_any_kernel")
    assert port_kernel(KERNEL_LINKS) and not port_kernel(KERNEL_LIB) and not port_kernel(KERNEL_LU)
    assert trace.short_name(KERNEL_LINKS) == KERNEL_LINKS.split("(float const*)")[0]
