"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each or more; any failure raises and exits non-zero:

1. device  — the card's name and power limit (``nvidia-smi``); no CUDA
   device is a failure.
2. build   — compiles the port's CUDA kernels (``nllstpu_torch/ops/csrc``)
   with nvcc, one process per source, into ``.torch_ext/``.
3. B1      — kernel ``fused_obs_all`` against its plain PyTorch version on
   the pinhole bench problem's own inputs (128 cameras, 8192 landmarks, run
   length 14) and on a small case with duplicate cameras and dustbin slots.
4. B2      — kernel ``fused_obs_all_into`` against its plain version over
   every degree bucket of the two Snavely BAL problems (Ladybug-49 and
   bench-realistic, whose plan starts with a chunk bucket that the next
   bucket covers again): one whole assembly into zeroed buffers.
5. B3      — kernel ``reduce_s_damped`` against its plain version at
   wc = 768 (the pinhole bench W), wc = 441 (Ladybug-49's W), wc = 1152
   (bench-realistic's W) and wc = 1152 random, λ ∈ {0, 1e-2}.
6. main paths — Levenberg-Marquardt through ``nt.optimize`` in float32
   for 30 iterations, each with the launch counts set to 0 just before and
   read just after: the pinhole bench problem (B1 and B3), Ladybug-49 and
   bench-realistic (B2 and B3, no B1), each checked against the JAX
   package's CPU float32 reference costs (constants below).
7. timed loops — 10 iterations of the pinhole and Ladybug-49 loops,
   through the kernels and through their plain versions in turns, once
   more of each with CUDA events around every phase, and once through the
   kernels under ``torch.profiler`` (device busy time and idle share).  The cost reaches the
   float32 floor early; later iterations spend a varying number of damped
   trials on rounding noise, so compare per-call phase times, not
   single-run rates.

Tolerances: each kernel is compared with its plain version run in float64
on the same inputs.  The float64 instance of a kernel must agree to 1e-10
of the largest entry (the arithmetic is the same, only the summation order
differs); the float32 instance to 1e-5 for B1 and B2 (float atomics, short
sums).  B3's float32 outputs are compared after scaling by the float64
reference's diagonal (D S D and D rhs with D = diag(S)^-½, and each h_inv
block by its own diagonal), so that the small blocks of S, whose diagonal
spans seven decades on the BAL problems, are held as tightly as the
largest.  Each output is held to 1e-4, or to ten times the plain
version's own float32 error on that same output where that is larger (a
float32 closed-form inverse of an ill-conditioned 3x3 block loses digits
in either version).  The last lines are the card's name and power limit,
a JSON record of the kernels (one row per kernel and main-path shape,
with that path's launches) and the device JSON.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import subprocess
import time

import torch

NCAM, NLMK, VIS, NOISE, ITERS = 128, 8192, 0.1, 1e-3, 30
TIMED_ITERS = 10
WIDE_L = 8192  # landmarks of the random wc = 1152 reduction case
# The JAX package on the CPU in float32 (scripts/cpu_ref.json).
REF_START_COST = 67.33655548
REF_BEST_COST = 0.0920996218919754
#: Snavely BAL problems: ``make_realistic_bal`` arguments, then the JAX
#: package's CPU float32 start and best cost after 30 LM iterations, from
#: ``JAX_PLATFORMS=cpu NLLSTPU_PLATFORM=cpu python scripts/bal_realistic.py
#: {ladybug|bench} direct 30``, and the slack allowed on the best cost.
#: bench-realistic's reference still falls ~1e-4 relative per iteration at
#: iteration 30, so rounding may leave the port a step behind: its slack is
#: 1e-2.
BAL = {
    "Ladybug-49": (
        dict(ncameras=49, npoints=7776, seed=1, noise=1e-3, track_alpha=2.3),
        375133.9375, 0.022988244891166687, 1e-3,
    ),
    "bench-realistic": (
        dict(ncameras=128, npoints=8192, seed=1, noise=1e-3, track_alpha=1.6,
             max_track=96),
        937386.25, 0.07579956948757172, 1e-2,
    ),
}
TOL_F64 = 1e-10
TOL_B1_F32 = 1e-5
TOL_B3_F32 = 1e-4
#: Published H100 SXM peaks at 700 W: HBM bytes/s and float32 FLOP/s
#: outside the tensor cores (the kernels' arithmetic).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def rel_err(a, b) -> float:
    """max |a − b| over max |b| (b the float64 yardstick)."""
    b = b.double()
    return float((a.double() - b).abs().max() / b.abs().max())


def abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _inv_sqrt(diag):
    diag = diag.abs()
    return torch.where(diag > 0, diag.rsqrt(), torch.ones_like(diag))


def scaled_errs(out, ref) -> list:
    """B3's (s_sum, rhs, h_inv) against the float64 reference, each scaled
    by the reference's diagonal: D S D and D rhs with D = diag(S)^-½, and
    every h_inv block E h E with E its own diagonal^-½."""
    s, r, h = (t.double() for t in out)
    s0, r0, h0 = (t.double() for t in ref)
    d = _inv_sqrt(torch.diagonal(s0))
    e = _inv_sqrt(torch.diagonal(h0, dim1=0, dim2=1).T)  # [dl, L]
    ds, eh = d[:, None] * d[None, :], e[:, None, :] * e[None, :, :]
    return [rel_err(s * ds, s0 * ds), rel_err(r * d, r0 * d), rel_err(h * eh, h0 * eh)]


def time_ms(fn, reps=20) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events,
    after two warm-up calls)."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def assembly_flops(n_obs: int, dr_s: int, dl: int = 3, n: int = 2) -> int:
    """Operations of B1/B2 per real observation: g_l, the h_ll upper
    triangle, the W block, the a_rr upper triangle and b_r, each entry a
    length-n product, then ρ′· and + 2ρ″·g·g (2n + 5 operations)."""
    entries = dl * (dl + 1) // 2 + dl * dr_s + dr_s * (dr_s + 1) // 2
    return n_obs * (2 * dl + entries * (2 * n + 5) + 2 * dr_s)


def reduce_flops(L: int, dl: int, wc: int) -> int:
    """Operations of B3: Y = H⁻¹W, the upper triangle of S = YᵀW (diagonal
    included) and rhs = Yᵀg."""
    return 2 * dl * dl * L * wc + L * dl * wc * (wc + 1) + 2 * L * dl * wc


class PhaseTimer:
    """``IterCtx.phase`` hook: CUDA events around every phase."""

    def __init__(self):
        self.events = collections.defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        yield
        e.record()
        self.events[name].append((s, e))

    def totals(self):
        torch.cuda.synchronize()
        return {
            k: (len(v), sum(s.elapsed_time(e) for s, e in v))
            for k, v in self.events.items()
        }


def bench_problem(device):
    from nllstpu_torch.models.ba import make_pinhole_ba, perturb_ba

    problem, _, lmks = make_pinhole_ba(
        ncameras=NCAM, nlandmarks=NLMK, prop_visible=VIS, noise=NOISE,
        dtype=torch.float32, device=device,
    )
    perturb_ba(problem, lmks, 0.05, seed=5)
    return problem


def bal_problem(name, device):
    from nllstpu_torch.models.ba import perturb_ba
    from nllstpu_torch.models.bal import make_bal_problem, make_realistic_bal

    problem, _, points = make_bal_problem(
        make_realistic_bal(**BAL[name][0]), dtype=torch.float32, device=device
    )
    perturb_ba(problem, points, 0.05, seed=5)
    return problem


def bench_options():
    import nllstpu_torch as nt

    return nt.Options(
        max_iters=ITERS, rel_dcost=0.0, abs_dcost=0.0, dstep=1e-12,
        max_fails=1 << 30, max_time=float("inf"), solver="schur",
        schur_family=nt.Euclidean(3),
    )


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    import nllstpu_torch  # noqa: F401  (fails here when run outside the repository)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | count {torch.cuda.device_count()}", flush=True)
    return torch.device("cuda", 0), smi


def phase_build():
    from nllstpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    dt = time.perf_counter() - t0
    regs = [ln.strip() for ln in _build.BUILD_LOG.splitlines() if "registers" in ln]
    how = "compiled" if _build.BUILD_LOG else "reused the library in .torch_ext/"
    print(f"build: {dt:.2f} s, {how} | " + " ; ".join(regs), flush=True)


def check(name, got, ref, tol):
    errs = [rel_err(a, b) for a, b in zip(got, ref)]
    if not max(errs) <= tol:
        raise AssertionError(f"{name}: relative errors {errs} exceed {tol}")
    return errs


def phase_b1(device):
    from nllstpu_torch.core.optimize import compile_problem
    from nllstpu_torch.ops import fused_obs, schur

    problem = bench_problem(device)
    comp = compile_problem(problem, schur_family=bench_options().schur_family)
    (batch,), (fast,) = comp.batches, comp.schur_info.fast
    _, (args,) = schur.fused_inputs(
        batch, problem.stacked_variables(), comp.schur_info, fast, torch.float32
    )
    floats, ints = args[:4], args[4:]
    gen = torch.Generator().manual_seed(0)
    K, L, n_r = 5, 37, 11
    small = [
        torch.randn(2, 9, K, L, generator=gen, dtype=torch.float64),
        torch.randn(9, K, L, generator=gen, dtype=torch.float64),
        torch.rand(K, L, generator=gen, dtype=torch.float64) + 0.05,
        -0.2 * torch.rand(K, L, generator=gen, dtype=torch.float64),
    ]
    vc = torch.randint(0, n_r, (K, L), generator=gen, dtype=torch.int32)
    vc[1] = vc[0]  # duplicate cameras within every run
    vc[K - 1, ::3] = n_r  # dustbin slots with zero weights
    small[2][K - 1, ::3] = 0.0
    small[3][K - 1, ::3] = 0.0
    cases = {
        f"bench K={args[0].shape[2]} L={args[0].shape[3]}": (floats, ints),
        "small dup+dustbin": (small, (vc, n_r, 6, 3, 6)),
    }
    main_abs = None
    for label, (fl, it) in cases.items():
        fl = [t.to(device) for t in fl]
        it = (it[0].to(device),) + tuple(it[1:])
        ref = fused_obs.fused_obs_all_reference(*[t.double() for t in fl], *it)
        out64 = fused_obs.fused_obs_all(*[t.double() for t in fl], *it)
        out32 = fused_obs.fused_obs_all(*[t.float() for t in fl], *it)
        torch.cuda.synchronize()
        e64 = check(f"B1 f64 {label}", out64, ref, TOL_F64)
        e32 = check(f"B1 f32 {label}", out32, ref, TOL_B1_F32)
        if main_abs is None:
            main_abs = max(abs_err(a, b) for a, b in zip(out32, ref))
        print(f"B1 {label}: rel err h_ll/g_l/w/ab f64 {['%.2e' % e for e in e64]}"
              f" f32 {['%.2e' % e for e in e32]}", flush=True)
    f32 = [t.float() for t in floats]
    ms = time_ms(lambda: fused_obs.fused_obs_all(*f32, *ints))
    plain_ms = time_ms(lambda: fused_obs.fused_obs_all_reference(*f32, *ints))
    n_r, dr_s, dl = ints[1:4]
    outs = fused_obs.fused_obs_all(*f32, *ints)
    b = bound(nbytes(*f32, ints[0], *outs), assembly_flops(batch.n, dr_s, dl))
    print(f"B1 bench time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound"
          f" {b['bound_ms']:.4f} ms ({b['bound_by']})", flush=True)
    sys_ = comp.assemble(problem.stacked_variables())[1]
    return dict(max_abs_err=main_abs, ms=ms, plain_ms=plain_ms, **b), sys_


def _assemble_buckets(fn, buckets, args, dtype, L):
    """One bucketed assembly of ``L`` landmarks through ``fn`` (B2 or its
    plain version): buffers zeroed once, one call per bucket in plan
    order."""
    from nllstpu_torch.ops import fused_obs

    jac, _, _, _, _, n_r, dr_s, dl, _ = args[0]
    bufs = fused_obs.zero_buffers(L, n_r, dr_s, dl, dtype, jac.device)
    for (l0, _, _, _), a in zip(buckets, args):
        fn(*[t.to(dtype) for t in a[:4]], a[4], *bufs, l0, *a[5:])
    return bufs


def phase_b2(device):
    """B2 against its plain version over every bucket of both BAL problems;
    times per whole assembly.  Returns a record per problem and the float32
    systems for B3."""
    from nllstpu_torch.core.optimize import compile_problem
    from nllstpu_torch.ops import fused_obs, schur

    records, systems = {}, {}
    for name in BAL:
        problem = bal_problem(name, device)
        comp = compile_problem(problem, schur_family=bench_options().schur_family)
        (batch,), (fast,) = comp.batches, comp.schur_info.fast
        _, args = schur.fused_inputs(
            batch, problem.stacked_variables(), comp.schur_info, fast, torch.float32
        )
        buckets, L = fast.buckets, comp.schur_info.num_elim
        kern, plain = fused_obs.fused_obs_all_into, fused_obs.fused_obs_all_into_reference
        ref = _assemble_buckets(plain, buckets, args, torch.float64, L)
        out64 = _assemble_buckets(kern, buckets, args, torch.float64, L)
        out32 = _assemble_buckets(kern, buckets, args, torch.float32, L)
        torch.cuda.synchronize()
        e64 = check(f"B2 f64 {name}", out64, ref, TOL_F64)
        e32 = check(f"B2 f32 {name}", out32, ref, TOL_B1_F32)
        print(f"B2 {name} ({len(buckets)} buckets {list(buckets)}): rel err "
              f"h_ll/g_l/w/ab f64 {['%.2e' % e for e in e64]} f32 "
              f"{['%.2e' % e for e in e32]}", flush=True)
        ms = time_ms(lambda: _assemble_buckets(kern, buckets, args, torch.float32, L))
        plain_ms = time_ms(lambda: _assemble_buckets(plain, buckets, args, torch.float32, L))
        dr_s, dl = args[0][6], args[0][7]
        b = bound(
            nbytes(*(t for a in args for t in a[:5]), *out32),
            assembly_flops(batch.n, dr_s, dl),
        )
        print(f"B2 {name} time per assembly ({batch.n} observations, W "
              f"{tuple(out32[2].shape)}): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})",
              flush=True)
        records[name] = dict(max_abs_err=max(abs_err(a, r) for a, r in zip(out32, ref)),
                             ms=ms, plain_ms=plain_ms, **b)
        systems[name] = comp.assemble(problem.stacked_variables())[1]
        del ref, out64, out32, args
    return records, systems


def phase_b3(device, systems):
    """B3 against its plain version on each main path's own system (keyed
    by the path) and on a random wc = 1152 case; a record per path."""
    from nllstpu_torch.ops import schur_reduce

    gen = torch.Generator().manual_seed(1)
    L, dl, wc = WIDE_L, 3, 1152
    a = torch.randn(dl, dl, L, generator=gen, dtype=torch.float64)
    wide = (
        torch.randn(L, dl, wc, generator=gen, dtype=torch.float64),
        torch.einsum("del,fel->dfl", a, a) + 2.0 * torch.eye(dl, dtype=torch.float64)[:, :, None],
        torch.randn(dl, L, generator=gen, dtype=torch.float64),
    )
    cases = {name: (s[4], s[2], s[3]) for name, s in systems.items()}
    cases["random"] = wide
    records = {}
    for name, inputs in cases.items():
        inputs = [t.to(device) for t in inputs]
        label = f"wc={inputs[0].shape[2]} {name}"
        max_abs = 0.0
        for lam in (0.0, 1e-2):
            ref = schur_reduce.reduce_s_damped_reference(*[t.double() for t in inputs], lam)
            plain32 = schur_reduce.reduce_s_damped_reference(*[t.float() for t in inputs], lam)
            out64 = schur_reduce.reduce_s_damped(*[t.double() for t in inputs], lam)
            out32 = schur_reduce.reduce_s_damped(*[t.float() for t in inputs], lam)
            torch.cuda.synchronize()
            e64 = check(f"B3 f64 {label} lam={lam}", out64, ref, TOL_F64)
            e32, p32 = scaled_errs(out32, ref), scaled_errs(plain32, ref)
            tol32 = [max(TOL_B3_F32, 10 * p) for p in p32]
            if not all(e <= t for e, t in zip(e32, tol32)):
                raise AssertionError(
                    f"B3 f32 {label} lam={lam}: scaled errors s_sum/rhs/h_inv {e32}"
                    f" exceed {tol32}"
                )
            max_abs = max(max_abs, *(abs_err(x, y) for x, y in zip(out32, ref)))
            print(f"B3 {label} lam={lam}: rel err s_sum/rhs/h_inv f64"
                  f" {['%.2e' % e for e in e64]}; f32 scaled by diag, kernel"
                  f" {['%.2e' % e for e in e32]} plain {['%.2e' % e for e in p32]}"
                  f" tolerance {['%.2e' % t for t in tol32]}", flush=True)
        if name == "random":
            continue
        f32 = [t.float() for t in inputs]
        ms = time_ms(lambda: schur_reduce.reduce_s_damped(*f32, 1e-2))
        plain_ms = time_ms(lambda: schur_reduce.reduce_s_damped_reference(*f32, 1e-2))
        Lw, dlw, wcw = f32[0].shape
        outs = schur_reduce.reduce_s_damped(*f32, 1e-2)
        b = bound(nbytes(*f32, *outs), reduce_flops(Lw, dlw, wcw))
        print(f"B3 {label} time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})", flush=True)
        records[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, **b)
    return records


def _reset_counts():
    from nllstpu_torch.ops import fused_obs, schur_reduce

    fused_obs.LAUNCHES = 0
    fused_obs.INTO_LAUNCHES = 0
    schur_reduce.LAUNCHES = 0


def _read_counts():
    from nllstpu_torch.ops import fused_obs, schur_reduce

    return {
        "fused_obs_all": fused_obs.LAUNCHES,
        "fused_obs_all_into": fused_obs.INTO_LAUNCHES,
        "reduce_s_damped": schur_reduce.LAUNCHES,
    }


def phase_main(label, problem, start_ref, best_ref, slack, needs, never=()):
    """The user's entry point on one problem, with the launch counts set to
    0 just before and read just after.  ``needs`` are the kernels the path
    must launch, ``never`` those it must not."""
    import nllstpu_torch as nt

    _reset_counts()
    result = nt.optimize(problem, bench_options())
    torch.cuda.synchronize()
    launches = _read_counts()
    print(f"main path {label}: {result.num_iterations} iterations, start cost "
          f"{result.start_cost!r}, best cost {result.best_cost!r}, "
          f"{result.linear_solves} damped solves, launches {launches}", flush=True)
    if not all(launches[k] > 0 for k in needs) or any(launches[k] for k in never):
        raise AssertionError(
            f"{label}: launches {launches}; needed {needs}, never {never}"
        )
    if abs(result.start_cost - start_ref) > 1e-4 * start_ref:
        raise AssertionError(f"{label}: start cost {result.start_cost} != {start_ref}")
    if not result.best_cost <= best_ref * (1 + slack):
        raise AssertionError(
            f"{label}: best cost {result.best_cost} > {best_ref}·(1+{slack})"
        )
    final = problem.stacked_variables()
    if not all(torch.isfinite(v).all() for v in final.values()):
        raise AssertionError(f"{label}: non-finite final variables")
    return launches


def phase_timed(label, problem, plain: bool, phases: bool):
    """The same loop for ``TIMED_ITERS`` iterations, through the kernels or
    their plain versions; with ``phases``, CUDA events around every
    phase."""
    from nllstpu_torch.core.optimize import compile_problem, run_loop

    opts = dataclasses.replace(bench_options(), max_iters=TIMED_ITERS)
    comp = compile_problem(problem, schur_family=opts.schur_family, plain=plain)
    vars0 = problem.stacked_variables()
    timer = PhaseTimer() if phases else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final = run_loop(comp.assemble, comp.cost, comp.ctx(phase=timer), opts, vars0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rate = final["iternum"] / wall
    line = (
        f"LM {label} {'plain' if plain else 'kernels'}"
        f"{' (phase events on)' if phases else ''}: "
        f"{final['iternum']} iterations, {final['nsolve']} damped solves in "
        f"{wall * 1e3:.3f} ms = {rate:.3f} it/s, best cost "
        f"{float(final['bestcost'])!r}"
    )
    if phases:
        line += " | " + ", ".join(
            f"{k} {n}x {ms / n:.4f} ms/call" for k, (n, ms) in timer.totals().items()
        )
    print(line, flush=True)
    return rate


def phase_profile(label, problem):
    """The 10-iteration loop through the kernels under ``torch.profiler``:
    wall time, the summed device time of every kernel, the device's idle
    share, and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from nllstpu_torch.core.optimize import compile_problem, run_loop

    opts = dataclasses.replace(bench_options(), max_iters=TIMED_ITERS)
    comp = compile_problem(problem, schur_family=opts.schur_family)
    vars0 = problem.stacked_variables()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_loop(comp.assemble, comp.cost, comp.ctx(), opts, vars0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [
        (e.key, e.count, e.self_device_time_total / 1e3)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy_ms = sum(ms for _, _, ms in kernels)
    top = sorted(kernels, key=lambda k: -k[2])[:6]
    print(f"profile {label}, {TIMED_ITERS} iterations through the kernels: wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%, {sum(n for _, n, _ in kernels)}"
          " kernel launches | " + "; ".join(
              f"{name[:60]} {n}x {ms:.3f} ms" for name, n, ms in top), flush=True)


def main():
    device, smi = phase_device()
    phase_build()
    b1, bench_sys = phase_b1(device)
    b2, bal_systems = phase_b2(device)
    b3 = phase_b3(device, {"pinhole bench": bench_sys, **bal_systems})
    del bench_sys, bal_systems
    launches = {"pinhole bench": phase_main(
        "pinhole bench", bench_problem(device), REF_START_COST, REF_BEST_COST, 1e-3,
        needs=("fused_obs_all", "reduce_s_damped"),
    )}
    for name, (_, start_ref, best_ref, slack) in BAL.items():
        launches[name] = phase_main(
            name, bal_problem(name, device), start_ref, best_ref, slack,
            needs=("fused_obs_all_into", "reduce_s_damped"), never=("fused_obs_all",),
        )
    # Kernels and plain versions in turns, then one run of each with
    # per-phase events (the events cost host time, so rates come from the
    # runs without them).
    for label, make in (("pinhole bench", bench_problem),
                        ("Ladybug-49", lambda d: bal_problem("Ladybug-49", d))):
        for plain in (False, True, True, False):
            phase_timed(label, make(device), plain=plain, phases=False)
        for plain in (False, True):
            phase_timed(label, make(device), plain=plain, phases=True)
        phase_profile(label, make(device))
    # One row per kernel and main-path shape: the times are that shape's,
    # the launches those of that shape's main-path run.
    src = "nllstpu_torch/ops/csrc/"
    rows = [("fused_obs_all", "fused_obs.cu", "fused_obs.py:264", {"pinhole bench": b1}),
            ("fused_obs_all_into", "fused_obs.cu", "fused_obs.py:397", b2),
            ("reduce_s_damped", "schur_reduce.cu", "schur_reduce.py:505", b3)]
    kernels = [
        dict(name=name, shape=shape, route="cuda", source=src + source,
             replaces="nllstpu/ops/pallas/" + replaces,
             launches=launches[shape][name], **record, library_ms=None)
        for name, source, replaces, records in rows
        for shape, record in records.items()
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
