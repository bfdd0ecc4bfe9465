"""Drive one benchmark cell: set-up, the measured window, the check, the line.

Nothing here belongs to one cell.  The cell's entry in ``BENCHMARK.json``
names its configuration and its traffic mix; the configuration's file
(``configs/<name>.json``) names its kind, whose module (``kinds/<kind>.py``)
builds the problem, runs one solve and judges the solves against the plain
reference; the traffic file (``traffic/<mix>.json``) holds the solver's
options and the start values' scales; each metric is read by its own reader
(``metrics/<metric>.py``).  A later cell, configuration or metric is added as
files and manifest entries.

A run: set-up (imports, the data made from the seed, the problem built,
compiled and captured through the first solves) until the first timed solve;
then one client solves back to back, each solve from its own start values,
until ``--seconds`` have passed, finishing the cycle of start values in
flight (a kind's ``cycle``: every run does the same solves); then the
peak memory is read, the program's state freed and every solve of the
window judged.  With ``--trace 1`` the window's first whole cycles, at least
``trace_seconds`` of it, run under ``torch.profiler`` and the per-layer
metrics are reported instead of the end-to-end ones.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import gc
import importlib.util
import json
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level modules no part of a run may load: JAX and the JAX package.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "nllstpu"})
#: The plain reference may not load the program either.
FORBIDDEN_IN_REFERENCE = FORBIDDEN | {"nllstpu_torch"}


def top_level(module: str) -> str:
    return module.split(".", 1)[0]


def forbidden_loaded(modules, forbidden=FORBIDDEN) -> list:
    """The names in ``modules`` whose whole top-level name is forbidden."""
    return sorted(m for m in modules if top_level(m) in forbidden)


def imported_names(path: pathlib.Path) -> set:
    """Every module a Python source imports (absolute names)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def source_violations(root: pathlib.Path = HERE) -> list:
    """``(file, module)`` for each forbidden import in the benchmark's
    sources: JAX and the JAX package anywhere, the program as well in
    ``reference/``."""
    bad = []
    for path in sorted(root.rglob("*.py")):
        forbidden = FORBIDDEN_IN_REFERENCE if "reference" in path.relative_to(root).parts else FORBIDDEN
        bad += [(str(path.relative_to(root)), m) for m in sorted(imported_names(path))
                if top_level(m) in forbidden]
    return bad


def load_module(path: pathlib.Path):
    """The module in file ``path`` (a reader, a kind), loaded by its path."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.parent.name}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    entry: dict  # the workload's entry in the manifest
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    metrics: list  # the manifest's entries of the metrics this run reports


def resolve(manifest: dict, workload: str, trace: bool, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``workload`` of ``manifest``: its files, read, and the
    metrics it reports (end-to-end, or per-layer with ``trace``)."""
    entry = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text())
    group = manifest["per_layer" if trace else "end_to_end"]
    metrics = [m for m in group if workload in m.get("workloads", [workload])]
    return Cell(entry, config, traffic, metrics)


@dataclasses.dataclass
class Run:
    """What the readers read: the cell, its shapes, the set-up, every solve
    of the window (dicts with ``wall_s``, ``iterations``, ``linear_solves``,
    costs), the window's length, the peak memory and, traced, the trace of
    the first ``profiled`` solves."""

    cell: Cell
    shapes: dict
    setup_s: float
    time_init_s: float
    solves: list
    window_s: float
    peak_bytes: int
    trace: object = None
    profiled: int = 0


def read_metrics(run: Run) -> dict:
    """Each metric's reader over ``run``; a reader that finds nothing to
    read returns None and its metric is left out."""
    out = {}
    for m in run.cell.metrics:
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def card_note() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them, beside
    the peaks the rooflines use."""
    from benchmark import roofline

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi not read ({type(e).__name__})"
    return (f"card: {smi or 'nvidia-smi gave nothing'}; peaks {roofline.HBM_BYTES_PER_S / 1e12} TB/s, "
            f"{roofline.FP32_FLOP_PER_S / 1e12} TFLOP/s float32 (H100 SXM at 700 W)")


def measure(cell: Cell, workload, seconds: float, trace: bool, start: float):
    """Warm-up (ending set-up), then the window, which ends on a whole cycle
    of the kind's start values once ``seconds`` have passed; returns ``(setup_s,
    time_init_s, solves, window_s, profiler, profiled)``: with ``trace``
    the profiler holds the first ``profiled`` solves of the window, whole
    cycles of at least ``trace_seconds``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    traffic = cell.traffic
    time_init = None
    for i in range(traffic["warmup_solves"]):
        rec = workload.solve(("warmup", i))
        time_init = rec["time_init"] if time_init is None else time_init
    workload.synchronize()
    setup_s = time.perf_counter() - start
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if trace else None
    profiled, solves = 0, []
    if prof is not None:
        prof.start()
    t0 = time.perf_counter()
    cycle = getattr(workload, "cycle", 1)
    while not solves or time.perf_counter() - t0 < seconds or len(solves) % cycle:
        with record_function("solve"):
            solves.append(workload.solve(("window", len(solves))))
        if (prof is not None and not profiled and len(solves) % cycle == 0
                and time.perf_counter() - t0 >= traffic["trace_seconds"]):
            workload.synchronize()
            prof.stop()
            profiled = len(solves)
    window_s = time.perf_counter() - t0
    if prof is not None and not profiled:
        workload.synchronize()
        prof.stop()
        profiled = len(solves)
    return setup_s, time_init, solves, window_s, prof, profiled


def drive(cell: Cell, workload_cls, seed: int, seconds: float, trace: bool, device, start: float,
          out=None, err=None) -> int:
    """One run of ``cell`` on ``device`` (the part after the look for a
    card); prints the result line on ``out``.  Returns the exit code."""
    from benchmark import trace as tracing

    out, err = out or sys.stdout, err or sys.stderr
    workload = workload_cls(cell.config, cell.traffic, seed, device)
    setup_s, time_init, solves, window_s, prof, profiled = measure(
        cell, workload, seconds, trace, start)
    peak = workload.peak_bytes()
    loaded = forbidden_loaded(sys.modules)
    if loaded:
        print(f"refused: modules of JAX or the JAX package loaded: {loaded}", file=err)
        return 3
    parsed = tracing.read(prof) if prof is not None else None
    shapes = workload.shapes()
    workload.release()
    del prof
    gc.collect()
    checks, failed = workload.judge(solves)
    run = Run(cell, shapes, setup_s, time_init, solves, window_s, peak, parsed, profiled)
    metrics = read_metrics(run)
    correct = bool(solves) and failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    if workload.device.type == "cuda":
        print(card_note(), file=err)
    iters = sorted(s["iterations"] for s in solves)
    if iters:
        print(f"solves {len(iters)}: LM iterations {iters[0]}..{iters[-1]} (median "
              f"{iters[len(iters) // 2]}), termination bits "
              f"{sorted({s['termination'] for s in solves})}", file=err)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=err)
    line = {"correct": bool(correct), "attempted": len(solves), "failed": failed,
            "metrics": metrics, "device": workload.device_info(peak)}
    if parsed is not None:
        line["device"].update(busy_s=parsed.busy_s, window_s=parsed.window_s)
        line["breakdown"] = parsed.breakdown()
    line["checks"] = checks
    print(json.dumps(line), file=out, flush=True)
    return 0


def main(argv, start: float) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    bad = source_violations()
    if bad:
        print(f"refused: forbidden imports in the benchmark's sources: {bad}", file=sys.stderr)
        return 3
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = resolve(manifest, args.workload, bool(args.trace))
    import torch

    need = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"refused: the cell needs {need} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    kind = load_module(HERE / "kinds" / f"{cell.config['kind']}.py")
    return drive(cell, kind.Workload, args.seed, args.seconds, bool(args.trace),
                 torch.device("cuda", 0), start)
