"""A cell, a configuration, a traffic mix and a per-layer metric added as
files and manifest entries only, on a copy: the harness finds and runs them."""

import json
import shutil
import subprocess
import sys

from conftest import ROOT

READER = '''"""Iterations per damped solve (a test's metric)."""

LAYER, UNIT, SOURCE, MOVES = "iterators (a test)", "ratio", "program_counter", "solve_s"


def read(run):
    solves = sum(s["linear_solves"] for s in run.solves)
    return sum(s["iterations"] for s in run.solves) / solves if solves else None
'''


def test_a_cell_added_as_files_runs(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((ROOT / "benchmark" / "configs" / "bal-trafalgar-257.json").read_text())
    conf.update(name="bal-tiny", ncameras=16, npoints=300, limits=dict(cost_gap=0.05, excess=0.05))
    (copy / "benchmark" / "configs" / "bal-tiny.json").write_text(json.dumps(conf))
    traffic = json.loads((ROOT / "benchmark" / "traffic" / "lm-f32.json").read_text())
    traffic["perturb"] = dict(points=0.02, rotation=5e-4, translation=2e-3)
    (copy / "benchmark" / "traffic" / "lm-gentle.json").write_text(json.dumps(traffic))
    (copy / "benchmark" / "metrics" / "iters_per_damped_solve.py").write_text(READER)
    manifest["configs"].append(dict(name="bal-tiny", source="a test", file="benchmark/configs/bal-tiny.json",
                                    reduced=["ncameras", "npoints"], why="a test"))
    manifest["workloads"].append(dict(name="tiny.gentle", config="bal-tiny", traffic="lm-gentle",
                                      chips=1, why="a test"))
    manifest["per_layer"].append(dict(name="iters_per_damped_solve", unit="ratio", better="higher",
                                      source="program_counter", layer="iterators (a test)",
                                      moves="solve_s", workloads=["tiny.gentle"]))
    (copy / "BENCHMARK.json").write_text(json.dumps(manifest))
    code = (
        "import sys, json, time; sys.path[:0] = [%r]; sys.path.append(%r)\n"
        "import torch\n"
        "from benchmark import harness\n"
        "m = json.loads((harness.ROOT / 'BENCHMARK.json').read_text())\n"
        "cell = harness.resolve(m, 'tiny.gentle', True)\n"
        "kind = harness.load_module(harness.HERE / 'kinds' / 'bal.py')\n"
        "sys.exit(harness.drive(cell, kind.Workload, 5, 1.0, True, torch.device('cpu'), time.perf_counter()))\n"
        % (str(copy), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         cwd=copy)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["attempted"] >= 1
    assert line["metrics"]["iters_per_damped_solve"]["unit"] == "ratio"
    assert "b2_roofline_pct" not in line["metrics"]  # another cell's metric
