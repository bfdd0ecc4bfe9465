"""No part of a run loads JAX or the JAX package; the reference loads
nothing of the program either."""

import shutil
import subprocess
import sys

from conftest import ROOT

from benchmark import harness


def test_whole_top_level_names():
    loaded = ["nllstpu_torch", "nllstpu_torch.core.optimize", "jaxtyping", "numpy",
              "nllstpu", "nllstpu.core", "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"]
    assert harness.forbidden_loaded(loaded) == sorted(
        ["nllstpu", "nllstpu.core", "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"])
    assert harness.forbidden_loaded(loaded, harness.FORBIDDEN_IN_REFERENCE)[-2:] == [
        "nllstpu_torch", "nllstpu_torch.core.optimize"]


def test_benchmark_sources_are_clean():
    assert harness.source_violations() == []


def test_a_planted_import_is_found(tmp_path):
    copy = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", copy, ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "metrics" / "planted.py").write_text("import jax.numpy as jnp\n")
    (copy / "reference" / "planted.py").write_text("from nllstpu_torch.models import bal\n")
    (copy / "kinds" / "fine.py").write_text("import nllstpu_torch\nimport jaxtyping\n")
    assert harness.source_violations(copy) == [
        ("metrics/planted.py", "jax.numpy"), ("reference/planted.py", "nllstpu_torch.models")]


def test_a_run_loads_no_jax():
    """Everything a run imports, loaded in a fresh interpreter: no module of
    JAX or the JAX package, the port among the modules."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness, trace, roofline, calibrate\n"
        "from benchmark.kinds import bal\n"
        "import nllstpu_torch, nllstpu_torch.models.bal, nllstpu_torch.core.optimize\n"
        "import pathlib\n"
        "for f in sorted((harness.HERE / 'metrics').glob('*.py')):\n"
        "    harness.load_module(f)\n"
        "assert 'nllstpu_torch' in sys.modules\n"
        "print(harness.forbidden_loaded(sys.modules))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.reference import bal_ref\nfrom benchmark.data import bal_gen\n"
            "from benchmark import harness\n"
            "print(harness.forbidden_loaded(sys.modules, harness.FORBIDDEN_IN_REFERENCE))\n"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
