"""The benchmark's own tests: CPU unless marked ``cuda``.

Run them from the repository root: ``python -m pytest benchmark/tests -q``
(the ``cuda`` cases on a card: ``python -m pytest benchmark/tests -q -m cuda``).
"""

import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_cell(manifest, workload="trafalgar-257.lm-f32", trace=False, options=None,
              traffic=None, **sizes):
    """A manifest cell cut to a size a CPU test holds (its configuration's
    camera and point counts replaced; 64 cameras keep the tracks' arcs), the
    traffic's solver options and other keys overridden where given."""
    from benchmark import harness

    cell = harness.resolve(manifest, workload, trace)
    cell.config = dict(cell.config, **(sizes or dict(ncameras=64, npoints=1500)))
    cell.traffic = dict(cell.traffic, **(traffic or {}))
    if options:
        cell.traffic["options"] = dict(cell.traffic["options"], **options)
    return cell
