"""A short run of each cell's code on the card, at a small size."""

import io
import json
import time

import pytest
from conftest import tiny_cell

from benchmark import harness
from benchmark.kinds import bal as kind


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_short_run_on_the_card(manifest, cuda_device, trace):
    out, err = io.StringIO(), io.StringIO()
    cell = tiny_cell(manifest, trace=trace, ncameras=64, npoints=4000)
    rc = harness.drive(cell, kind.Workload, 2**31 + 5, 2.0, trace, cuda_device,
                       time.perf_counter(), out, err)
    assert rc == 0, err.getvalue()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"]
