"""The control (the reference in TF32, ``kinds/bal.Control``) put in the
program's place comes out not correct from the harness's own judgment, at
a size a CPU test holds, where the program's sound run comes out correct."""

import io
import json
import time

import pytest
import torch
from conftest import tiny_cell

from benchmark import harness
from benchmark.kinds import bal as kind


def drive(cell, cls):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.drive(cell, cls, 2**31 + 21, 0.0, False, torch.device("cpu"),
                       time.perf_counter(), out, err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", ["trafalgar-257.lm-f32", "dubrovnik-356.lm-f32"])
def test_control_is_not_correct(manifest, workload):
    cell = tiny_cell(manifest, workload, traffic=dict(start_pool=2))
    program, control = drive(cell, kind.Workload), drive(cell, kind.Control)
    assert program["correct"], program["checks"]
    assert not control["correct"], control["checks"]
    assert control["failed"] >= 1 and control["attempted"] == program["attempted"] == 2
    # the control's numbers stand well apart from the program's
    assert any(control["checks"][k]["value"] > 3 * program["checks"][k]["value"]
               for k in control["checks"])
