"""The plain reference: its Jacobian, its solve, its TF32 control."""

import numpy as np
import pytest
import torch

from benchmark.data import bal_gen
from benchmark.reference import bal_ref


@pytest.fixture(scope="module")
def small():
    t = bal_gen.structure(20, 300, 3, 2.3)
    return t, bal_gen.measurements(t, 11, 1e-3)


def test_jacobian_matches_finite_differences(small):
    t, obs = small
    d = bal_ref.Data(t["cam_idx"], t["pt_idx"], obs, "cpu")
    cams, pts = d.values(t["cameras"], t["points"])
    r, jc, jp = d.linearize(cams, pts)
    for blocks, jac, idx, dof in ((cams, jc, d.cam_idx, 9), (pts, jp, d.pt_idx, 3)):
        for j in range(dof):
            eps = 1e-6 * max(1.0, float(blocks[:, j].abs().max()))
            moved = blocks.clone()
            moved[:, j] += eps
            c, p = (moved, pts) if dof == 9 else (cams, moved)
            fd = (bal_ref.project(c[d.cam_idx], p[d.pt_idx], bal_ref.F64) - d.obs - r) / eps
            scale = float(jac[:, :, j].abs().max())
            assert float((fd - jac[:, :, j]).abs().max()) <= 1e-5 * scale + 1e-9


def test_residual_is_the_published_camera_model(small):
    t, obs = small
    d = bal_ref.Data(t["cam_idx"], t["pt_idx"], obs, "cpu")
    pred = bal_ref.project(*(x[idx] for x, idx in zip(d.values(t["cameras"], t["points"]),
                                                      (d.cam_idx, d.pt_idx))), bal_ref.F64)
    assert np.abs(pred.numpy() - t["clean"]).max() < 1e-9


def test_solve_reaches_the_noise_floor(small):
    t, obs = small
    d = bal_ref.Data(t["cam_idx"], t["pt_idx"], obs, "cpu")
    start = bal_gen.start_values(t, 11, (1, 0), dict(points=0.05, rotation=1e-3, translation=5e-3))
    c_start = d.cost(*start)
    _, _, c = bal_ref.solve(d, *start)
    _, _, c_truth = bal_ref.solve(d, t["cameras"], t["points"])
    assert c < 1e-6 * c_start
    assert abs(c - c_truth) <= 1e-6 * c_truth
    # at most the noise's own cost at the truth
    assert c_truth <= d.cost(t["cameras"], t["points"])


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-12, 1.0 + 3 * 2**-12, -3.0e-5], dtype=torch.float32)
    r = bal_ref.round_tf32(x)
    assert r[0] == 1.0 and r[1] == x[1]  # representable in 10 bits
    assert r[2] == 1.0  # below half a TF32 ulp: down
    assert r[3] == 1.0 + 2**-10  # above half: up
    bits = r.view(torch.int32) & 0x1FFF
    assert int(bits.abs().sum()) == 0
    assert abs(float(r[4]) / -3.0e-5 - 1) < 2**-11
