"""The generator: deterministic by seed, the published sizes."""

import json

import numpy as np
import pytest
from conftest import ROOT

from benchmark.data import bal_gen

PERTURB = dict(points=0.05, rotation=1e-3, translation=5e-3)


def test_structure_is_fixed_by_its_seed():
    a, b = bal_gen.structure(30, 500, 4, 2.3), bal_gen.structure(30, 500, 4, 2.3)
    for k in a:
        assert np.array_equal(a[k], b[k])
    c = bal_gen.structure(30, 500, 5, 2.3)
    assert not np.array_equal(a["cam_idx"], c["cam_idx"])


def test_run_seed_draws_noise_and_starts():
    t = bal_gen.structure(30, 500, 4, 2.3)
    big = 2**31 + 977
    assert np.array_equal(bal_gen.measurements(t, big, 1e-3), bal_gen.measurements(t, big, 1e-3))
    assert not np.array_equal(bal_gen.measurements(t, big, 1e-3), bal_gen.measurements(t, 7, 1e-3))
    s1, s2 = bal_gen.start_values(t, big, (1, 3), PERTURB), bal_gen.start_values(t, big, (1, 3), PERTURB)
    assert all(np.array_equal(x, y) for x, y in zip(s1, s2))
    other = bal_gen.start_values(t, big, (1, 4), PERTURB)
    assert not np.array_equal(s1[1], other[1])
    # intrinsics start at the truth
    assert np.array_equal(s1[0][:, 6:], t["cameras"][:, 6:])


def test_tracks_are_distinct_cameras_sorted_by_point():
    t = bal_gen.structure(40, 800, 2, 2.0)
    assert np.all(np.diff(t["pt_idx"]) >= 0)
    pairs = t["pt_idx"].astype(np.int64) * 1000 + t["cam_idx"]
    assert np.unique(pairs).shape[0] == pairs.shape[0]
    assert np.abs(t["clean"] - bal_gen.project_ground_truth(
        t["cameras"], t["points"], t["cam_idx"], t["pt_idx"])).max() == 0.0


@pytest.mark.parametrize("name", ["bal-trafalgar-257", "bal-dubrovnik-356"])
def test_published_observation_counts(name):
    conf = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    t = bal_gen.structure(conf["ncameras"], conf["npoints"], conf["structure_seed"],
                          conf["track_alpha"], conf["max_track"], conf["cam_skew"])
    n = t["cam_idx"].shape[0]
    assert n == conf["generated_observations"]
    assert abs(n / conf["nobservations"] - 1) < 0.01
    assert t["cameras"].shape[0] == conf["ncameras"] and t["points"].shape[0] == conf["npoints"]


def test_window_order_is_drawn_from_the_seed(manifest):
    import torch
    from conftest import tiny_cell

    from benchmark.kinds import bal as kind

    cell = tiny_cell(manifest)
    pool = cell.traffic["start_pool"]
    a = kind.Workload(cell.config, cell.traffic, 2**31 + 3, torch.device("cpu"))
    b = kind.Workload(cell.config, cell.traffic, 2**31 + 3, torch.device("cpu"))
    c = kind.Workload(cell.config, cell.traffic, 17, torch.device("cpu"))
    assert sorted(a.order) == list(range(pool))
    assert list(a.order) == list(b.order) and list(a.order) != list(c.order)
    assert np.array_equal(a.observed, c.observed)  # the data set is the configuration's
    first = [a.start(("window", i))[1] for i in range(pool + 1)]
    assert np.array_equal(first[0], first[pool])  # the pool cycles
    assert all(not np.array_equal(first[0], x) for x in first[1:pool])


def test_tracks_keep_their_arc():
    ncam, arc = 64, 12.0
    t = bal_gen.structure(ncam, 2000, 3, 2.3, 48, 1.0, (2.0, 2.0, 1.0), arc)
    near = int(np.ceil(ncam * arc / 360.0))
    starts = np.searchsorted(t["pt_idx"], np.arange(2001))
    for p in range(2000):
        cams = t["cam_idx"][starts[p]:starts[p + 1]]
        gap = np.abs(cams[:, None] - cams[None, :])
        assert np.minimum(gap, ncam - gap).max() >= near
    # every camera sees points from across the ring
    assert np.bincount(t["cam_idx"], minlength=ncam).min() > 0
