"""A BAL problem solved back to back: the program's side and the judge.

The program receives only arrays: the generated cameras, points, indices
and observations go through ``nllstpu_torch.models.bal.make_bal_problem``
once, in set-up; each solve writes its start values (a fixed pool, cycled in
an order the run's seed draws) through the problem's
value path (``Problem.set_values``, which keeps the compiled problem and its
captured graphs) and calls ``nllstpu_torch.optimize`` with the traffic's
options.

The judge (:meth:`Workload.judge`) runs after the program's state is freed.
For every solve of the window it compares, against the float64 reference
(``reference/bal_ref.py``) on the same arrays:

- ``cost_gap``: the relative gap between the cost the solve reports and the
  reference's cost of the same variables, at its start values (the program's
  ``start_cost``) and at the variables it returns (``best_cost``);
- ``excess``: how far the returned variables' cost lies above the optimum,
  relative to it; the optimum is the reference's own Levenberg-Marquardt
  solve from the ground truth.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.data import bal_gen
from benchmark.reference import bal_ref

#: The start-value streams of the window's pool and of the warm-up.
STREAMS = {"window": 0, "warmup": 1}


class Workload:
    """The program's side: the problem built once from the arrays, one solve
    per call of :meth:`solve`, under the configuration's precision."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.truth = bal_gen.structure(
            config["ncameras"], config["npoints"], config["structure_seed"],
            config["track_alpha"], config["max_track"], config["cam_skew"], config["point_spread"],
            config["min_arc_deg"])
        self.observed = bal_gen.measurements(self.truth, config["structure_seed"],
                                             config["noise_px"])
        self.np_dtype = np.dtype(config["dtype"])
        self.finals = {}  # solve key -> the variables it returned (host arrays)
        # The data set and the pool of start values are the configuration's;
        # the window cycles through the pool in an order drawn from the run's
        # seed and ends on a whole cycle, so every run does the same solves.
        self.order = bal_gen.seed_rng(seed, 2).permutation(traffic["start_pool"])
        self.cycle = len(self.order)
        self.build()

    def build(self):
        """The program's problem from the generated arrays (compiled at the
        first solve), its options from the traffic, TF32 as the
        configuration states it."""
        import nllstpu_torch as nt
        from nllstpu_torch.models import bal

        torch.backends.cuda.matmul.allow_tf32 = self.config["tf32"]
        torch.backends.cudnn.allow_tf32 = self.config["tf32"]
        data = dict(cameras=self.truth["cameras"], points=self.truth["points"],
                    cam_idx=self.truth["cam_idx"], pt_idx=self.truth["pt_idx"],
                    observations=self.observed)
        self.nt = nt
        self.problem, cams, pts = bal.make_bal_problem(
            data, dtype=getattr(torch, self.config["dtype"]), device=self.device)
        self.families = (cams[0].family, pts[0].family)
        self.options = nt.Options(**dict(self.traffic["options"], schur_family=bal.PT))

    def start(self, key):
        """The start values of solve ``key`` as the program holds them: the
        window's ``i``-th solve takes entry ``order[i % pool]`` of the pool,
        which the configuration's structure seed draws."""
        stream, index = key
        if stream == "window":
            index = int(self.order[index % len(self.order)])
        cams, pts = bal_gen.start_values(self.truth, self.config["structure_seed"],
                                         (STREAMS[stream], index), self.traffic["perturb"])
        return cams.astype(self.np_dtype), pts.astype(self.np_dtype)

    def solve(self, key) -> dict:
        """One solve from the start values of ``key``; its record."""
        with record_function("set_start"):
            cams, pts = self.start(key)
            self.problem.set_values(dict(zip(self.families, (cams, pts))))
        t0 = time.perf_counter()
        with record_function("optimize"):
            res = self.nt.optimize(self.problem, self.options)
        wall = time.perf_counter() - t0
        if key[0] == "window":
            with record_function("snapshot"):
                held = self.problem.stacked_variables()
                self.finals[key] = tuple(held[f].cpu().numpy() for f in self.families)
        return dict(key=key, wall_s=wall, iterations=res.num_iterations,
                    linear_solves=res.linear_solves, start_cost=res.start_cost,
                    best_cost=res.best_cost, termination=res.termination,
                    time_init=res.time_init)

    def synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0

    def device_info(self, peak: int) -> dict:
        kind = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"
        return {"platform": "gpu" if self.device.type == "cuda" else "cpu", "kind": kind,
                "count": 1, "memory_peak_bytes": int(peak)}

    def shapes(self) -> dict:
        """The sizes the work counts read."""
        t = self.truth
        return dict(n_obs=int(t["cam_idx"].shape[0]), n_cams=int(t["cameras"].shape[0]),
                    n_pts=int(t["points"].shape[0]), n=2, dr=9, dl=3,
                    tracks=np.bincount(t["pt_idx"], minlength=t["points"].shape[0]))

    def release(self):
        """Free the program's state: its cached runners, graphs and problem."""
        from nllstpu_torch.core import optimize

        optimize.clear_runner_cache()
        self.problem = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def optimum(self, data: bal_ref.Data) -> float:
        """The reference's optimum cost: its solve from the ground truth."""
        return bal_ref.solve(data, self.truth["cameras"], self.truth["points"])[2]

    def reference(self, prec: bal_ref.Precision = bal_ref.F64) -> bal_ref.Data:
        """The reference over this run's observations, on the run's device."""
        return bal_ref.Data(self.truth["cam_idx"], self.truth["pt_idx"], self.observed,
                            self.device, prec)

    def numbers(self, solves: list, ref: bal_ref.Data, optimum: float) -> list:
        """Each solve's compared numbers against the reference ``ref``."""
        out = []
        for rec in solves:
            c0 = ref.cost(*self.start(rec["key"]))
            c1 = ref.cost(*self.finals[rec["key"]])
            out.append(dict(cost_gap=max(abs(rec["start_cost"] - c0) / c0,
                                         abs(rec["best_cost"] - c1) / c1),
                            excess=(c1 - optimum) / optimum))
        return out

    def judge(self, solves: list):
        """Every solve against the float64 reference: ``({name: {value,
        limit}}, failed)``, each value the worst over the solves; a solve
        fails when a number of it is over its limit or not finite."""
        limits = self.config["limits"]
        ref = self.reference()
        per_solve = self.numbers(solves, ref, self.optimum(ref))
        worst = {name: max((n[name] for n in per_solve), default=0.0,
                           key=lambda v: v if np.isfinite(v) else np.inf) for name in limits}
        failed = sum(not all(np.isfinite(n[k]) and n[k] <= limits[k] for k in limits)
                     for n in per_solve)
        return {name: {"value": worst[name], "limit": limits[name]} for name in limits}, failed


class Control(Workload):
    """The control: the reference in TF32 (``bal_ref.TF32``, the precision
    below the configuration's float32) in the program's place.  Each solve
    is the reference's Levenberg-Marquardt from the same start values to the
    traffic's stop; it reports its own TF32 costs and returns its variables,
    which :meth:`Workload.judge` holds to the limits as it holds the
    program's."""

    def build(self):
        self.ref32 = self.reference(bal_ref.TF32)

    def solve(self, key) -> dict:
        cams, pts = self.start(key)
        opts = self.traffic["options"]
        t0 = time.perf_counter()
        fc, fp, cost = bal_ref.solve(self.ref32, cams, pts, opts["max_iters"], opts["rel_dcost"])
        wall = time.perf_counter() - t0
        if key[0] == "window":
            self.finals[key] = (fc.cpu().numpy(), fp.cpu().numpy())
        return dict(key=key, wall_s=wall, iterations=1, linear_solves=1,
                    start_cost=self.ref32.cost(cams, pts), best_cost=cost, termination=0,
                    time_init=0.0)

    def release(self):
        self.ref32 = None
