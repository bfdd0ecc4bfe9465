"""The check fails where the timed path is broken underneath.

Each case drives the rest of a run (the look for a card skipped) on the CPU
at a small size, with one fault planted in the program, and sees ``correct``
come out false; the sound run beside them comes out true.  Besides the
contract's faults, the reduced camera system of each route is formed
without its coupling term.  The cells have no exchange between chips, so
that fault has no case."""

import io
import json
import math
import time

import pytest
import torch
from conftest import tiny_cell

from benchmark import harness
from benchmark.kinds import bal as kind


def unchanged_state(monkeypatch):
    """Every step returns the variables it was given."""
    from nllstpu_torch.core import engine

    monkeypatch.setattr(engine, "apply_step",
                        lambda manifolds, index, pad, variables, x: dict(variables))


def half_the_batch(monkeypatch):
    """Every other observation left out, the cost over the rest doubled."""
    from nllstpu_torch.models import bal

    residual, jacobian = bal.snavely_residual_cm, bal.snavely_jacobian_cm

    def keep(x):
        w = (torch.arange(x.shape[-1], device=x.device) % 2 == 0).to(x.dtype) * math.sqrt(2.0)
        return x * w

    monkeypatch.setattr(bal, "snavely_residual_cm", lambda m, c, p: keep(residual(m, c, p)))
    monkeypatch.setattr(bal, "snavely_jacobian_cm",
                        lambda m, c, p: tuple(keep(t) for t in jacobian(m, c, p)))


def answer_altered(monkeypatch):
    """The returned variables altered where the graph driver produces them: one
    point moved by half a unit."""
    from nllstpu_torch.core import optimize

    run = optimize._GraphRunner.run

    def altered(self):
        final = run(self)
        for name, v in final["variables"].items():
            if v.shape[-1] == 3:
                v[0] += 0.5
        return final

    monkeypatch.setattr(optimize._GraphRunner, "run", altered)


def reduced_uncoupled(monkeypatch):
    """The direct route's reduced camera system formed without its coupling
    term: S = A_rr + λI, the points' elimination left out."""
    from nllstpu_torch.ops import schur

    reduced = schur.SchurOps.reduced

    def uncoupled(self, sys, lam):
        _, rhs, h_inv = reduced(self, sys, lam)
        a_rr = sys[0]
        return a_rr + lam * torch.eye(a_rr.shape[0], dtype=a_rr.dtype), rhs, h_inv

    monkeypatch.setattr(schur.SchurOps, "reduced", uncoupled)


def matvec_uncoupled(monkeypatch):
    """The implicit route's product S v without its coupling term:
    (A_rr + λI) v, the points' elimination left out of the PCG."""
    from nllstpu_torch.ops import schur

    monkeypatch.setattr(schur.SchurCGOps, "s_matvec",
                        lambda self, sys, h_inv, lam, v: sys[0] @ v + lam * v)


def drive(manifest, seed=9, **options):
    out, err = io.StringIO(), io.StringIO()
    cell = tiny_cell(manifest, options=options)
    rc = harness.drive(cell, kind.Workload, seed, 1.0, False, torch.device("cpu"),
                       time.perf_counter(), out, err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("solver", ["schur", "schur_cg"])
def test_sound_run_is_correct(manifest, solver):
    line = drive(manifest, solver=solver)
    assert line["correct"], line["checks"]
    assert line["attempted"] % 8 == 0  # whole cycles of the pool of starts


@pytest.mark.parametrize("fault, solver", [
    (unchanged_state, "schur"), (half_the_batch, "schur"), (answer_altered, "schur"),
    (reduced_uncoupled, "schur"), (matvec_uncoupled, "schur_cg")])
def test_fault_is_caught(manifest, monkeypatch, fault, solver):
    fault(monkeypatch)
    line = drive(manifest, solver=solver)
    assert not line["correct"], line["checks"]
    assert line["failed"] >= 1
