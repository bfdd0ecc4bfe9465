"""The port's utilities on the CPU against the JAX package's: Hessian
export (ports of ``tests/test_export.py``, and the same H as the JAX
package's ``hessian_dense``), checkpoints (a port of
``tests/test_utils.py``'s round trip, and files crossing between the two
packages), the fenced timer and the profiler trace, and the native BAL
parser against the port's numpy reader and the JAX package's
``load_bal``."""

import os

import numpy as np
import pytest
import torch

import nllstpu as jt
from nllstpu.core.optimize import compile_problem as jax_compile
from nllstpu.models import bal as jbal
from nllstpu.models.ba import make_affine_ba as jax_affine
from nllstpu.models.ba import perturb_ba as jax_perturb
from nllstpu.models.rosenbrock import make_rosenbrock as jax_rosenbrock
from nllstpu.ops import export as jax_export
from nllstpu.utils import checkpoint as jax_checkpoint
import nllstpu_torch as nt
from nllstpu_torch.core.optimize import compile_problem
from nllstpu_torch.models import bal as tbal
from nllstpu_torch.models.ba import make_affine_ba, perturb_ba
from nllstpu_torch.models.rosenbrock import make_rosenbrock
from nllstpu_torch.ops import export
from nllstpu_torch.utils import checkpoint, native, profiling


@pytest.mark.parametrize("solver", ["dense", "schur"])
def test_coo_matches_dense(solver):
    p, cams, lmks = make_affine_ba(4, 9, 0.6, device="cpu")
    perturb_ba(p, lmks, 0.05, seed=3)
    compiled = compile_problem(p, solver=solver,
                               schur_family=nt.Euclidean(3) if solver == "schur" else None)
    variables = p.stacked_variables()
    a, b = export.hessian_dense(compiled, variables)
    rows, cols, vals = export.hessian_coo(compiled, variables)
    d = compiled.layout.dof_total
    dense_from_coo = np.zeros((d, d))
    np.add.at(dense_from_coo, (rows, cols), vals)
    np.testing.assert_allclose(dense_from_coo, a.numpy(), rtol=1e-10, atol=1e-12)
    if solver == "dense":  # the JAX package's system, same layout
        q, _, jlmks = jax_affine(4, 9, 0.6)
        jax_perturb(q, jlmks, 0.05, seed=3)
        ja, jb = jax_export.hessian_dense(jax_compile(q), q.stacked_variables())
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-12, atol=1e-12)


def test_covariance():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 3))
    y = rng.standard_normal(6)
    p = nt.Problem(dtype=torch.float64, device="cpu")
    w = p.add_variable(nt.Euclidean(3), np.zeros(3))
    p.add_cost(lambda pr, v: pr[:, 1:] @ v - pr[:, 0], (w,), params=np.c_[y, x])
    compiled = compile_problem(p)
    cov = export.covariance(compiled, p.stacked_variables())
    np.testing.assert_allclose(cov.numpy(), np.linalg.inv(x.T @ x), rtol=1e-9)
    damped = export.covariance(compiled, p.stacked_variables(), damping=0.5)
    np.testing.assert_allclose(damped.numpy(), np.linalg.inv(x.T @ x + 0.5 * np.eye(3)),
                               rtol=1e-9)


def test_checkpoint_roundtrip(tmp_path):
    p, x, y = make_rosenbrock(x0=-0.5, y0=2.5, device="cpu")
    nt.optimize(p, nt.Options(max_iters=3))
    path = os.path.join(tmp_path, "state.npz")
    checkpoint.save_variables(path, p, extra={"lm_lambda": 1e-3})
    vx, vy = p.get_value(x), p.get_value(y)
    p.set_value(x, 42.0)
    p.set_value(y, -7.0)
    extras = checkpoint.load_variables(path, p)
    np.testing.assert_array_equal(p.get_value(x), vx)
    np.testing.assert_array_equal(p.get_value(y), vy)
    np.testing.assert_allclose(extras["lm_lambda"], 1e-3)
    nt.optimize(p)
    np.testing.assert_allclose(float(p.get_value(x)), 1.0, rtol=1e-8)


def test_checkpoint_crosses_packages(tmp_path):
    """A file saved by either package loads in the other, bit for bit."""
    p, x, y = make_rosenbrock(x0=-0.5, y0=2.5, device="cpu")
    q, jx, jy = jax_rosenbrock(x0=0.25, y0=-1.5)
    nt.optimize(p, nt.Options(max_iters=2))
    a, b = os.path.join(tmp_path, "torch.npz"), os.path.join(tmp_path, "jax.npz")
    checkpoint.save_variables(a, p, extra={"k": 2.0})
    assert jax_checkpoint.load_variables(a, q)["k"] == 2.0
    np.testing.assert_array_equal(np.asarray(q.get_value(jx)), p.get_value(x))
    jt.optimize(q, jt.Options(max_iters=2))
    jax_checkpoint.save_variables(b, q)
    checkpoint.load_variables(b, p)
    np.testing.assert_array_equal(p.get_value(y), np.asarray(q.get_value(jy)))
    with pytest.raises(KeyError):
        checkpoint.load_variables(a, nt.Problem(device="cpu"))


def test_timed_fence_and_trace(tmp_path):
    def f(x):
        return x * 2, {"y": x + 1}

    secs, out = profiling.timed(f, torch.ones(16))
    assert secs > 0
    np.testing.assert_allclose(out[0].numpy(), 2.0)
    assert profiling.fence(out) == 32.0 + 32.0
    with profiling.trace(str(tmp_path)) as prof:
        f(torch.ones(8))
    assert any("mul" in e.key for e in prof.key_averages())


def test_native_parser_matches_numpy_and_jax(tmp_path, monkeypatch):
    """``write_bal`` then ``load_bal``: the native parser (built into the
    port's own build directory) gives the arrays written, as the numpy
    reader and the JAX package's ``load_bal`` do."""
    data = tbal.make_realistic_bal(12, 300, seed=1, noise=1e-3)
    path = os.path.join(tmp_path, "problem.txt")
    tbal.write_bal(path, data)
    got = tbal.load_bal(path)
    assert native.LAST_PARSER == "native"
    assert native._SO_PATH.startswith(os.path.join(native._ROOT, ".torch_ext"))
    monkeypatch.setattr(native, "parse_bal", lambda _: None)
    plain = tbal.load_bal(path)
    assert native.LAST_PARSER == "numpy"
    ref = jbal.load_bal(path)
    for key in ("cameras", "points", "cam_idx", "pt_idx", "observations"):
        np.testing.assert_array_equal(got[key], plain[key])
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]))
        assert got[key].dtype == plain[key].dtype


@pytest.mark.parametrize("example", ["rosenbrock", "robustifiers", "posegraph_demo",
                                     "bal_demo", "adaptivekernel"])
def test_examples_run_on_the_cpu(example):
    """Each example of ``examples_torch/`` runs with ``--cpu`` (no JAX)."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, os.path.join(root, "examples_torch", f"{example}.py"),
                          "--cpu"], capture_output=True, text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "jax" not in out.stdout.lower()
