"""Core modules of the PyTorch port against the JAX package on the CPU in
float64: manifolds, robust kernels, small-block inverses, the Cholesky
solve with its LU fallback, and the host-side Schur layout (degree
relabel and obs-major repack)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import nllstpu as nt
from nllstpu.core import linearsolver as jax_ls
from nllstpu.core.manifolds import so3_exp as jax_so3_exp
from nllstpu.core.optimize import compile_problem as jax_compile
import nllstpu_torch as pt
from nllstpu_torch.core import linearsolver
from nllstpu_torch.core.optimize import schur_layout
from nllstpu_torch.interop import problem_from_arrays
from nllstpu_torch import config
from nllstpu_torch.models import ba as tba
from nllstpu_torch.models import bal as tbal
from nllstpu.models import ba as jba


def test_so3_exp_and_se3_retract_match_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((20, 3)) * np.array([[1e-8], [1e-3], [0.5], [2.0]] * 5)
    w[0] = 0.0
    ref = np.stack([np.asarray(jax_so3_exp(jnp.asarray(v))) for v in w])
    np.testing.assert_allclose(pt.so3_exp(torch.from_numpy(w)).numpy(), ref,
                               rtol=1e-14, atol=1e-15)
    x = rng.standard_normal((20, 3, 4))
    d = rng.standard_normal((20, 6)) * 0.3
    ref = np.asarray(jax.vmap(nt.SE3().retract)(jnp.asarray(x), jnp.asarray(d)))
    got = pt.SE3().retract(torch.from_numpy(x), torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-14)
    assert torch.equal(
        pt.SE3().retract(torch.from_numpy(x), torch.zeros(20, 6, dtype=torch.float64)),
        torch.from_numpy(x),
    )


@pytest.mark.parametrize("kernel", ["none", "huber", "huber2o"])
def test_robust_rho_dc_matches_jax(kernel):
    s = np.concatenate([np.linspace(0, 4, 41), [1e-12, 0.25]])
    jk, tk = {
        "none": (nt.NoRobust(), pt.NoRobust()),
        "huber": (nt.Huber(0.5), pt.Huber(0.5)),
        "huber2o": (nt.Huber2o(0.5), pt.Huber2o(0.5)),
    }[kernel]
    for a, b in zip(tk.rho_dc(torch.from_numpy(s)), jk.rho_dc(jnp.asarray(s))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15, atol=0)


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_batched_inv_spd_cm_matches_jax(d):
    rng = np.random.default_rng(d)
    a = rng.standard_normal((d, d, 9))
    h = np.einsum("ijn,kjn->ikn", a, a) + np.eye(d)[:, :, None]
    got = linearsolver.batched_inv_spd_cm(torch.from_numpy(h)).numpy()
    ref = np.asarray(jax_ls.batched_inv_spd_cm(jnp.asarray(h)))
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)


def test_cholesky_solve_falls_back_to_lu():
    rng = np.random.default_rng(4)
    b = rng.standard_normal(5)
    spd = np.eye(5) * 3 + 0.1
    indefinite = np.diag([1.0, -2.0, 3.0, 4.0, -5.0])
    for a in (spd, indefinite):
        got = linearsolver.cholesky_solve(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(got.numpy(), np.linalg.solve(a, b), rtol=1e-12)
        ref = np.asarray(jax_ls.cholesky_solve(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cholesky_solve_falls_back_on_a_non_finite_factor(monkeypatch, dtype):
    """A factorization whose ``info`` reports success but whose factor
    carries a NaN (as the card's float32 factorization of a numerically
    singular reduced system did) is a failed one: the LU solve answers,
    to 1e-5 (float32) or 1e-12 (float64) relative."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((6, 6))
    a = a @ a.T + np.eye(6)
    b = rng.standard_normal(6)
    real = torch.linalg.cholesky_ex

    def poisoned(m):
        chol, info = real(m)
        chol = chol.clone()
        chol[3, 3] = float("nan")
        return chol, torch.zeros_like(info)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", poisoned)
    got = linearsolver.cholesky_solve(torch.from_numpy(a).to(dtype),
                                      torch.from_numpy(b).to(dtype))
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    np.testing.assert_allclose(got.double().numpy(), np.linalg.solve(a, b), rtol=rtol)


def _skewed_arrays():
    """A BA problem whose track lengths are long-tailed: a few landmarks
    seen by every camera, most by one or two."""
    ncam, nlmk = 40, 300
    jp, _, _ = jba.make_pinhole_ba(ncam, nlmk, 1.0, dtype=jnp.float64, batched="cm")
    rng = np.random.default_rng(9)
    ci, li = [], []
    for l in range(nlmk):
        k = ncam if l % 50 == 0 else int(rng.integers(1, 3))
        cams = rng.choice(ncam, size=k, replace=False)
        ci.extend(cams)
        li.extend([l] * k)
    ci, li = np.asarray(ci), np.asarray(li)
    vars_ = {k: np.asarray(v) for k, v in jp.stacked_variables().items()}
    meas = rng.standard_normal((len(ci), 2)) * 0.1
    return vars_, ci, li, meas


def test_skewed_layout_matches_jax_and_is_rejected(monkeypatch):
    """Degree relabel + bucketed obs-major repack equal the JAX package's
    (same buckets, same column permutation), and the bucketed assembly
    (kernel B2's plain version, an SE(3) camera: dr_s = 6) gives the JAX
    package's system.  The same problem without ``device="cpu"`` is
    rejected on a host without a card."""
    vars_, ci, li, meas = _skewed_arrays()
    jp = nt.Problem(dtype=jnp.float64)
    cams = jp.add_variables(nt.SE3(), vars_["SE3()"])
    lmks = jp.add_variables(nt.Euclidean(3), vars_["Euclidean(n=3)"])
    del cams, lmks
    jp.add_cost_batch(
        jba.pinhole_project_cm, slots=[(nt.SE3(), ci), (nt.Euclidean(3), li)],
        params=meas, jacobian=jba.pinhole_project_jacobian_cm, batched="cm",
    )
    jc = jax_compile(jp, solver="schur", schur_family=nt.Euclidean(3))
    (jb,) = jp.batches()
    batch_arrays = [dict(
        fn=tba.pinhole_project_cm, jacobian=tba.pinhole_project_jacobian_cm,
        manifolds=(pt.SE3(), pt.Euclidean(3)), idx=jb.idx,
        params=np.asarray(jb.params), mask=np.asarray(jb.mask),
    )]
    tp = problem_from_arrays(vars_, batch_arrays, dtype=torch.float64, device="cpu")
    layout, info, batches = schur_layout(tp, pt.Euclidean(3))
    (meta_j,) = jc.obs_meta
    assert len(info.fast[0].buckets) > 1
    assert info.fast[0].buckets == meta_j.buckets
    for name in layout.offsets:
        assert np.array_equal(layout.offsets[name], jc.layout.offsets[name])
    (tb,) = batches
    (jb2,) = jc.batches
    for a, b in zip(tb.idx, jb2.idx):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(tb.mask, np.asarray(jb2.mask))
    tc = pt.compile_problem(tp, solver="schur", schur_family=pt.Euclidean(3))
    _, sys_t = tc.assemble(tp.stacked_variables())
    _, sys_j = jax.jit(jc.assemble)(jp.stacked_variables())
    tol = dict(rtol=1e-10, atol=1e-12)
    for name, a, b in zip("a_rr b_r h_ll g_l".split(), sys_t[:4], sys_j[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **tol)
    np.testing.assert_allclose(
        sys_t[4].numpy(), np.asarray(sys_j[4]).transpose(1, 0, 2), **tol
    )
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        problem_from_arrays(vars_, batch_arrays, dtype=torch.float64)


def test_compile_rejects_other_solvers():
    tp, _, _ = tba.make_pinhole_ba(4, 16, dtype=torch.float64, device="cpu")
    with pytest.raises(NotImplementedError):
        pt.compile_problem(tp, solver="dense")
    with pytest.raises(NotImplementedError):
        pt.optimize(tp, pt.Options(schur_family=pt.Euclidean(3), iterator="dogleg"))


def test_device_defaults_to_the_card(monkeypatch):
    """No ``device=`` means ``cuda``; on a host without a card every entry
    point raises and says how to ask for the CPU, never falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert config.resolve_device(None) == torch.device("cuda")
    assert config.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (
        lambda: pt.Problem(),
        lambda: pt.Problem(device="cuda"),
        lambda: tba.make_pinhole_ba(4, 16),
        lambda: tbal.make_bal_problem(tbal.make_synthetic_bal(4, 8)),
    ):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()
    assert pt.Problem(device="cpu").device == torch.device("cpu")
    assert pt.Problem(device="cpu").dtype == torch.float64
