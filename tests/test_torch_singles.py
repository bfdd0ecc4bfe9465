"""Per-variable alternation (``optimize_singles``) of the port on the CPU
in float64 against the JAX package on the same seeded inputs: the four
cases of ``tests/test_singles.py``, then dogleg and gradient descent (and
LM, Newton where the JAX tests run them) on the affine BA problem and the
components-major synthetic BAL problem.

Tolerances: final values within 1e-10 of the JAX package's and the
per-family iteration sums equal.  The BAL cases stop at ``rel_dcost=1e-6``,
before the float64 floor where a lane's last accept is decided by
rounding alone; gradient descent stops at 30 iterations, because past
them its line search amplifies last-bit differences: the JAX package's
own sum on the affine problem moves from 1,878 to 1,877 under a one-ulp
change of its start at 100 iterations.
"""

import numpy as np
import pytest
import torch

import nllstpu as jt
from nllstpu.core.singles import optimize_singles as jax_singles
from nllstpu.models import bal as jbal
from nllstpu.models.ba import make_affine_ba as jax_affine
from nllstpu.models.ba import perturb_ba as jax_perturb
import nllstpu_torch as nt
from nllstpu_torch.core import optimize as topt
from nllstpu_torch.models import bal as tbal
from nllstpu_torch.models.ba import make_affine_ba, perturb_ba

LMK = nt.family_name(nt.Euclidean(3))


def _values(p, fam=LMK):
    v = p.stacked_variables()[fam]
    return v.numpy() if torch.is_tensor(v) else np.asarray(v)


def _affine(shape, scale, seed):
    p, cams, lmks = make_affine_ba(*shape, device="cpu")
    perturb_ba(p, lmks, scale, seed=seed)
    q, jcams, jlmks = jax_affine(*shape)
    jax_perturb(q, jlmks, scale, seed=seed)
    return (p, cams, lmks), (q, jcams, jlmks)


def _same(p, q, s, s_jax, fams=(LMK,)):
    assert s == s_jax
    for fam in fams:
        np.testing.assert_allclose(_values(p, fam), _values(q, fam), rtol=0, atol=1e-10)


def test_landmark_polish():
    (p, cams, _), (q, _, _) = _affine((3, 5, 1.0), 0.003, 3)
    assert nt.cost(p) > 1e-6
    s = nt.optimize_singles(p, nt.Options(), targets=nt.Euclidean(3))
    assert nt.cost(p) < 1e-15
    p2, cams2, _ = make_affine_ba(3, 5, 1.0, device="cpu")
    for h, h2 in zip(cams, cams2):  # cameras untouched
        np.testing.assert_array_equal(p.get_value(h), p2.get_value(h2))
    _same(p, q, s, jax_singles(q, jt.Options(), targets=jt.Euclidean(3)))


def test_landmark_polish_sparse_newton():
    (p, _, _), (q, _, _) = _affine((6, 20, 0.4), 0.01, 5)
    s = nt.optimize_singles(p, nt.Options(iterator=nt.NEWTON), targets=nt.Euclidean(3))
    assert nt.cost(p) < 1e-15
    _same(p, q, s, jax_singles(q, jt.Options(iterator=jt.NEWTON), targets=jt.Euclidean(3)))


def test_subset_of_handles():
    (p, _, lmks), (q, _, jlmks) = _affine((3, 5, 1.0), 0.01, 6)
    before = [p.get_value(h) for h in lmks]
    s = nt.optimize_singles(p, nt.Options(), targets=lmks[:2])
    for i, h in enumerate(lmks):  # only the first two landmarks moved
        assert (not np.array_equal(p.get_value(h), before[i])) == (i < 2)
    _same(p, q, s, jax_singles(q, jt.Options(), targets=jlmks[:2]))


def test_scalar_family_singles():
    """Univariate alternation on a scalar family (storage shape ())."""
    vals = np.array([1.0, -2.0, 3.0, 0.5, -0.25])

    def build(pkg, **kw):
        p = pkg.Problem(**kw)
        xs = [p.add_variable(pkg.Scalar(), 0.0) for _ in vals]
        for h, t in zip(xs, vals):
            p.add_cost(residual, (h,), params=t)
        return p, xs

    def residual(tv, x):
        return x - tv

    p, xs = build(nt, dtype=torch.float64, device="cpu")
    s = nt.optimize_singles(p, nt.Options(iterator=nt.NEWTON), targets=nt.Scalar())
    np.testing.assert_allclose([float(p.get_value(h)) for h in xs], vals, rtol=1e-10)
    q, _ = build(jt)
    fam = nt.family_name(nt.Scalar())
    _same(p, q, s, jax_singles(q, jt.Options(iterator=jt.NEWTON), targets=jt.Scalar()),
          fams=(fam,))


@pytest.mark.parametrize("iterator", [nt.DOGLEG, nt.GRADIENT_DESCENT])
def test_affine_iterators_match_jax(iterator):
    (p, _, _), (q, _, _) = _affine((6, 20, 0.4), 0.01, 5)
    kw = dict(iterator=iterator, max_iters=30 if iterator == nt.GRADIENT_DESCENT else 100)
    s = nt.optimize_singles(p, nt.Options(**kw), targets=nt.Euclidean(3))
    _same(p, q, s, jax_singles(q, jt.Options(**kw), targets=jt.Euclidean(3)))


@pytest.fixture(scope="module")
def bal_data():
    return (tbal.make_synthetic_bal(6, 48, obs_per_point=4, noise=1e-3),
            jbal.make_synthetic_bal(6, 48, obs_per_point=4, noise=1e-3))


@pytest.mark.parametrize("iterator", [nt.LEVENBERG_MARQUARDT, nt.DOGLEG,
                                      nt.GRADIENT_DESCENT])
def test_bal_cm_iterators_match_jax(bal_data, iterator):
    """The components-major batch through the slot columns of its hand
    Jacobian, every per-target sum through B6's dispatcher (its plain
    version here), against the JAX package's per-cost autodiff."""
    d, dj = bal_data
    p, _, pts = tbal.make_bal_problem(d, device="cpu")
    perturb_ba(p, pts, 0.01, seed=7)
    q, _, jpts = jbal.make_bal_problem(dj)
    jax_perturb(q, jpts, 0.01, seed=7)
    kw = dict(iterator=iterator, rel_dcost=1e-6,
              max_iters=30 if iterator == nt.GRADIENT_DESCENT else 100)
    s = nt.optimize_singles(p, nt.Options(**kw), targets=tbal.PT)
    _same(p, q, s, jax_singles(q, jt.Options(**kw), targets=jbal.PT))


def test_per_cost_mixed_targets_match_jax(bal_data, monkeypatch):
    """Per-cost batches (``torch.func.vmap`` of ``jacfwd`` in one slot),
    cameras and points as targets in one call, each family's sums through
    the kernels' B6 dispatcher."""
    import dataclasses

    calls = []
    real = topt.KERNELS.segment_sum

    def counting(data, starts):
        calls.append(tuple(data.shape))
        return real(data, starts)

    monkeypatch.setattr(topt, "KERNELS", dataclasses.replace(topt.KERNELS,
                                                             segment_sum=counting))
    d, dj = bal_data
    p, cams, pts = tbal.make_bal_problem(d, device="cpu", batched=False)
    perturb_ba(p, pts, 0.01, seed=7)
    q, jcams, jpts = jbal.make_bal_problem(dj, batched=False)
    jax_perturb(q, jpts, 0.01, seed=7)
    opts = dict(rel_dcost=1e-6)
    s = nt.optimize_singles(p, nt.Options(**opts), targets=pts[:10] + cams[:2])
    s_jax = jax_singles(q, jt.Options(**opts), targets=jpts[:10] + jcams[:2])
    _same(p, q, s, s_jax, fams=(LMK, nt.family_name(tbal.CAM)))
    widths = {w for _, w in calls}
    assert widths == {1, 1 + 3 + 9, 1 + 9 + 81}  # trial costs, point and camera sums
