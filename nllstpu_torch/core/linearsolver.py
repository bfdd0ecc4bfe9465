"""Linear solvers for the normal equations (port of
``nllstpu/core/linearsolver.py``).

``cholesky_solve`` falls back to an LU solve when the matrix is not
positive definite (reference ``try_cholesky!``).  The JAX package detects a
failed factorization by a NaN diagonal inside ``lax.cond``; here
``cholesky_ex``'s ``info`` or a non-finite solution says so.  The pieces
can be captured in a CUDA graph: :func:`cholesky_solve_ex` returns the
Cholesky solution with that test as a device flag, :func:`lu_solve` the LU
one, and the caller reads the flag where it may (the graph driver after a
replay); :func:`cholesky_solve` reads it at once, one host sync.  The
fallback is numerics, not a device fallback: both branches run wherever
the matrix lives.  ``batched_inv_spd`` inverts the iterative backends'
preconditioner blocks; :func:`pcg_start` and :func:`pcg_chunk` are their
preconditioned conjugate gradients, in chunks that never read the host.
"""

from __future__ import annotations

import torch

#: PCG iterations between host reads of the convergence flag.  Updates
#: freeze once converged, so the result equals a loop that checks after
#: every iteration; a solve pays at most this many idle iterations and
#: reads the device once per chunk instead of once per iteration.
CG_CHECK_EVERY = 8


def _scaled(a, b):
    """``(a, b, d)``: a float32 system scaled to a unit diagonal (x = D y
    with D = |diag a|^-½, (D a D) y = D b), else unchanged with d None.

    The reduced camera system of Snavely BAL problems has a diagonal
    spanning eight decades (focal length against rotation) and BA's
    near-null gauge directions: in float32 it rounds to an indefinite
    matrix, the Cholesky fails, and LU with partial pivoting on the
    unscaled rows returns a step off by 3 to 1000 times its size, which LM
    rejects again and again.  On the scaled matrix the LU step matches an
    exact solve of the same float32 system.  Float64 factors unscaled, as
    the JAX package does: scaled, the last-bit differences at the cost's
    rounding floor change which damped trials LM accepts, and the float64
    LM trace no longer matches the JAX package's (16 cameras, 256
    landmarks, Huber: 10 damped solves against 5)."""
    if a.dtype != torch.float32:
        return a, b, None
    diag = torch.diagonal(a).abs()
    d = torch.where(diag > 0, torch.rsqrt(diag), torch.ones_like(diag))
    return a * d[:, None] * d[None, :], b * d, d


def _cholesky(a, b):
    """``(x, ok)`` on a scaled system.  A factorization counts as failed
    when ``info`` says so or when the solution it gives is not finite —
    the JAX package's test (a NaN on the factor's diagonal) reaches the
    same cases.  ``info`` alone is not enough: on the H100 a float32
    reduced system at λ ≈ 1e-10·max diag (the pinhole bench at its
    rounding floor, in a rare run) factored with ``info`` 0 into a
    non-finite solution, and the step came out NaN."""
    chol, info = torch.linalg.cholesky_ex(a)
    x = torch.cholesky_solve(b[:, None], chol)[:, 0]
    return x, (info == 0) & torch.isfinite(x).all()


def _lu(a, b):
    return torch.linalg.solve_ex(a, b)[0]


def cholesky_solve_ex(a, b):
    """``(x, ok)``: the Cholesky solution of ``a x = b`` (``b`` a vector,
    a float32 ``a`` scaled as :func:`cholesky_solve` scales it) and a 0-d
    bool device tensor, false when the factorization failed (then ``x`` is
    not the answer: take :func:`lu_solve`).  No host sync."""
    a, b, d = _scaled(a, b)
    x, ok = _cholesky(a, b)
    return (x if d is None else d * x), ok


def lu_solve(a, b):
    """The LU solution of ``a x = b``, on the system :func:`cholesky_solve`
    factors: the fallback of :func:`cholesky_solve_ex`.  No host sync."""
    a, b, d = _scaled(a, b)
    x = _lu(a, b)
    return x if d is None else d * x


def cholesky_solve(a, b):
    """Solve ``a x = b`` (``b`` a vector) by Cholesky, or by LU when ``a``
    is not positive definite: :func:`cholesky_solve_ex`, the flag read
    back (one host sync), then :func:`lu_solve` on the same scaled system
    where it failed."""
    a, b, d = _scaled(a, b)
    x, ok = _cholesky(a, b)
    if not bool(ok):
        x = _lu(a, b)
    return x if d is None else d * x


def solve_symmetric(a, b):
    """The iterators' entry point: x = a \\ b (:func:`cholesky_solve`)."""
    return cholesky_solve(a, b)


def batched_cholesky_solve(a, b):
    """``x [T, d]`` with ``a[t] x[t] = b[t]`` for a batch of small systems
    ``a [T, d, d]``: :func:`cholesky_solve` of every system at once — a
    float32 batch scaled to unit diagonals per system, one batched
    Cholesky, and the LU solution taken where a system's factorization
    failed (``info``, or a non-finite solution), by a ``where`` over both
    batched solves (the JAX package vmaps ``cholesky_solve``, whose
    ``lax.cond`` becomes the same select).  No host sync."""
    d = None
    if a.dtype == torch.float32:
        diag = torch.diagonal(a, dim1=-2, dim2=-1).abs()
        d = torch.where(diag > 0, torch.rsqrt(diag), torch.ones_like(diag))
        a = a * d[:, :, None] * d[:, None, :]
        b = b * d
    chol, info = torch.linalg.cholesky_ex(a)
    x = torch.cholesky_solve(b[:, :, None], chol)[:, :, 0]
    ok = (info == 0) & torch.isfinite(x).all(-1)
    x = torch.where(ok[:, None], x, torch.linalg.solve_ex(a, b)[0])
    return x if d is None else d * x


def invert_psd(a):
    """Inverse of a symmetric positive-definite matrix (reference
    ``invsym``, used for covariances): :func:`cholesky_solve` against each
    column of the identity, LU where the factorization fails."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    chol, info = torch.linalg.cholesky_ex(a)
    x = torch.cholesky_solve(eye, chol)
    if int(info) != 0 or not bool(torch.isfinite(x).all()):
        x = torch.linalg.solve(a, eye)
    return x


def batched_inv_spd(h):
    """Inverse of small symmetric blocks ``[n, d, d]``: the closed form of
    :func:`batched_inv_spd_cm` for d ≤ 3; beyond, the JAX package's
    per-block ``cholesky_solve`` against the identity — the Cholesky
    factor, then two batched triangular solves (``torch.cholesky_inverse``
    inverts one block after the other on the card: 1,660 pairs of
    triangular solves for the pose graph's 6x6 blocks) — with an LU
    inverse for the blocks whose factorization fails.  Both run on the
    whole batch and the choice is a ``where``, so no host sync is needed;
    a singular block comes out non-finite."""
    d = h.shape[-1]
    if d <= 3:
        return batched_inv_spd_cm(h.permute(1, 2, 0)).permute(2, 0, 1)
    chol, info = torch.linalg.cholesky_ex(h)
    eye = torch.eye(d, dtype=h.dtype, device=h.device).expand_as(h)
    y = torch.linalg.solve_triangular(chol, eye, upper=False)
    inv = torch.linalg.solve_triangular(chol.mT, y, upper=True)
    lu_inv, _ = torch.linalg.inv_ex(h)
    return torch.where((info > 0)[:, None, None], lu_inv, inv)


def batched_inv_spd_cm(h):
    """Inverse of small symmetric blocks stored components-major: ``h`` is
    ``[d, d, n]`` and so is the result.  Closed-form adjugate for d ≤ 3
    (the same cofactor arithmetic as the JAX package), a batched LU
    inverse beyond (``inv_ex``: no check that reads the device, so that a
    CUDA graph can capture it; a singular block gives non-finite entries,
    as the JAX package's inverse does)."""
    d = h.shape[0]
    if d == 1:
        return 1.0 / h
    if d == 2:
        a, b = h[0, 0], h[0, 1]
        c, e = h[1, 0], h[1, 1]
        inv_det = 1.0 / (a * e - b * c)
        out = torch.stack([torch.stack([e, -b]), torch.stack([-c, a])])
        return out * inv_det
    if d == 3:
        a, b, c = h[0, 0], h[0, 1], h[0, 2]
        e, f, g = h[1, 1], h[1, 2], h[2, 2]
        c00 = e * g - f * f
        c01 = c * f - b * g
        c02 = b * f - c * e
        c11 = a * g - c * c
        c12 = b * c - a * f
        c22 = a * e - b * b
        inv_det = 1.0 / (a * c00 + b * c01 + c * c02)
        out = torch.stack(
            [
                torch.stack([c00, c01, c02]),
                torch.stack([c01, c11, c12]),
                torch.stack([c02, c12, c22]),
            ]
        )
        return out * inv_det
    return torch.linalg.inv_ex(h.permute(2, 0, 1)).inverse.permute(1, 2, 0)


def pcg_start(rhs, precond, tol):
    """The start of a PCG solve of A x = ``rhs`` (the JAX package's
    ``while_loop`` carry): ``(tol2, state)`` with the squared absolute
    tolerance ``tol²·|rhs|²`` and ``state = (x, r, z, p, rz, k)`` at x = 0,
    each a tensor of its own (:func:`pcg_chunk`'s caller may update them
    in place); ``precond(r)`` applies the preconditioner."""
    tol2 = torch.full((), tol, dtype=rhs.dtype, device=rhs.device) ** 2 * (rhs @ rhs)
    r = rhs.clone()
    z = precond(r)
    state = (torch.zeros_like(rhs), r, z, z.clone(), r @ z,
             torch.zeros((), dtype=torch.int32, device=rhs.device))
    return tol2, state


def pcg_chunk(matvec, precond, tol2, state, max_iters: int):
    """:data:`CG_CHECK_EVERY` PCG iterations from ``state`` (the JAX
    package's loop body), the updates frozen once ``|r|² ≤ tol2`` or at
    ``max_iters`` iterations.  Returns the new state and ``flag = [more,
    iterations]`` in the system's dtype, still on the device: no host
    read, so a CUDA graph can hold it."""
    x, r, z, p, rz, k = state
    one = torch.ones((), dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    for _ in range(CG_CHECK_EVERY):
        active = (r @ r > tol2) & (k < max_iters)
        ap = matvec(p)
        denom = p @ ap
        alpha = torch.where(active, rz / torch.where(denom == 0, one, denom), zero)
        x = x + alpha * p
        r = r - alpha * ap
        z2 = precond(r)
        rz2 = r @ z2
        beta = rz2 / torch.where(rz == 0, one, rz)
        p = torch.where(active, z2 + beta * p, p)
        z = torch.where(active, z2, z)
        rz = torch.where(active, rz2, rz)
        k = k + active.to(k.dtype)
    flag = torch.stack([((r @ r > tol2) & (k < max_iters)).to(x.dtype), k.to(x.dtype)])
    return (x, r, z, p, rz, k), flag
