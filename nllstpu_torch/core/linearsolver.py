"""Linear solvers for the normal equations (port of
``nllstpu/core/linearsolver.py``).

``cholesky_solve`` falls back to an LU solve when the matrix is not
positive definite (reference ``try_cholesky!``).  The JAX package detects a
failed factorization by a NaN diagonal inside ``lax.cond``; here
``cholesky_ex``'s ``info`` says so, and reading it is one host sync.  The
fallback is numerics, not a device fallback: both branches run wherever
the matrix lives.
"""

from __future__ import annotations

import torch


def cholesky_solve(a, b):
    """Solve ``a x = b`` (``b`` a vector) by Cholesky, or by LU when ``a``
    is not positive definite.

    A float32 ``a`` is first scaled to a unit diagonal (x = D y with
    D = |diag a|^-½, (D a D) y = D b).  The reduced camera system of
    Snavely BAL problems has a diagonal spanning eight decades (focal
    length against rotation) and BA's near-null gauge directions: in
    float32 it rounds to an indefinite matrix, the Cholesky fails, and LU
    with partial pivoting on the unscaled rows returns a step off by 3 to
    1000 times its size, which LM rejects again and again.  On the scaled
    matrix the LU step matches an exact solve of the same float32 system.
    Float64 factors unscaled, as the JAX package does: scaled, the
    last-bit differences at the cost's rounding floor change which damped
    trials LM accepts, and the float64 LM trace no longer matches the JAX
    package's (16 cameras, 256 landmarks, Huber: 10 damped solves against
    5)."""
    d = None
    if a.dtype == torch.float32:
        diag = torch.diagonal(a).abs()
        d = torch.where(diag > 0, torch.rsqrt(diag), torch.ones_like(diag))
        a = a * d[:, None] * d[None, :]
        b = b * d
    chol, info = torch.linalg.cholesky_ex(a)
    if int(info) == 0:
        x = torch.cholesky_solve(b[:, None], chol)[:, 0]
    else:
        x, _ = torch.linalg.solve_ex(a, b)
    return x if d is None else d * x


def batched_inv_spd_cm(h):
    """Inverse of small symmetric blocks stored components-major: ``h`` is
    ``[d, d, n]`` and so is the result.  Closed-form adjugate for d ≤ 3
    (the same cofactor arithmetic as the JAX package), a batched LU
    inverse beyond."""
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
    return torch.linalg.inv(h.permute(2, 0, 1)).permute(1, 2, 0)
