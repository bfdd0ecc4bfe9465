"""Robust kernels ρ(s) on squared residual norms, with (ρ, ρ′, ρ″).

Port of ``nllstpu/core/robust.py``: the fixed ``NoRobust``, ``Huber``,
``Scaled``, ``GemanMcclure``, ``Cauchy``, ``Welsch`` and ``Tukey`` (whose
derivatives come from :func:`auto_rho_dc`), and the adaptive kernels
whose parameters are one more optimized variable — ``ContaminatedGaussian``
(reference src/robustadaptive.jl) and ``Barron`` — with ``ScaledAdaptive``
and the EM fit of ``em_fit``.  Every function is elementwise over a tensor
of squared norms; an adaptive kernel's parameters come components-major,
``[ambient, B]`` (or ``[ambient]`` for a single cost).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch.func import jacfwd, jvp

from .manifolds import BarronManifold, ContaminatedGaussianManifold


def auto_rho_dc(rho_fn, s):
    """(ρ, ρ′, ρ″) of an elementwise kernel by forward-mode autodiff (the
    JAX package's ``auto_rho_dc``): a tangent of ones gives every element's
    own derivative."""
    ones = torch.ones_like(s)

    def d1_fn(u):
        return jvp(rho_fn, (u,), (ones,))[1]

    rho, d1 = jvp(rho_fn, (s,), (ones,))
    return rho, d1, jvp(d1_fn, (s,), (ones,))[1]


@dataclasses.dataclass(frozen=True)
class Robustifier:
    """Fixed (non-adaptive) robust kernel; instances are hashable and part
    of the cost-batch grouping key."""

    def rho(self, s):
        raise NotImplementedError

    def rho_dc(self, s):
        return auto_rho_dc(self.rho, s)


@dataclasses.dataclass(frozen=True)
class NoRobust(Robustifier):
    """Identity kernel."""

    def rho(self, s):
        return s

    def rho_dc(self, s):
        return s, torch.ones_like(s), torch.zeros_like(s)


@dataclasses.dataclass(frozen=True)
class Scaled(Robustifier):
    """Constant multiple of an inner kernel (reference src/robust.jl:22-31).
    ``Scaled(adaptive, h)`` returns a :class:`ScaledAdaptive`, so that the
    kernel's parameters stay a jointly optimized variable."""

    robust: Robustifier
    height: float

    def __new__(cls, robust=None, height=None):
        if cls is Scaled and isinstance(robust, AdaptiveRobustifier):
            return ScaledAdaptive(robust, height)
        return super().__new__(cls)

    def rho(self, s):
        return self.robust.rho(s) * self.height

    def rho_dc(self, s):
        c, d1, d2 = self.robust.rho_dc(s)
        return c * self.height, d1 * self.height, d2 * self.height


@dataclasses.dataclass(frozen=True)
class Huber(Robustifier):
    """Huber kernel: quadratic below ``width``², linear above.
    ``second_order=True`` also reports the negative ρ″ of the linear
    regime (reference ``Huber2oKernel``)."""

    width: float
    second_order: bool = False

    def rho(self, s):
        wsq = self.width * self.width
        safe = torch.sqrt(torch.clamp(s, min=wsq))
        return torch.where(s < wsq, s, safe * (2 * self.width) - wsq)

    def rho_dc(self, s):
        wsq = self.width * self.width
        s_cl = torch.clamp(s, min=wsq)
        sqrt_s = torch.sqrt(s_cl)
        in_quad = s < wsq
        rho = torch.where(in_quad, s, sqrt_s * (2 * self.width) - wsq)
        d1 = torch.where(in_quad, torch.ones_like(s), self.width / sqrt_s)
        if self.second_order:
            d2 = torch.where(
                in_quad, torch.zeros_like(s), (-0.5 * self.width) / (s_cl * sqrt_s)
            )
        else:
            d2 = torch.zeros_like(s)
        return rho, d1, d2


def Huber2o(width: float) -> Huber:
    """Reference ``Huber2oKernel``."""
    return Huber(width, second_order=True)


@dataclasses.dataclass(frozen=True)
class GemanMcclure(Robustifier):
    """Geman-McClure kernel: ρ(s) = s·c²/(s + c²)."""

    width: float

    def rho(self, s):
        wsq = self.width * self.width
        return s * wsq / (s + wsq)

    def rho_dc(self, s):
        wsq = self.width * self.width
        r = 1.0 / (s + wsq)
        w = wsq * r
        w2 = w * w
        return s * w, w2, -2 * w2 * r


@dataclasses.dataclass(frozen=True)
class Cauchy(Robustifier):
    """Cauchy (Lorentzian) kernel: ρ(s) = c²·log(1 + s/c²)."""

    width: float

    def rho(self, s):
        csq = self.width * self.width
        return csq * torch.log1p(s / csq)

    def rho_dc(self, s):
        csq = self.width * self.width
        inv = 1.0 / (1.0 + s / csq)
        return csq * torch.log1p(s / csq), inv, -(inv * inv) / csq


@dataclasses.dataclass(frozen=True)
class Welsch(Robustifier):
    """Welsch kernel: ρ(s) = c²·(1 − exp(−s/c²))."""

    width: float

    def rho(self, s):
        csq = self.width * self.width
        return csq * (1.0 - torch.exp(-s / csq))

    def rho_dc(self, s):
        csq = self.width * self.width
        e = torch.exp(-s / csq)
        return csq * (1.0 - e), e, -e / csq


@dataclasses.dataclass(frozen=True)
class Tukey(Robustifier):
    """Tukey biweight kernel, redescending: ρ(s) = c²/3·(1 − (1 − u)³)
    with u = min(s/c², 1); derivatives by :func:`auto_rho_dc`."""

    width: float

    def rho(self, s):
        csq = self.width * self.width
        u = torch.clamp(s / csq, max=1.0)
        return (csq / 3.0) * (1.0 - (1.0 - u) ** 3)


# ---------------------------------------------------------------------------
# Adaptive kernels: the kernel's parameters are an optimized variable
# (reference AbstractAdaptiveRobustifier).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdaptiveRobustifier:
    """Adaptive kernel: ``rho`` takes the stored kernel parameters first;
    ``manifold`` is their tangent space."""

    @property
    def manifold(self):
        raise NotImplementedError

    def rho(self, kparams, s):
        raise NotImplementedError

    def rho_dc(self, kparams, s):
        """(ρ, ρ′, ρ″) in s, by forward-mode autodiff (ρ is elementwise in
        s, so a tangent of ones gives the derivative of every entry)."""
        one = torch.ones_like(s)

        def d1(u):
            return jvp(lambda v: self.rho(kparams, v), (u,), (one,))[1]

        rho, d1_s = jvp(lambda v: self.rho(kparams, v), (s,), (one,))
        return rho, d1_s, jvp(d1, (s,), (one,))[1]

    def rho_dkernel_cm(self, kparams_cm, s):
        """``(ρ [B], dgrad [k+1, B], dhess [k+1, k+1, B])``: value, gradient
        and Hessian of ρ in ``[kernel tangent, s]`` at the zero tangent
        (reference ``autorobustifydkernel``), for parameters
        ``kparams_cm [ambient, B]`` and squared norms ``s [B]``.  Every
        cost rides one shared basis tangent broadcast over the batch, so
        forward over forward mode takes (k+1)² elementwise passes; any
        subclass whose ``rho`` is elementwise in ``s`` qualifies."""
        man = self.manifold
        k = man.dof

        def f(z):
            t = z[:k, None].expand(k, s.shape[-1])
            return self.rho(man.retract_cm(kparams_cm, t), s + z[k])

        def f_aux(z):
            v = f(z)
            return v, v

        def grad_aux(z):
            g, v = jacfwd(f_aux, has_aux=True)(z)
            return g, (g, v)

        dhess, (dgrad, val) = jacfwd(grad_aux, has_aux=True)(s.new_zeros(k + 1))
        return val, dgrad.T, dhess.permute(1, 2, 0)  # [B], [k+1, B], [k+1, k+1, B]

    def rho_dkernel(self, kparams, s):
        """``(ρ, dgrad [k+1], dhess [k+1, k+1])`` of one cost: the
        per-cost form of :meth:`rho_dkernel_cm` (the JAX package's
        ``rho_dkernel``), through it on a batch of one, so that a kernel's
        closed form serves both."""
        val, dgrad, dhess = self.rho_dkernel_cm(kparams[:, None], s.reshape(1))
        return val[0], dgrad[:, 0], dhess[:, :, 0]


@dataclasses.dataclass(frozen=True)
class ScaledAdaptive(AdaptiveRobustifier):
    """Constant multiple of an adaptive kernel, what ``Scaled(adaptive, h)``
    builds: ρ and every derivative scale by ``height``."""

    robust: AdaptiveRobustifier
    height: float

    @property
    def manifold(self):
        return self.robust.manifold

    def rho(self, kparams, s):
        return self.robust.rho(kparams, s) * self.height

    def rho_dc(self, kparams, s):
        c, d1, d2 = self.robust.rho_dc(kparams, s)
        return c * self.height, d1 * self.height, d2 * self.height

    def rho_dkernel_cm(self, kparams_cm, s):
        v, g, h = self.robust.rho_dkernel_cm(kparams_cm, s)
        return v * self.height, g * self.height, h * self.height


@dataclasses.dataclass(frozen=True)
class ContaminatedGaussian(AdaptiveRobustifier):
    """Two-component Gaussian-mixture adaptive kernel (reference
    src/robustadaptive.jl:3-33).  Stored parameters ``[inv_sigma1,
    inv_sigma2, w]`` with inv_sigma1 ≥ inv_sigma2 (the first component the
    narrowest).  ρ contains −log of the mixture density, so the cost can be
    negative."""

    @property
    def manifold(self):
        return ContaminatedGaussianManifold()

    @staticmethod
    def make_params(sigma1: float, sigma2: float, w: float, dtype=torch.float64):
        """The stored parameters of sigmas and weight, narrowest first
        (src/robustadaptive.jl:12-20)."""
        is1, is2 = 1.0 / sigma1, 1.0 / sigma2
        if is1 < is2:
            is1, is2 = is2, is1
        return torch.tensor([is1, is2, w], dtype=dtype)

    @staticmethod
    def sigmas_weight(kparams):
        """``(sigma1, sigma2, w)`` (reference ``params``)."""
        kparams = torch.as_tensor(kparams)
        return torch.stack([1.0 / kparams[0], 1.0 / kparams[1], kparams[2]])

    def rho(self, kparams, s):
        is1, is2, w = kparams[0], kparams[1], kparams[2]
        s2sq = is2 * is2
        half_d = 0.5 * (s2sq - is1 * is1)  # <= 0 given the ordering
        return s * (0.5 * s2sq) - torch.log(
            w * is1 * torch.exp(s * half_d) + (1 - w) * is2
        )

    def rho_dc(self, kparams, s):
        """Analytic (ρ, ρ′, ρ″) in s (src/robustadaptive.jl:26-33)."""
        is1, is2, w = kparams[0], kparams[1], kparams[2]
        s2sq = is2 * is2
        half_d = 0.5 * (s2sq - is1 * is1)
        half_s2sq = 0.5 * s2sq
        e = w * is1 * torch.exp(s * half_d)
        t = (1 - w) * is2
        den = 1.0 / (e + t)
        e2 = e * half_d
        return (
            s * half_s2sq + torch.log(den),
            half_s2sq - e2 * den,
            -e2 * half_d * t * den * den,
        )

    def rho_dkernel_cm(self, kparams_cm, s):
        """Analytic :meth:`AdaptiveRobustifier.rho_dkernel_cm` (the same
        derivatives in closed form, ~40 elementwise passes in place of
        nested forward mode).  With a, b the inverse sigmas (the sorted
        ZeroToInf components, a ≥ b), P = w·a·E and Q = (1−w)·b the mixture
        terms (E = exp(s·h), h = (b² − a²)/2), p = P/(P+Q), q = 1 − p and
        ρ = s·b²/2 − log(P + Q): on the tangents of log a, log b, the
        ZeroToOne weight and s, every log-derivative of P and Q is P or Q
        times a coefficient c_X (d_X for Q), so with e_X = c_X − d_X

            ∂_X ρ      = ∂_X f − d_X − p·e_X
            ∂_X ∂_Y ρ  = ∂_X∂_Y f − p·∂_X c_Y − q·∂_X d_Y − p·q·e_X·e_Y

        (f = s·b²/2).  At a = b (where the sort is not differentiable)
        the first tangent takes a."""
        is1, is2, w = kparams_cm[0], kparams_cm[1], kparams_cm[2]
        swap = is1 < is2  # a is then the second stored component
        a, b = torch.where(swap, is2, is1), torch.where(swap, is1, is2)
        a2, b2 = a * a, b * b
        h = 0.5 * (b2 - a2)
        pa = w * a * torch.exp(s * h)
        qb = (1 - w) * b
        n = pa + qb
        p, q = pa / n, qb / n
        pq = p * q
        e_a, e_b, e_s = 1 - s * a2, s * b2 - 1, h  # e_w = 1
        g_a, g_b = -p * e_a, q * e_b
        h_aa = 2 * p * s * a2 - pq * e_a * e_a
        h_bb = 2 * q * s * b2 - pq * e_b * e_b
        h_ab = -pq * e_a * e_b
        # Tangent order: first stored sigma, second, weight, s.
        g0, g1 = torch.where(swap, g_b, g_a), torch.where(swap, g_a, g_b)
        h00, h11 = torch.where(swap, h_bb, h_aa), torch.where(swap, h_aa, h_bb)
        h_as = p * a2 - pq * e_a * e_s
        h_bs = q * b2 - pq * e_b * e_s
        h0s, h1s = torch.where(swap, h_bs, h_as), torch.where(swap, h_as, h_bs)
        h_aw, h_bw = -pq * e_a, -pq * e_b
        h0w, h1w = torch.where(swap, h_bw, h_aw), torch.where(swap, h_aw, h_bw)
        h_ww, h_ws, h_ss = w * (1 - w) - pq, -pq * e_s, -pq * e_s * e_s
        val = s * (0.5 * b2) - torch.log(n)
        dgrad = torch.stack([g0, g1, w - p, 0.5 * b2 - p * e_s])
        dhess = torch.stack([
            torch.stack([h00, h_ab, h0w, h0s]),
            torch.stack([h_ab, h11, h1w, h1s]),
            torch.stack([h0w, h1w, h_ww, h_ws]),
            torch.stack([h0s, h1s, h_ws, h_ss]),
        ])
        return val, dgrad, dhess


def _barron_core(x2, alpha, eps=1e-5):
    """Barron's smooth form of the general robust loss ρ(x, α), given x²
    (the scale already applied), with ε-guarded limits at α → 0 and α → 2
    (Barron, "A General and Adaptive Robust Loss Function", CVPR 2019)."""
    b = torch.abs(2.0 - alpha) + eps
    d = torch.where(alpha >= 0, alpha + eps, alpha - eps)
    return (b / d) * (torch.pow(x2 / b + 1.0, 0.5 * d) - 1.0)


def _barron_log_partition_table(n_alpha=129, x_max=60.0, n_x=16001):
    """log Z(α) = log ∫ exp(−ρ(x², α)) dx over α ∈ [0, 2]: the JAX
    package's host table, copied; the trapezoid rule is written out (as
    ``numpy.trapezoid`` computes it) so that it needs no particular numpy
    version."""
    alphas = np.linspace(0.0, 2.0, n_alpha)
    xs = np.linspace(-x_max, x_max, n_x)
    x2 = xs * xs
    eps = 1e-5
    b = np.abs(2.0 - alphas)[:, None] + eps
    d = np.where(alphas >= 0, alphas + eps, alphas - eps)[:, None]
    rho = (b / d) * (np.power(x2[None, :] / b + 1.0, 0.5 * d) - 1.0)
    dens = np.exp(-rho)
    z = (np.diff(xs) * (dens[:, 1:] + dens[:, :-1]) / 2.0).sum(axis=1)
    return alphas, np.log(z)


@functools.lru_cache(maxsize=None)
def _barron_table(dtype, device):
    """The table as tensors, built once per dtype and device, outside any
    ``torch.func`` transform (a first call inside nested ``jacfwd`` would
    otherwise cache tensors of that transform's level)."""
    with torch._C._DisableFuncTorch():
        return tuple(
            torch.as_tensor(t, dtype=dtype, device=device)
            for t in _barron_log_partition_table()
        )


def _interp(x, xp, fp):
    """``jnp.interp`` with constant extrapolation: the segment is found on
    the primal values, so forward-mode autodiff passes through the linear
    part (the slope of the segment to the right at a knot, as in JAX)."""
    n = xp.shape[0]
    i = torch.searchsorted(xp, x.detach().contiguous(), right=True).clamp(1, n - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    f = f0 + (x - x0) / (xp[i] - x0) * (fp[i] - f0)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


@dataclasses.dataclass(frozen=True)
class Barron(AdaptiveRobustifier):
    """Adaptive Barron general robust kernel with parameters ``[alpha, c]``:
    ½·ρ is the negative log-likelihood of Barron's probability model (data
    term plus the log c·Z(α) partition), which keeps the joint fit of
    (α, c) well posed."""

    @property
    def manifold(self):
        return BarronManifold()

    @staticmethod
    def make_params(alpha: float = 1.0, c: float = 1.0, dtype=torch.float64):
        if not (0.0 < alpha < 2.0):
            raise ValueError("alpha must be in (0, 2)")
        return torch.tensor([alpha, c], dtype=dtype)

    def rho(self, kparams, s):
        alpha, c = kparams[0], kparams[1]
        logz = _interp(alpha, *_barron_table(alpha.dtype, alpha.device))
        return 2.0 * _barron_core(s / (c * c), alpha) + 2.0 * (torch.log(c) + logz)


def em_fit(kparams, squared_errors, max_iters: int = 10, rtol: float = 1e-6):
    """Expectation-Maximization fit of ContaminatedGaussian parameters to
    squared errors (reference ``optimize(kernel, squarederrors)``,
    src/robustadaptive.jl:48-73): a host loop over device tensors with the
    reference's relative test (one host read per round).  Returns the new
    stored parameters ``[inv_s1, inv_s2, w]``."""
    sq = torch.as_tensor(squared_errors)
    n = sq.shape[0]
    total = sq.sum()
    sw = ContaminatedGaussian.sigmas_weight(kparams)
    for _ in range(max_iters):
        is1, is2, w = 1.0 / sw[0], 1.0 / sw[1], sw[2]
        wratio = ((1 - w) * is2) / (is1 * w)
        half_diff = 0.5 * (is1 * is1 - is2 * is2)  # >= 0
        # E-step: responsibility of the narrow component per error.
        resp = 1.0 / (1.0 + wratio * torch.exp(half_diff * sq))
        weighted = (resp * sq).sum()
        total_weight = resp.sum()
        # M-step.
        new = torch.stack([
            torch.sqrt(weighted / total_weight),
            torch.sqrt((total - weighted) / (n - total_weight)),
            total_weight / n,
        ])
        converged = bool(
            ((new - sw).abs() <= rtol * torch.maximum(new.abs(), sw.abs())).all()
        )
        sw = new
        if converged:
            break
    is1, is2 = 1.0 / sw[0], 1.0 / sw[1]
    return torch.stack([torch.maximum(is1, is2), torch.minimum(is1, is2), sw[2]])
