"""Variable-block manifolds: tangent dimension + batched retraction.

Port of ``nllstpu/core/manifolds.py`` for the slices the solver's paths
need: ``Euclidean``, ``SO3`` and ``SE3`` (with ``so3_exp`` and
``so3_log``), and the scalar and
kernel-parameter manifolds of the adaptive robust kernels (``Scalar``,
``ZeroToInf``, ``ZeroToOne``, ``ContaminatedGaussianManifold``,
``BarronManifold``).  A manifold's ``retract`` takes a whole stacked family
at once — ``xs [n, *shape]`` and ``deltas [n, dof]`` — which is what the
JAX package obtains by vmapping its per-variable retraction; ``retract_cm``
takes components-major ``x_cm [ambient, B]`` and ``delta_cm [dof, B]``, the
form an adaptive kernel's derivatives are pushed through.

Invariant: ``retract(x, 0) == x``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Manifold:
    """Base class.  Subclasses define ``dof``, ``shape`` and ``retract``.
    Instances are hashable and double as the family key (see
    :func:`nllstpu_torch.core.problem.family_name`)."""

    @property
    def dof(self) -> int:
        raise NotImplementedError

    @property
    def shape(self) -> tuple:
        raise NotImplementedError

    def retract(self, xs, deltas):
        """``xs [n, *shape]`` ⊞ ``deltas [n, dof]``."""
        raise NotImplementedError

    def retract_cm(self, x_cm, delta_cm):
        """Components-major ``x_cm [ambient, B]`` ⊞ ``delta_cm [dof, B]``.
        The default goes through :meth:`retract` on the transposed batch,
        as the JAX package's default vmaps its per-variable retraction;
        manifolds with components-major math override it."""
        b = x_cm.shape[-1]
        out = self.retract(x_cm.T.reshape((b,) + self.shape), delta_cm.T)
        return out.reshape(b, -1).T

    @property
    def ambient(self) -> int:
        """Number of scalars in the stored representation."""
        size = 1
        for s in self.shape:
            size *= s
        return size


@dataclasses.dataclass(frozen=True)
class Euclidean(Manifold):
    """Fixed-length Euclidean vector (reference ``EuclideanVector{N}``)."""

    n: int

    @property
    def dof(self):
        return self.n

    @property
    def shape(self):
        return (self.n,)

    def retract(self, xs, deltas):
        return xs + deltas

    def retract_cm(self, x_cm, delta_cm):
        return x_cm + delta_cm


@dataclasses.dataclass(frozen=True)
class Scalar(Manifold):
    """Scalar variable (reference ``Number``), stored with shape ()."""

    @property
    def dof(self):
        return 1

    @property
    def shape(self):
        return ()

    def retract(self, xs, deltas):
        return xs + deltas[:, 0]

    def retract_cm(self, x_cm, delta_cm):
        return x_cm + delta_cm


def _positive_scale(val, delta):
    """max(val, tiny)·exp(delta), floored at the smallest normal number so
    that a flush of subnormals to zero cannot break positivity (the JAX
    package's ``_positive_scale``)."""
    tiny = torch.finfo(val.dtype).tiny
    return torch.clamp(torch.where(val > 0, val, tiny) * torch.exp(delta), min=tiny)


def _zero_to_one_update(val, delta):
    """v' = v·eᵈ / (1 + v·eᵈ − v), and 1 where v·eᵈ overflows (reference
    src/variable.jl:29-32)."""
    scaled = _positive_scale(val, delta)
    out = scaled / (1 + (scaled - val))
    return torch.where(torch.isinf(scaled), torch.ones_like(out), out)


@dataclasses.dataclass(frozen=True)
class ZeroToInf(Manifold):
    """Strictly positive scalar with a multiplicative-exponential update
    (reference ``ZeroToInfScalar``)."""

    @property
    def dof(self):
        return 1

    @property
    def shape(self):
        return ()

    def retract(self, xs, deltas):
        return _positive_scale(xs, deltas[:, 0])

    def retract_cm(self, x_cm, delta_cm):
        return _positive_scale(x_cm, delta_cm)


@dataclasses.dataclass(frozen=True)
class ZeroToOne(Manifold):
    """Scalar constrained to (0, 1) (reference ``ZeroToOneScalar``)."""

    @property
    def dof(self):
        return 1

    @property
    def shape(self):
        return ()

    def retract(self, xs, deltas):
        return _zero_to_one_update(xs, deltas[:, 0])

    def retract_cm(self, x_cm, delta_cm):
        return _zero_to_one_update(x_cm, delta_cm)


def _contaminated_gaussian_update(is1, is2, w, d1, d2, d3):
    """The inverse sigmas on ZeroToInf, the weight on ZeroToOne, then the
    sigmas sorted so that the first component stays the narrowest; the
    weight is not swapped with them, as in the reference."""
    a = _positive_scale(is1, d1)
    b = _positive_scale(is2, d2)
    return torch.maximum(a, b), torch.minimum(a, b), _zero_to_one_update(w, d3)


@dataclasses.dataclass(frozen=True)
class ContaminatedGaussianManifold(Manifold):
    """Parameters ``[inv_sigma1, inv_sigma2, w]`` of the two-component
    Gaussian-mixture kernel (reference ``ContaminatedGaussian``,
    src/robustadaptive.jl:3-23)."""

    @property
    def dof(self):
        return 3

    @property
    def shape(self):
        return (3,)

    def retract(self, xs, deltas):
        return torch.stack(_contaminated_gaussian_update(*xs.T, *deltas.T), dim=1)

    def retract_cm(self, x_cm, delta_cm):
        return torch.stack(_contaminated_gaussian_update(*x_cm, *delta_cm))


def _barron_update(alpha, c, d1, d2):
    """Shape α ∈ (0, 2) by the ZeroToOne update of α/2, scale c ∈ (0, ∞)."""
    return 2.0 * _zero_to_one_update(alpha * 0.5, d1), _positive_scale(c, d2)


@dataclasses.dataclass(frozen=True)
class BarronManifold(Manifold):
    """Parameters ``[alpha, c]`` of the adaptive Barron kernel."""

    @property
    def dof(self):
        return 2

    @property
    def shape(self):
        return (2,)

    def retract(self, xs, deltas):
        return torch.stack(_barron_update(*xs.T, *deltas.T), dim=1)

    def retract_cm(self, x_cm, delta_cm):
        return torch.stack(_barron_update(*x_cm, *delta_cm))


def _skew(w):
    """``w [n, 3]`` → ``[n, 3, 3]`` cross-product matrices."""
    wx, wy, wz = w[:, 0], w[:, 1], w[:, 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w):
    """Batched Rodrigues' formula ``w [n, 3]`` → ``[n, 3, 3]``, Taylor-guarded
    at w = 0 exactly as the JAX package's ``so3_exp``."""
    t2 = (w * w).sum(dim=-1)
    small = t2 < 1e-12
    t2s = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / t2s)
    k = _skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[:, None, None] * k + b[:, None, None] * (k @ k)


def so3_log(r):
    """Axis-angle vector of rotation matrices ``r [..., 3, 3]`` →
    ``[..., 3]``, the inverse of :func:`so3_exp`, as the JAX package's
    ``so3_log``: θ from ``atan2(|vee|/2, (tr − 1)/2)`` (smooth at the
    identity, where arccos is not), θ/(2 sin θ) with a Taylor guard at
    |vee|² < 1e-12.  At θ → π, vee → 0 and the guard takes the identity's
    branch, as in the JAX package (accurate below π − 1e-3)."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    vee = torch.stack(
        [r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
         r[..., 1, 0] - r[..., 0, 1]], dim=-1,
    )
    s2 = (vee * vee).sum(dim=-1)  # (2 sin θ)²
    small = s2 < 1e-12
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))  # 2 sin θ
    theta = torch.atan2(torch.where(small, torch.zeros_like(s), s), trace - 1.0)
    factor = torch.where(small, 0.5 + s2 / 48.0, theta / s)
    return factor[..., None] * vee


@dataclasses.dataclass(frozen=True)
class SO3(Manifold):
    """Rotation stored as a 3x3 matrix with 3 DoF: R ⊞ w = R·exp([w]×)."""

    @property
    def dof(self):
        return 3

    @property
    def shape(self):
        return (3, 3)

    def retract(self, xs, deltas):
        return xs @ so3_exp(deltas)


@dataclasses.dataclass(frozen=True)
class SE3(Manifold):
    """Rigid transform stored as a 3x4 matrix [R | t] with 6 DoF
    (rotation tangent first): [R|t] ⊞ (w, v) = [R·exp([w]×) | t + R·v]."""

    @property
    def dof(self):
        return 6

    @property
    def shape(self):
        return (3, 4)

    def retract(self, xs, deltas):
        r = xs[:, :, :3]
        t = xs[:, :, 3]
        r_new = r @ so3_exp(deltas[:, :3])
        t_new = t + (r @ deltas[:, 3:, None])[:, :, 0]
        return torch.cat([r_new, t_new[:, :, None]], dim=2)
