"""The plain reference of a BAL solve, in PyTorch only.

Written from BAL's published camera model (Agarwal, Snavely, Seitz, Szeliski,
"Bundle Adjustment in the Large", ECCV 2010; grail.cs.washington.edu/projects/bal):
a camera is [Rodrigues rotation w, translation t, focal f, radial k1, k2];
P = R(w)·X + t, p = −P.xy / P.z, and the predicted pixel is
f·(1 + k1·|p|² + k2·|p|⁴)·p.  The cost is ½ Σ |predicted − observed|².

:class:`Precision` fixes how it computes: ``F64`` is the yardstick (float64
throughout); ``TF32`` is the control, float32 with every matrix product's
inputs rounded to TF32's 10-bit mantissa and summed in float32, as the
tensor cores compute a TF32 product.  The rounding is done here, so the
control means the same on every device.

Nothing here imports the program under test; the benchmark hands this module
the same arrays it hands the program.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    dtype: torch.dtype
    tf32: bool

    def mm(self, a, b):
        """``a @ b`` at this precision."""
        if self.tf32:
            return torch.matmul(round_tf32(a), round_tf32(b))
        return torch.matmul(a, b)


F64 = Precision(torch.float64, False)
TF32 = Precision(torch.float32, True)


def round_tf32(x):
    """``x`` (float32) rounded to nearest at TF32's 10 mantissa bits (11
    significant bits), in elementwise arithmetic that ``vmap`` batches; the
    derivative passes straight through."""
    a = x.detach().abs()
    q = torch.exp2(torch.floor(torch.log2(torch.where(a > 0, a, torch.ones_like(a)))) - 10)
    q = torch.where(a / q >= 2048, q * 2, torch.where(a / q < 1024, q / 2, q))
    rounded = torch.where(a > 0, torch.round(x.detach() / q) * q, x.detach())
    return x + (rounded - x.detach())


def rotation(w, prec: Precision):
    """Rodrigues' rotation matrices ``[N, 3, 3]`` of angle-axis ``w [N, 3]``
    (the series at small angles)."""
    tt = (w * w).sum(-1)
    small = tt < 1e-14
    tts = torch.where(small, torch.ones_like(tt), tt)
    theta = torch.sqrt(tts)
    cos_t = torch.where(small, 1.0 - tt / 2.0, torch.cos(theta))
    sinc = torch.where(small, 1.0 - tt / 6.0, torch.sin(theta) / theta)
    omc = torch.where(small, 0.5 - tt / 24.0, (1.0 - cos_t) / tts)
    zero = torch.zeros_like(tt)
    wx = torch.stack([zero, -w[:, 2], w[:, 1], w[:, 2], zero, -w[:, 0],
                      -w[:, 1], w[:, 0], zero], -1).view(-1, 3, 3)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    outer = prec.mm(w[:, :, None], w[:, None, :])
    return cos_t[:, None, None] * eye + sinc[:, None, None] * wx + omc[:, None, None] * outer


def project(cam, pt, prec: Precision):
    """Predicted pixels ``[N, 2]`` of points ``pt [N, 3]`` in cameras
    ``cam [N, 9]``."""
    p = prec.mm(rotation(cam[:, :3], prec), pt[:, :, None])[:, :, 0] + cam[:, 3:6]
    xp = -p[:, :2] / p[:, 2:3]
    r2 = (xp * xp).sum(-1, keepdim=True)
    return cam[:, 6:7] * (1.0 + r2 * (cam[:, 7:8] + cam[:, 8:9] * r2)) * xp


class Data:
    """The observations on a device: camera and point index ``[K]`` (sorted by
    point, as the generator makes them) and observed pixels ``[K, 2]``."""

    def __init__(self, cam_idx, pt_idx, observations, device, prec: Precision = F64):
        self.prec = prec
        self.device = torch.device(device)
        self.cam_idx = torch.as_tensor(cam_idx, dtype=torch.long, device=self.device)
        self.pt_idx = torch.as_tensor(pt_idx, dtype=torch.long, device=self.device)
        self.obs = torch.as_tensor(observations, device=self.device).to(prec.dtype)
        self.ncam = int(self.cam_idx.max()) + 1
        self.npt = int(self.pt_idx.max()) + 1

    def values(self, cams, pts):
        return (torch.as_tensor(cams, device=self.device).to(self.prec.dtype),
                torch.as_tensor(pts, device=self.device).to(self.prec.dtype))

    def blocks(self, rows=1 << 18):
        k = self.cam_idx.shape[0]
        for a in range(0, k, rows):
            yield slice(a, min(a + rows, k))

    def cost(self, cams, pts) -> float:
        """½ Σ |r|², summed in blocks of observations."""
        cams, pts = self.values(cams, pts)
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for s in self.blocks():
            r = project(cams[self.cam_idx[s]], pts[self.pt_idx[s]], self.prec) - self.obs[s]
            total += 0.5 * (r * r).sum().double()
        return float(total)

    def linearize(self, cams, pts):
        """Residuals and the per-observation Jacobian blocks: ``r [K, 2]``,
        ``jc [K, 2, 9]``, ``jp [K, 2, 3]`` (forward-mode derivatives of
        :func:`project`)."""
        prec = self.prec

        def one(c, p):
            return project(c[None], p[None], prec)[0]

        jac = torch.func.vmap(torch.func.jacfwd(one, argnums=(0, 1)))
        out_r, out_c, out_p = [], [], []
        for s in self.blocks():
            c, p = cams[self.cam_idx[s]], pts[self.pt_idx[s]]
            jc, jp = jac(c, p)
            out_r.append(project(c, p, prec) - self.obs[s])
            out_c.append(jc)
            out_p.append(jp)
        return torch.cat(out_r), torch.cat(out_c), torch.cat(out_p)


def _sym_solve(m, rhs):
    """Solve ``m x = rhs`` for a symmetric positive matrix (Cholesky; a
    least-squares solve where the factorization fails)."""
    chol, info = torch.linalg.cholesky_ex(m)
    if int(info) == 0:
        return torch.cholesky_solve(rhs[:, None], chol)[:, 0]
    return torch.linalg.lstsq(m.double(), rhs.double()[:, None]).solution[:, 0].to(m.dtype)


def gauge_dofs(ncam: int) -> list:
    """Seven camera dofs that fix BAL's similarity gauge: camera 0's rotation
    and translation, and the first translation component of the camera
    half-way round (the scale).  The cost is the same along the gauge, so
    its minimum is too."""
    return list(range(6)) + [9 * (ncam // 2) + 3]


def damped_step(data: Data, cams, pts, lam: float, lmk_block: int = 8192, gauge=None):
    """The Levenberg-Marquardt step at ``lam`` through the reduced camera
    system: both diagonals scaled by (1 + λ) (Marquardt), the points eliminated, the
    reduced system formed as dense products over blocks of points and
    solved, the points back-substituted; the camera dofs ``gauge`` held.
    Returns ``(d_cams, d_pts)``."""
    prec, dev, dt = data.prec, data.device, data.prec.dtype
    r, jc, jp = data.linearize(cams, pts)
    nc, npt = data.ncam, data.npt
    ci, pi = data.cam_idx, data.pt_idx
    jct, jpt = jc.transpose(1, 2), jp.transpose(1, 2)
    a = torch.zeros(nc, 9, 9, dtype=dt, device=dev).index_add_(0, ci, prec.mm(jct, jc))
    bc = torch.zeros(nc, 9, dtype=dt, device=dev).index_add_(0, ci, prec.mm(jct, r[:, :, None])[:, :, 0])
    h = torch.zeros(npt, 3, 3, dtype=dt, device=dev).index_add_(0, pi, prec.mm(jpt, jp))
    bp = torch.zeros(npt, 3, dtype=dt, device=dev).index_add_(0, pi, prec.mm(jpt, r[:, :, None])[:, :, 0])
    w = prec.mm(jpt, jc)  # [K, 3, 9]: the point-camera coupling of each observation
    a = a + torch.diag_embed(torch.diagonal(a, dim1=1, dim2=2) * lam)
    h = h + torch.diag_embed(torch.diagonal(h, dim1=1, dim2=2) * lam)
    del jc, jp, jct, jpt
    h_inv = torch.linalg.inv(h)
    dc = nc * 9
    s = torch.zeros(dc, dc, dtype=dt, device=dev)
    s.view(nc, 9, nc, 9).diagonal(dim1=0, dim2=2).copy_(a.permute(1, 2, 0))
    rhs = bc.reshape(-1).clone()
    bounds = torch.searchsorted(pi, torch.arange(0, npt + lmk_block, lmk_block, device=dev))
    for b, p0 in enumerate(range(0, npt, lmk_block)):
        k0, k1 = int(bounds[b]), int(bounds[b + 1])
        if k0 == k1:
            continue
        n = min(lmk_block, npt - p0)
        wd = torch.zeros(n, 3, nc, 9, dtype=dt, device=dev)
        wd.permute(0, 2, 1, 3).index_put_((pi[k0:k1] - p0, ci[k0:k1]), w[k0:k1], accumulate=True)
        wd = wd.view(n, 3, dc)
        y = prec.mm(h_inv[p0:p0 + n], wd)  # H⁻¹ W per point
        s -= prec.mm(y.reshape(-1, dc).T, wd.reshape(-1, dc))
        rhs -= prec.mm(y.reshape(-1, dc).T, bp[p0:p0 + n].reshape(-1, 1))[:, 0]
    if gauge is not None:  # held dofs: their rows and columns replaced by the identity
        s[gauge, :] = 0.0
        s[:, gauge] = 0.0
        s[gauge, gauge] = 1.0
        rhs[gauge] = 0.0
    d_cams = -_sym_solve(s, rhs).view(nc, 9)
    coupled = prec.mm(w, d_cams[ci][:, :, None])[:, :, 0]  # W δc per observation
    t = bp + torch.zeros(npt, 3, dtype=dt, device=dev).index_add_(0, pi, coupled)
    d_pts = -prec.mm(h_inv, t[:, :, None])[:, :, 0]
    return d_cams, d_pts


def solve(data: Data, cams, pts, max_iters: int = 30, rel_dcost: float = 1e-10,
          lam: float = 1e-4):
    """Levenberg-Marquardt from ``(cams, pts)``, the gauge held
    (:func:`gauge_dofs`), until the relative decrease of the cost falls
    under ``rel_dcost`` (or ``max_iters``); returns the best ``(cams, pts,
    cost)``."""
    cams, pts = data.values(cams, pts)
    c = data.cost(cams, pts)
    gauge = gauge_dofs(data.ncam)
    for _ in range(max_iters):
        dcam, dpt = damped_step(data, cams, pts, lam, gauge=gauge)
        nc_, np_ = cams + dcam, pts + dpt
        cn = data.cost(nc_, np_)
        if cn < c:
            done = (c - cn) < rel_dcost * c
            cams, pts, c, lam = nc_, np_, cn, max(lam / 10.0, 1e-12)
            if done:
                break
        else:
            lam *= 10.0
            if lam > 1e4:  # no step at any damping decreases the cost: converged
                break
    return cams, pts, c
