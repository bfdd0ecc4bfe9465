"""Adaptive ContaminatedGaussian kernel fitting (the port of
examples/adaptivekernel.py, the reference's examples/adaptivekernel.jl):
the mixture's parameters and a mean fitted jointly over a contaminated
sample, then set against the EM fit; an optional HTML slider view.

Run:  python examples_torch/adaptivekernel.py [--cpu] [--html out.html]
"""

import numpy as np
import torch

from _device import arg_after, device

import nllstpu_torch as nt

KERNEL = nt.ContaminatedGaussian()


def measurement(d, m):
    """One residual function for every cost: costs added with the same
    function object group into one batch."""
    return m - d


def main():
    rng = np.random.default_rng(0)
    data = np.concatenate([rng.normal(3.0, 1.0, 450), rng.normal(3.0, 12.0, 50)])
    p = nt.Problem(dtype=torch.float64, device=device())
    kvar = p.add_variable(KERNEL.manifold, nt.ContaminatedGaussian.make_params(0.5, 5.0, 0.5))
    mean = p.add_variable(nt.Scalar(), 0.0)
    for d in data:
        p.add_cost(measurement, (kvar, mean), params=d, kernel=KERNEL)
    result = nt.optimize(p, nt.Options(iterator=nt.LEVENBERG_MARQUARDT))
    sw = nt.ContaminatedGaussian.sigmas_weight(p.get_value(kvar)).numpy()
    m_fit = float(p.get_value(mean))
    print(result)
    print(f"\njoint LM fit: sigma1={sw[0]:.3f} sigma2={sw[1]:.3f} w={sw[2]:.3f} "
          f"mean={m_fit:.3f}")
    print("ground truth: sigma1=1.0  sigma2=12.0  w=0.9  mean=3.0")
    sq = torch.as_tensor((data - m_fit) ** 2, dtype=torch.float64)
    em = nt.em_fit(nt.ContaminatedGaussian.make_params(0.5, 5.0, 0.5), sq, 50)
    ew = nt.ContaminatedGaussian.sigmas_weight(em).numpy()
    print(f"EM fit:       sigma1={ew[0]:.3f} sigma2={ew[1]:.3f} w={ew[2]:.3f}")

    out = arg_after("--html")
    if out:
        from _htmlviz import write_adaptive_html

        sw0 = np.array([0.5, 5.0, 0.5])
        xs = np.linspace(data.min() - 2, data.max() + 2, 241)
        r = xs - m_fit
        frames, labels = [], []
        for t in np.linspace(0.0, 1.0, 25):
            s1 = sw0[0] * (sw[0] / sw0[0]) ** t  # log interpolation (positive)
            s2 = sw0[1] * (sw[1] / sw0[1]) ** t
            w = (1 - t) * sw0[2] + t * sw[2]
            dens = (w * np.exp(-0.5 * (r / s1) ** 2) / (s1 * np.sqrt(2 * np.pi))
                    + (1 - w) * np.exp(-0.5 * (r / s2) ** 2) / (s2 * np.sqrt(2 * np.pi)))
            kp = nt.ContaminatedGaussian.make_params(s1, s2, w)
            rho = KERNEL.rho(kp, torch.as_tensor(r * r)).numpy()
            rho = rho - rho.min()
            frames.append({"sw": [float(s1), float(s2), float(w)], "mean": m_fit,
                           "density": [float(v) for v in dens], "rho": [float(v) for v in rho]})
            labels.append(f"t={t:.2f}  σ₁={s1:.2f} σ₂={s2:.2f} w={w:.2f}"
                          + ("  (initial guess)" if t == 0 else "")
                          + ("  (converged fit)" if t == 1 else ""))
        write_adaptive_html(out, data, frames, xs, labels)
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
