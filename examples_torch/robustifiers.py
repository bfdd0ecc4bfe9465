"""Robust kernels' ρ, ρ′ and ρ″ over a sweep of squared norms (the port of
examples/robustifiers.py, the reference's examples/robustifiers.jl as a
table), with an optional matplotlib plot.

Run:  python examples_torch/robustifiers.py [--cpu] [--plot out.png]
"""

import numpy as np
import torch

from _device import arg_after, device

import nllstpu_torch as nt


def main():
    kernels = {
        "NoRobust": nt.NoRobust(),
        "Huber(1.5)": nt.Huber(1.5),
        "Huber2o(1.5)": nt.Huber2o(1.5),
        "GemanMcclure(1.5)": nt.GemanMcclure(1.5),
        "Scaled(Huber, 2)": nt.Scaled(nt.Huber(1.5), 2.0),
    }
    s = torch.linspace(0.0, 16.0, 9, dtype=torch.float64, device=device())
    for name, k in kernels.items():
        rho, d1, d2 = (v.cpu().numpy() for v in k.rho_dc(s))
        print(f"\n=== {name} ===")
        print("s   :", " ".join(f"{v:8.3f}" for v in s.cpu().numpy()))
        print("rho :", " ".join(f"{v:8.3f}" for v in rho))
        print("rho':", " ".join(f"{v:8.3f}" for v in d1))
        print('rho"', " ".join(f"{v:8.4f}" for v in d2))
    cg = nt.ContaminatedGaussian()
    kp = nt.ContaminatedGaussian.make_params(1.0, 10.0, 0.8).to(s.device)
    rho = torch.stack([cg.rho(kp, si) for si in s]).cpu().numpy()
    print("\n=== ContaminatedGaussian(1, 10, 0.8) ===")
    print("rho :", " ".join(f"{v:8.3f}" for v in rho))

    out = arg_after("--plot")
    if out:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib not available; skipping plot")
            return
        ss = torch.linspace(0.0, 16.0, 200, dtype=torch.float64, device=s.device)
        fig, ax = plt.subplots(figsize=(6, 4))
        for name, k in kernels.items():
            ax.plot(np.sqrt(ss.cpu().numpy()), k.rho(ss).cpu().numpy(), label=name)
        ax.set_xlabel("|r|")
        ax.set_ylabel("rho(|r|^2)")
        ax.legend()
        fig.savefig(out, dpi=120, bbox_inches="tight")
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
