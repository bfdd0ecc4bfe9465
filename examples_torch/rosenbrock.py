"""Rosenbrock with all four iterators (the port of examples/rosenbrock.py,
the reference's examples/rosenbrock.jl without GLMakie): the cost
trajectory of each optimizer, an optional HTML trajectory view and an
optional matplotlib plot.

Run:  python examples_torch/rosenbrock.py [--cpu] [--html out.html] [--plot out.png]
"""

import numpy as np
import torch

from _device import arg_after, device

import nllstpu_torch as nt
from nllstpu_torch.models.rosenbrock import make_rosenbrock


def start(iterator):
    return (1.0 - 1e-2, 1.0) if iterator == nt.GRADIENT_DESCENT else (-0.5, 2.5)


def main():
    trajectories = {}
    for iterator in (nt.NEWTON, nt.LEVENBERG_MARQUARDT, nt.DOGLEG, nt.GRADIENT_DESCENT):
        x0, y0 = start(iterator)
        p, x, y = make_rosenbrock(x0=x0, y0=y0, dtype=torch.float64, device=device())
        ct = nt.CostTrajectory()
        result = nt.optimize(p, nt.Options(iterator=iterator),
                             callback=nt.store_costs_callback(ct))
        sol = float(p.get_value(x)), float(p.get_value(y))
        trajectories[iterator] = (ct, result, *sol)
        print(f"\n=== {iterator} ===")
        print(result)
        print(f"solution: ({sol[0]:.10f}, {sol[1]:.10f})")
        print("costs:", " ".join(f"{c:.3e}" for c in ct.costs[:10]),
              "..." if len(ct.costs) > 10 else "")

    out = arg_after("--html")
    if out:
        from _htmlviz import write_rosenbrock_html

        x0g, x1g, y0g, y1g = -1.6, 1.6, -0.6, 2.8
        xx, yy = np.meshgrid(np.linspace(x0g, x1g, 160), np.linspace(y0g, y1g, 120))
        a, b = 1.0, 10.0
        cost_grid = 0.5 * ((a * (1.0 - xx)) ** 2 + (b * (yy - xx * xx)) ** 2)
        paths, costs = {}, {}
        for name, (ct, _, _, _) in trajectories.items():
            p0 = np.array(start(name))
            steps = np.array([np.asarray(s).reshape(-1) for s in ct.trajectory])
            paths[name] = np.vstack([p0, p0 + np.cumsum(steps, axis=0)]).tolist()
            c0 = 0.5 * ((a * (1.0 - p0[0])) ** 2 + (b * (p0[1] - p0[0] ** 2)) ** 2)
            costs[name] = [c0] + list(ct.costs)
        write_rosenbrock_html(out, np.log10(np.maximum(cost_grid, 1e-12)),
                              (x0g, x1g, y0g, y1g), paths, costs)
        print(f"wrote {out}")

    out = arg_after("--plot")
    if out:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib not available; skipping plot")
            return
        fig, ax = plt.subplots(figsize=(6, 4))
        for name, (ct, _, _, _) in trajectories.items():
            ax.semilogy(np.maximum(ct.costs, 1e-30), label=name)
        ax.set_xlabel("iteration")
        ax.set_ylabel("cost")
        ax.legend()
        fig.savefig(out, dpi=120, bbox_inches="tight")
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
