"""The port's own spread of ``optimize_singles`` on ``chip_smoke.py``'s
float32 singles problems: each case run three times with its start scaled
by 1 and 1 ± 2⁻²³ (float32's ulp), as ``scripts_torch/item6_reference.py``
runs the JAX package.  On the CPU (the plain version of every sum) by
default; ``--cuda`` runs the same on the card (B6's sums):

    python scripts_torch/singles_spread.py [--cuda] [Dubrovnik-class] [bench-realistic]

Prints, per run, the summed iterations and the final cost (float64 at the
final values), as ``chip_smoke.py``'s phase 21 does.  Phase 21 holds the
card's Dubrovnik-class sum to the CPU runs (``SINGLES_REF[...][
"port_cpu"]``).
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
import nllstpu_torch as nt  # noqa: E402
from nllstpu_torch.models.bal import PT  # noqa: E402

SCALES = (1.0, 1.0 + 2.0**-23, 1.0 - 2.0**-23)

if __name__ == "__main__":
    args = sys.argv[1:]
    device = torch.device("cuda" if "--cuda" in args else "cpu")
    names = [a for a in args if a != "--cuda"] or ["Dubrovnik-class", "bench-realistic"]
    for name in names:
        ref = chip_smoke.SINGLES_REF[name]
        iters = []
        for scale in SCALES:
            data, problem, points = chip_smoke.singles_problem(name, device)
            problem.set_values({k: (v.double() * scale).to(v.dtype)
                                for k, v in problem.stacked_variables().items()})
            t0 = time.perf_counter()
            out = nt.optimize_singles(problem, nt.Options(iterator=ref["iterator"],
                                                          **ref.get("options", {})),
                                      targets=PT)
            iters.append(sum(out.values()))
            print(f"{name} singles on {device.type}, start scaled by {scale!r}: {iters[-1]} "
                  f"iterations in {time.perf_counter() - t0:.1f} s, final cost "
                  f"{chip_smoke.cost64(data, problem, device)!r}", flush=True)
            del problem, data
        print(f"{name}: the port's runs on {device.type} {tuple(iters)}, JAX "
              f"{ref['iterations']} (final {ref['final']})", flush=True)
