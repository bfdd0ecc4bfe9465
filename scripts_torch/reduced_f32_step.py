"""The float32 reduced direct step of
``tests/test_torch_bal.py::test_float32_reduced_solve_is_equilibrated``
(the chunk-bucket BAL shape, three float64 LM iterations, then one damped
solve of the float32 system at that λ), on this host's CPU:

    python scripts_torch/reduced_f32_step.py

Prints one JSON line: the cost change of the float64 step (``d64``), of
the port's float32 step (``d32``) and, where the JAX package can be
imported, of its float32 step (``dj``, through its own reduction and
solve), each float32 one's relative distance from ``d64``; and the
backward error of the port's reduced solve as a solution of the
equilibrated system it solves, beside unscaled LU's, in units of float32's
ε, with the test's bound √n (n the reduced size).  The JAX package is
optional: a host without it (the card's machine) prints the port's
figures only.
"""

import json
import pathlib
import platform
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import nllstpu_torch as pt  # noqa: E402
from nllstpu_torch.core import linearsolver  # noqa: E402
from nllstpu_torch.core.optimize import run_loop  # noqa: E402
from nllstpu_torch.models import bal as tbal  # noqa: E402
from nllstpu_torch.models.ba import perturb_ba  # noqa: E402

#: The test's shape: ``make_realistic_bal`` arguments, perturbation.
ARGS = dict(ncameras=80, npoints=160, seed=3, noise=1e-3, track_alpha=1.0, max_track=80)


def scaled_backward_error(s, rhs, x):
    """As ``tests/test_torch_bal.py:_scaled_backward_error``."""
    s, rhs, x = s.double(), rhs.double(), x.double()
    d = torch.diagonal(s).abs().rsqrt()
    res = d * (rhs - s @ x)
    sd = d[:, None] * s * d[None, :]
    return float(res.abs().max() / (sd.abs().sum(1).max() * (x / d).abs().max()
                                    + (d * rhs).abs().max()))


def jax_delta(data, values, lam, tc, cost0):
    """The JAX package's float32 step's cost change, or None without it."""
    try:
        import jax
    except ImportError:
        return None
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import nllstpu as nt
    from nllstpu.core.optimize import compile_problem as jax_compile
    from nllstpu.models import bal as jbal

    jp, _, _ = jbal.make_bal_problem(data, dtype=jnp.float64)
    jp.set_values({k: t.numpy() for k, t in values.items()})
    jc = jax_compile(jp, solver="schur", schur_family=jbal.PT)
    _, sys_j = jax.jit(jc.assemble)(jp.stacked_variables())
    sys_j32 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a, sys_j)
    x_j = jax.jit(jc.ctx(nt.Options()).ops().solve)(sys_j32, jnp.float32(lam))
    x_j = torch.from_numpy(np.array(x_j, dtype=np.float64))
    return float(tc.cost(tc.apply(values, x_j)) - cost0)


def main():
    data = tbal.make_realistic_bal(**ARGS)
    tp, _, tpts = tbal.make_bal_problem(data, dtype=torch.float64, device="cpu")
    perturb_ba(tp, tpts, 0.05, seed=5)
    tc = pt.compile_problem(tp, solver="schur", schur_family=tbal.PT)
    st = run_loop(tc.assemble, tc.cost, tc.ctx(), pt.Options(
        schur_family=tbal.PT, max_iters=3, rel_dcost=0.0, abs_dcost=0.0,
    ), tp.stacked_variables())
    lam = float(st["itdata"]["lm_lambda"])
    v = st["variables"]
    cost0, sys64 = tc.assemble(v)
    ops = tc.ctx().linops
    sys32 = tuple(t.float() for t in sys64)
    d64, d32 = (float(tc.cost(tc.apply(v, ops.solve(s, lam).double())) - cost0)
                for s in (sys64, sys32))
    s32, rhs32, _ = ops.reduced(sys32, lam)
    eps = float(torch.finfo(torch.float32).eps)
    n = s32.shape[0]
    out = dict(
        host=platform.processor() or platform.machine(), torch=torch.__version__,
        threads=torch.get_num_threads(), lam=lam, d64=d64, d32=d32,
        d32_rel=abs(d32 - d64) / abs(d64), n=n, bound_eps=n ** 0.5,
        eta_port_eps=scaled_backward_error(s32, rhs32,
                                           linearsolver.cholesky_solve(s32, rhs32)) / eps,
        eta_unscaled_lu_eps=scaled_backward_error(s32, rhs32,
                                                  torch.linalg.solve(s32, rhs32)) / eps,
    )
    dj = jax_delta(data, v, lam, tc, cost0)
    if dj is not None:
        out.update(dj=dj, dj_rel=abs(dj - d64) / abs(d64))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
