"""Robust 1-D curve fitting (port of ``nllstpu/models/curvefit.py``;
BASELINE.json's "Robust 1D curve fitting sweeping all robustifiers"): the
exponential model y = exp(m·x + c) with outlier-contaminated samples, one
per-cost residual per sample, fitted under any fixed robust kernel.  The
data come from the JAX package's generator, seed for seed."""

from __future__ import annotations

import numpy as np
import torch

from ..core.manifolds import Euclidean
from ..core.problem import Problem

PARAMS = Euclidean(2)  # [m, c]


def exp_residual(sample, mc):
    x, y = sample[0], sample[1]
    return torch.exp(mc[0] * x + mc[1]) - y


def curve_data(n=100, m=0.3, c=0.1, noise=0.02, outlier_frac=0.15, seed=0):
    """``[n, 2]`` samples (x, y) with one-sided gross outliers."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(0.0, 5.0, n)
    ys = np.exp(m * xs + c) + rng.standard_normal(n) * noise
    n_out = int(n * outlier_frac)
    out_idx = rng.choice(n, size=n_out, replace=False)
    ys[out_idx] += rng.uniform(2.0, 5.0, n_out)
    return np.stack([xs, ys], axis=1)


def make_curve_fit(n=100, m=0.3, c=0.1, noise=0.02, outlier_frac=0.15, kernel=None, seed=0,
                   dtype=None, device=None):
    """Synthetic exponential-curve data with gross outliers; returns
    ``(problem, params_handle, ground_truth)``."""
    p = Problem(dtype=dtype, device=device)
    mc = p.add_variable(PARAMS, np.zeros(2))
    p.add_cost_batch(
        exp_residual,
        slots=[(PARAMS, np.zeros(n, np.int32))],
        params=curve_data(n, m, c, noise, outlier_frac, seed),
        kernel=kernel,
        batched=False,
    )
    return p, mc, np.array([m, c])
