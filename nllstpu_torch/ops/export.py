"""Hessian export (port of ``nllstpu/ops/export.py``; reference
BlockSparseMatrix's ``Matrix``, ``sparse`` and ``symmetrifyfull``): the
assembled normal equations of a compiled problem, whatever its backend,
dense or as COO triplets, and the covariance as the inverse of the
(damped) Hessian.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import engine


def _host(batch):
    """A device batch's index and mask arrays back on the host."""
    return dataclasses.replace(
        batch,
        idx=tuple(np.asarray(i.cpu()) for i in batch.idx),
        mask=np.asarray(batch.mask.cpu()),
    )


def hessian_dense(compiled, variables=None):
    """``(H [D, D], g [D])`` as dense tensors, whatever the compiled
    backend: :func:`engine.assemble_dense` over the compiled batches, every
    entry summed by kernel B6 in a fixed order (the compile's own dense
    plan, or one built here over its layout)."""
    if variables is None:
        raise ValueError("pass the stacked variables dict")
    plan = compiled.dense_plan
    if plan is None:
        plan = engine.dense_plan([_host(b) for b in compiled.batches], compiled.layout,
                                 compiled.device)
    _, (a, b) = engine.assemble_dense(compiled.batches, variables, plan,
                                      compiled.kernels.segment_sum)
    return a, b


def hessian_coo(compiled, variables):
    """The symmetric Hessian as COO triplets ``(rows, cols, vals)`` (numpy)
    with duplicates NOT summed (``scipy.sparse.coo_matrix`` sums them):
    every real cost's block at its rows, fixed variables left out."""
    d = compiled.layout.dof_total
    rows_out, cols_out, vals_out = [], [], []
    for batch in compiled.batches:
        _, _, h = engine.batch_grad_hess(batch, variables)
        r = engine.batch_rows(_host(batch), compiled.layout)
        hv = h.detach().cpu().numpy()
        bsz, s = r.shape
        rr = np.broadcast_to(r[:, :, None], (bsz, s, s))
        cc = np.broadcast_to(r[:, None, :], (bsz, s, s))
        keep = (rr < d) & (cc < d)
        rows_out.append(rr[keep])
        cols_out.append(cc[keep])
        vals_out.append(hv[keep])
    return np.concatenate(rows_out), np.concatenate(cols_out), np.concatenate(vals_out)


def covariance(compiled, variables, damping=0.0):
    """The inverse of the (optionally damped) dense Hessian — the
    reference's ``invsym`` use, marginal covariances after convergence."""
    from ..core.linearsolver import invert_psd

    a, _ = hessian_dense(compiled, variables)
    if damping:
        a = a + damping * torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    return invert_psd(a)
