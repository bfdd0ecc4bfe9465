"""Cost / residual-Jacobian engine over components-major cost batches.

Port of the parts of ``nllstpu/core/engine.py`` on the solver's paths:
the tangent :class:`Layout`, the components-major gathers (with the
landmark-run broadcast of obs-major batches), the raw residual data the
Schur assembly consumes (with an adaptive kernel's derivative blocks), the
masked cost, and the manifold step.

The batches passed here are the compiled problem's device copies: ``idx``
entries are int64 tensors, ``mask`` a bool tensor, ``params`` a tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .manifolds import Manifold
from .problem import Problem, VarHandle, family_name


@dataclasses.dataclass
class Layout:
    """Tangent-space layout.  ``offsets[name][i]`` is the offset of variable
    ``i`` of family ``name`` in the global step vector (``dof_total``, the
    dustbin, when fixed)."""

    offsets: dict  # family name -> numpy int32 [n]
    unfixed: dict  # family name -> numpy bool [n]
    dof_total: int
    pad: int


def resolve_unfixed(problem: Problem, unfixed) -> dict:
    """Per-family boolean masks of the variables to optimize (the JAX
    package's ``resolve_unfixed``, reference ``convertunfixed``).  Accepts
    ``None`` (all free), a :class:`Manifold` (that family only), one
    :class:`VarHandle`, an iterable of handles, or a dict of masks."""
    masks = {name: np.zeros(fam.n, dtype=bool) for name, fam in problem._families.items()}
    if unfixed is None:
        for m in masks.values():
            m[:] = True
    elif isinstance(unfixed, Manifold):
        masks[family_name(unfixed)][:] = True
    elif isinstance(unfixed, VarHandle):
        masks[unfixed.family][unfixed.index] = True
    elif isinstance(unfixed, dict):
        for name, m in unfixed.items():
            masks[name][:] = np.asarray(m, dtype=bool)
    else:
        for h in unfixed:
            masks[h.family][h.index] = True
    return masks


def build_layout(problem: Problem, unfixed=None, batches=None, order_last=None,
                 order_key=None) -> Layout:
    """Offsets of the unfixed variables (:func:`resolve_unfixed`) in the
    global tangent vector; a fixed variable's offset is ``dof_total``, the
    dustbin that :func:`apply_step`'s zero pad answers.  ``order_last``
    forces a family's block to the end (the Schur backend's eliminated
    family); ``order_key`` lays a family's unfixed variables out in
    DESCENDING key order (stable), the Schur backend's degree relabel of
    skewed problems."""
    masks = resolve_unfixed(problem, unfixed)
    offsets = {}
    running = 0
    names = problem.family_names()
    if order_last is not None:
        names = [n for n in names if n != order_last] + [order_last]
    for name in names:
        man = problem.manifold_of(name)
        mask = masks[name]
        key = None if order_key is None else order_key.get(name)
        if key is not None:
            order = np.argsort(-np.asarray(key), kind="stable")
            order = order[mask[order]]
        else:
            order = np.nonzero(mask)[0]
        off = np.full(mask.shape[0], -1, dtype=np.int32)
        off[order] = running + np.arange(order.shape[0], dtype=np.int32) * man.dof
        offsets[name] = off
        running += int(order.shape[0]) * man.dof
    pad = max([1] + [problem.manifold_of(n).dof for n in names])
    for b in problem.batches() if batches is None else batches:
        pad = max(pad, b.block_dof)
    for off in offsets.values():
        off[off < 0] = running
    return Layout(offsets=offsets, unfixed=masks, dof_total=running, pad=pad)


def device_batch(batch, device, dtype):
    """The batch with its index, parameter and mask arrays on the device."""
    return dataclasses.replace(
        batch,
        idx=tuple(torch.as_tensor(i, dtype=torch.long, device=device) for i in batch.idx),
        params=None if batch.params is None
        else torch.as_tensor(batch.params, dtype=dtype, device=device),
        mask=torch.as_tensor(batch.mask, device=device),
    )


def _gather_vals_cm(batch, variables: dict, runs=None):
    """Components-major gathers: per slot ``[ambient, B]``.

    ``runs = (slot, buckets)`` marks an obs-major batch (column
    ``col_base + (l − l_base)·k + j`` is the j-th cost of landmark ``l``):
    that slot is gathered once per landmark and broadcast over its run.
    Masked pad slots inside a run then carry the run's landmark value; every
    consumer zeroes masked contributions."""
    out = []
    for slot_i, (m, idx) in enumerate(zip(batch.manifolds, batch.idx)):
        arr = variables[family_name(m)]
        flat = arr.reshape(arr.shape[0], -1).T  # [ambient, n]
        if runs is not None and slot_i == runs[0]:
            amb = flat.shape[0]
            parts = []
            pos = 0
            for (_, lb, kb, c0) in runs[1]:
                if c0 > pos:
                    parts.append(flat[:, idx[pos:c0]])
                head = flat[:, idx[c0 : c0 + lb * kb : kb]]  # [ambient, L_b]
                parts.append(
                    head[:, :, None].expand(amb, lb, kb).reshape(amb, lb * kb)
                )
                pos = c0 + lb * kb
            if idx.shape[0] > pos:
                parts.append(flat[:, idx[pos:]])
            out.append(parts[0] if len(parts) == 1 else torch.cat(parts, dim=1))
        else:
            out.append(flat[:, idx])
    return tuple(out)


def _masked_sum(batch, costs):
    return torch.where(batch.mask, costs, torch.zeros_like(costs)).sum()


def batch_cost(batch, variables: dict, runs=None):
    """Masked total cost ½·Σρ(‖r‖²) of one batch; an adaptive kernel takes
    its parameters from slot 0."""
    gath = _gather_vals_cm(batch, variables, runs=runs)
    if batch.adaptive:
        r = batch.fn(batch.params, *gath[1:])
        return _masked_sum(batch, 0.5 * batch.kernel.rho(gath[0], (r * r).sum(dim=0)))
    r = batch.fn(batch.params, *gath)
    return _masked_sum(batch, 0.5 * batch.kernel.rho((r * r).sum(dim=0)))


def total_cost(batches, variables: dict, runs_list=None):
    total = None
    for bi, b in enumerate(batches):
        c = batch_cost(b, variables, runs=runs_list[bi] if runs_list else None)
        total = c if total is None else total + c
    return total


def batch_res_jac_cm(batch, variables: dict, runs=None):
    """Raw components-major residual data of a batch:
    ``(cost_sum, r [n, B], jac [n, S, B], g0 [S, B], d1 [B], d2 [B], kern)``
    with ``g0 = Jᵀr`` unweighted and (d1, d2) = (ρ′, ρ″).  The assembly
    composes the robustified blocks itself.

    ``kern`` is None for a fixed kernel.  For an adaptive batch the
    Jacobian covers the non-kernel slots only, and ``kern = (dgrad [k+1, B],
    dhess [k+1, k+1, B])`` are ρ's derivatives in [kernel tangent, s]
    (``rho_dkernel_cm``), whose last entries are ρ′ and ρ″."""
    gath = _gather_vals_cm(batch, variables, runs=runs)
    if batch.adaptive:
        r, jac = batch.jacobian(batch.params, *gath[1:])
        rho, dgrad, dhess = batch.kernel.rho_dkernel_cm(gath[0], (r * r).sum(dim=0))
        d1, d2, kern = dgrad[-1], dhess[-1, -1], (dgrad, dhess)
    else:
        r, jac = batch.jacobian(batch.params, *gath)
        rho, d1, d2 = batch.kernel.rho_dc((r * r).sum(dim=0))
        kern = None
    g0 = torch.einsum("nsb,nb->sb", jac, r)
    return _masked_sum(batch, 0.5 * rho), r, jac, g0, d1, d2, kern


def step_index(layout: Layout, manifolds: dict, device) -> dict:
    """Per family, the ``[n, dof]`` rows of the padded step vector each
    variable reads (fixed variables read the zero pad)."""
    return {
        name: torch.as_tensor(
            off[:, None] + np.arange(manifolds[name].dof)[None, :],
            dtype=torch.long, device=device,
        )
        for name, off in layout.offsets.items()
    }


def apply_step(manifolds: dict, index: dict, pad: int, variables: dict, x):
    """Retract every family by its slice of the step vector ``x [D]``
    (reference ``update!``); ``index`` comes from :func:`step_index`."""
    xpad = torch.cat([x, x.new_zeros(pad)])
    return {
        name: manifolds[name].retract(arr, xpad[index[name]])
        for name, arr in variables.items()
    }
