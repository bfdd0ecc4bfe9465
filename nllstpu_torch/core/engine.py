"""Cost / gradient / Hessian engine over cost batches.

Port of ``nllstpu/core/engine.py``: the tangent :class:`Layout`, the
components-major gathers (with the landmark-run broadcast of obs-major
batches), the raw residual data the Schur assembly consumes (with an
adaptive kernel's derivative blocks), the masked cost of every batch form,
the per-cost (g, H) blocks of every batch form (an adaptive kernel's
tangent first) — Jacobians by
``torch.func.jacfwd`` through the retractions, plain costs by ``grad``
and ``jacfwd(grad)``, the IRLS reweighting and second-order correction of
the robust kernels — their assembly (:func:`assemble_dense`), and the
manifold step.

The batches passed here are the compiled problem's device copies: ``idx``
entries are int64 tensors, ``mask`` a bool tensor, ``params`` a tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any

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


def _gather_vals(batch, variables: dict):
    """Per-slot stacked values ``[B, *shape]`` of every cost in the batch."""
    return tuple(variables[family_name(m)][idx] for m, idx in zip(batch.manifolds, batch.idx))


def _split_tangent(t, manifolds):
    parts, start = [], 0
    for m in manifolds:
        parts.append(t[start : start + m.dof])
        start += m.dof
    return tuple(parts)


def _retract_one(m, v, dt):
    """One variable's retraction through the manifold's stacked one."""
    return m.retract(v[None], dt[None])[0]


def _residual_fn(batch, params, vals):
    """The residual of one cost as a function of the concatenated tangent
    of its residual slots (an adaptive kernel's slot 0 left out), and that
    tangent's size."""
    manifolds = batch.manifolds[1:] if batch.adaptive else batch.manifolds
    rvals = vals[1:] if batch.adaptive else vals

    def f(t):
        parts = _split_tangent(t, manifolds)
        newv = tuple(_retract_one(m, v, dt) for m, v, dt in zip(manifolds, rvals, parts))
        return torch.atleast_1d(batch.fn(params, *newv))

    return f, sum(m.dof for m in manifolds)


def _cost_value_one(batch, params, vals):
    """Cost of one block: ½ρ(‖r‖²) of a residual, ``fn``'s value of a
    plain cost."""
    if batch.kind == "cost":
        return batch.fn(params, *vals)
    r = torch.atleast_1d(batch.fn(params, *(vals[1:] if batch.adaptive else vals)))
    s = r @ r
    if batch.adaptive:
        return 0.5 * batch.kernel.rho(vals[0], s)
    return 0.5 * batch.kernel.rho(s)


def _cost_grad_hess_one(batch, params, vals):
    """(cost, g, H) of one cost block over its concatenated tangent (the
    JAX package's ``_cost_grad_hess_one``): a plain cost's gradient and
    Hessian by ``grad`` and ``jacfwd(grad)``; a residual's Jacobian from
    the hand one or ``jacfwd`` through the retractions, then g = Jᵀr,
    H = JᵀJ with the IRLS weight ρ′ and the second-order correction
    2ρ″ggᵀ.  An adaptive kernel's tangent comes first, its blocks
    unhalved beside the cross block on the unweighted gradient
    (:func:`_adaptive_blocks`)."""
    from torch.func import grad, jacfwd

    if batch.kind == "cost":
        manifolds = batch.manifolds

        def f(t):
            parts = _split_tangent(t, manifolds)
            return batch.fn(params, *(
                _retract_one(m, v, dt) for m, v, dt in zip(manifolds, vals, parts)))

        z = vals[0].new_zeros(sum(m.dof for m in manifolds))
        return f(z), grad(f)(z), jacfwd(grad(f))(z).to(z.dtype)
    f, dof = _residual_fn(batch, params, vals)
    if batch.jacobian is not None:
        r, jac = batch.jacobian(params, *(vals[1:] if batch.adaptive else vals))
        r, jac = torch.atleast_1d(r), torch.atleast_2d(jac)
    else:
        z = vals[0].new_zeros(dof)
        # PyTorch's forward mode gives a float64 tangent where a 0-d
        # float32 tensor meets a Python float (``so3_log``'s s2 / 48 in one
        # cost): the Jacobian is taken back to the problem's dtype.
        r, jac = f(z), jacfwd(f)(z).to(z.dtype)
    g = jac.T @ r
    h = jac.T @ jac
    if batch.adaptive:
        rho, dgrad, dhess = batch.kernel.rho_dkernel(vals[0], r @ r)
        g, h = _adaptive_blocks(g[None], h[None], dgrad[:, None], dhess[:, :, None])
        return 0.5 * rho, g[0], h[0]
    rho, d1, d2 = batch.kernel.rho_dc(r @ r)
    h = h * d1 + (2.0 * d2) * torch.outer(g, g)
    return 0.5 * rho, g * d1, h


def _cost_grad_hess_slot(batch, params, vals, slot: int):
    """(cost, g, H) of one cost in the tangent of dependency slot ``slot``
    alone, the other slots held fixed (the JAX package's
    ``_cost_grad_hess_slot``; reference univariate systems): a plain
    cost's gradient and Hessian by ``grad`` and ``jacfwd(grad)``; an
    adaptive kernel's slot 0 by its own derivative blocks (only the kernel
    moves); a residual's slot Jacobian by ``jacfwd`` through the slot's
    retraction, then the IRLS weight and the second-order term."""
    from torch.func import grad, jacfwd

    man = batch.manifolds[slot]
    z = vals[slot].new_zeros(man.dof)

    def moved(t):
        newv = list(vals)
        newv[slot] = _retract_one(man, vals[slot], t)
        return newv

    if batch.kind == "cost":
        def fc(t):
            return batch.fn(params, *moved(t))

        return fc(z), grad(fc)(z), jacfwd(grad(fc))(z).to(z.dtype)
    if batch.adaptive and slot == 0:
        r = torch.atleast_1d(batch.fn(params, *vals[1:]))
        rho, dgrad, dhess = batch.kernel.rho_dkernel(vals[0], r @ r)
        k = man.dof
        return 0.5 * rho, dgrad[:k], dhess[:k, :k]

    def f(t):
        newv = moved(t)
        return torch.atleast_1d(batch.fn(params, *(newv[1:] if batch.adaptive else newv)))

    r, jac = f(z), jacfwd(f)(z).to(z.dtype)
    s = r @ r
    g, h = jac.T @ r, jac.T @ jac
    rho, d1, d2 = (batch.kernel.rho_dc(vals[0], s) if batch.adaptive
                   else batch.kernel.rho_dc(s))
    return 0.5 * rho, g * d1, h * d1 + (2.0 * d2) * torch.outer(g, g)


def _slot_columns(batch, slot: int) -> slice:
    """The columns of slot ``slot`` in the batch's hand Jacobian (whose
    tangent leaves an adaptive kernel's slot out)."""
    first = 1 if batch.adaptive else 0
    o = sum(m.dof for m in batch.manifolds[first:slot])
    return slice(o, o + batch.manifolds[slot].dof)


def rows_grad_hess_slot(batch, params, vals, slot: int):
    """``(cost [N], g [N, d], H [N, d, d])`` of N costs of ``batch`` in the
    tangent of slot ``slot`` (``vals`` per slot ``[N, *shape]``,
    ``params`` the rows' parameters or None): per-cost batches and plain
    costs by ``torch.func.vmap`` of :func:`_cost_grad_hess_slot`;
    components-major and row-major batches from the slot's columns of their
    Jacobian (hand or synthesized), as :func:`batch_res_jac_cm` gives it;
    an adaptive kernel's slot from ``rho_dkernel_cm``."""
    from torch.func import vmap

    if batch.kind == "cost" or batch.batched is False:
        def one(p, *v):
            return _cost_grad_hess_slot(batch, p, v, slot)

        in_dims = (None if params is None else 0,) + (0,) * len(vals)
        return vmap(one, in_dims=in_dims)(params, *vals)
    if batch.batched == "cm":
        cm = tuple(v.reshape(v.shape[0], -1).T for v in vals)
        if batch.adaptive and slot == 0:
            r = batch.fn(params, *cm[1:])
            rho, dgrad, dhess = batch.kernel.rho_dkernel_cm(cm[0], (r * r).sum(0))
            k = batch.manifolds[0].dof
            return 0.5 * rho, dgrad[:k].T, dhess[:k, :k].permute(2, 0, 1)
        r, jac = batch.jacobian(params, *(cm[1:] if batch.adaptive else cm))
        js = jac[:, _slot_columns(batch, slot)]  # [n, d, N]
        g = torch.einsum("ndb,nb->bd", js, r)
        h = torch.einsum("ndb,neb->bde", js, js)
        s = (r * r).sum(0)
        if batch.adaptive:
            rho, dgrad, dhess = batch.kernel.rho_dkernel_cm(cm[0], s)
            d1, d2 = dgrad[-1], dhess[-1, -1]
        else:
            rho, d1, d2 = batch.kernel.rho_dc(s)
    else:
        r, jac = batch.jacobian(params, *vals)
        js = jac[:, :, _slot_columns(batch, slot)]  # [N, n, d]
        g = torch.einsum("bnd,bn->bd", js, r)
        h = torch.einsum("bnd,bne->bde", js, js)
        rho, d1, d2 = batch.kernel.rho_dc((r * r).sum(-1))
    h = h * d1[:, None, None] + (2.0 * d2)[:, None, None] * (g[:, :, None] * g[:, None, :])
    return 0.5 * rho, g * d1[:, None], h


def rows_cost(batch, params, vals):
    """``cost [N]`` of N costs of ``batch`` (``vals`` per slot ``[N,
    *shape]``), every batch form."""
    from torch.func import vmap

    if batch.kind == "cost" or batch.batched is False:
        def one(p, *v):
            return _cost_value_one(batch, p, v)

        in_dims = (None if params is None else 0,) + (0,) * len(vals)
        return vmap(one, in_dims=in_dims)(params, *vals)
    if batch.batched == "cm":
        cm = tuple(v.reshape(v.shape[0], -1).T for v in vals)
        if batch.adaptive:
            r = batch.fn(params, *cm[1:])
            return 0.5 * batch.kernel.rho(cm[0], (r * r).sum(0))
        r = batch.fn(params, *cm)
        return 0.5 * batch.kernel.rho((r * r).sum(0))
    r = batch.fn(params, *vals)
    return 0.5 * batch.kernel.rho((r * r).sum(-1))


def _adaptive_blocks(g0, h0, dgrad, dhess):
    """Adaptive (g [B, k+S], H [B, k+S, k+S]) from the Gauss-Newton blocks
    ``g0 [B, S]``, ``h0 [B, S, S]`` and ρ's derivatives in [kernel
    tangent, s] (``dgrad [k+1, B]``, ``dhess [k+1, k+1, B]``): the kernel's
    blocks first and unhalved, the cross block ∂²ρ/∂kernel∂s times the
    unweighted gradient, the residual blocks reweighted by ρ′ with the
    correction 2ρ″ggᵀ (the JAX package's layout, reference
    src/residual.jl:57-111)."""
    k = dgrad.shape[0] - 1
    d1, d2 = dgrad[k], dhess[k, k]
    cross = g0[:, :, None] * dhess[:k, k].T[:, None, :]  # [B, S, k]
    h = h0 * d1[:, None, None] + (2.0 * d2)[:, None, None] * (g0[:, :, None] * g0[:, None, :])
    top = torch.cat([dhess[:k, :k].permute(2, 0, 1), cross.transpose(1, 2)], dim=2)
    h_full = torch.cat([top, torch.cat([cross, h], dim=2)], dim=1)
    return torch.cat([dgrad[:k].T, g0 * d1[:, None]], dim=1), h_full


def _irls(batch, costs_sq, g, h):
    """Robustified (cost, g [B, S], H [B, S, S]) from Gauss-Newton blocks."""
    rho, d1, d2 = batch.kernel.rho_dc(costs_sq)
    h = h * d1[:, None, None] + (2.0 * d2)[:, None, None] * (g[:, :, None] * g[:, None, :])
    return 0.5 * rho, g * d1[:, None], h


def batch_grad_hess(batch, variables: dict):
    """(masked cost sum, g [B, S], H [B, S, S]) of one batch, every batch
    form: components-major (through its Jacobian, synthesized when none
    was given), row-major with a hand Jacobian, or per-cost
    (``torch.func.vmap`` of :func:`_cost_grad_hess_one`).  An adaptive
    kernel's tangent leads each block (:func:`_adaptive_blocks`; the
    components-major form as the JAX package's ``batch_grad_hess_cm``)."""
    from torch.func import vmap

    if batch.batched == "cm":
        gath = _gather_vals_cm(batch, variables)
        r, jac = batch.jacobian(batch.params, *(gath[1:] if batch.adaptive else gath))
        g = torch.einsum("nsb,nb->bs", jac, r)
        h = torch.einsum("nsb,ntb->bst", jac, jac)
        if batch.adaptive:
            costs, dgrad, dhess = batch.kernel.rho_dkernel_cm(gath[0], (r * r).sum(dim=0))
            g, h = _adaptive_blocks(g, h, dgrad, dhess)
            costs = 0.5 * costs
        else:
            costs, g, h = _irls(batch, (r * r).sum(dim=0), g, h)
    elif batch.batched:
        r, jac = batch.jacobian(batch.params, *_gather_vals(batch, variables))
        g = torch.einsum("bns,bn->bs", jac, r)
        h = torch.einsum("bns,bnt->bst", jac, jac)
        costs, g, h = _irls(batch, (r * r).sum(dim=-1), g, h)
    else:
        vals = _gather_vals(batch, variables)

        def one(params, *vals_one):
            return _cost_grad_hess_one(batch, params, vals_one)

        in_dims = (None if batch.params is None else 0,) + (0,) * len(vals)
        costs, g, h = vmap(one, in_dims=in_dims)(batch.params, *vals)
    return _masked_sum(batch, costs), g, h


def batch_rows(batch, layout: Layout) -> np.ndarray:
    """``[B, S]`` global tangent row of each block column (host numpy, the
    JAX package's ``_batch_rows``): per-slot offsets from the layout, with
    padding costs sent to the dustbin (``layout.dof_total``) whole."""
    mask = np.asarray(batch.mask)
    parts = []
    for man, idx in zip(batch.manifolds, batch.idx):
        off = np.asarray(layout.offsets[family_name(man)])[np.asarray(idx)]
        off = np.where(mask, off, layout.dof_total)
        parts.append(off[:, None] + np.arange(man.dof)[None, :])
    return np.concatenate(parts, axis=1)


@dataclasses.dataclass
class DensePlan:
    """Where the per-cost blocks of every batch land in the dense system,
    fixed at compile time: the contributions' order sorted by target
    (``perm``), each target's run in it (``starts``) and the targets
    (``targets``, flat indices into H ``[d, d]`` or g ``[d]``); H's and
    g's.  Contributions to the dustbin (fixed variables, padding) are
    dropped."""

    dim: int
    h_perm: Any
    h_starts: Any
    h_targets: Any
    g_perm: Any
    g_starts: Any
    g_targets: Any


def _runs(targets):
    keep = np.nonzero(targets >= 0)[0]
    order = keep[np.argsort(targets[keep], kind="stable")]
    ts = targets[order]
    first = np.r_[True, ts[1:] != ts[:-1]] if ts.size else np.zeros(0, bool)
    starts = np.r_[np.nonzero(first)[0], ts.size]
    return order, starts, ts[first]


def dense_plan(batches, layout: Layout, device) -> DensePlan:
    """The :class:`DensePlan` of host ``batches`` under ``layout``."""
    d = layout.dof_total
    h_t, g_t = [], []
    for b in batches:
        rows = batch_rows(b, layout).astype(np.int64)
        ok = rows < d
        h_t.append(np.where(ok[:, :, None] & ok[:, None, :],
                            rows[:, :, None] * d + rows[:, None, :], -1).reshape(-1))
        g_t.append(np.where(ok, rows, -1).reshape(-1))
    tensors = []
    for t in (np.concatenate(h_t), np.concatenate(g_t)):
        tensors.extend(torch.as_tensor(a, dtype=torch.long, device=device) for a in _runs(t))
    return DensePlan(d, *tensors)


def assemble_dense(batches, variables: dict, plan: DensePlan, segment_sum):
    """Dense symmetric normal equations ``(cost, (H [d, d], g [d]))`` (the
    JAX package's ``assemble_dense``, whose scatter-add sums in an order
    the device may change): every batch's blocks, sorted by target as
    ``plan`` says, each target's run summed in that fixed order by
    ``segment_sum`` (kernel B6's dispatcher, or its plain version), and
    the sums written to their unique targets.  The same inputs give the
    same bits."""
    total, hs, gs = None, [], []
    for b in batches:
        c, g, h = batch_grad_hess(b, variables)
        # Masked costs add nothing, whatever the mask holds at run time
        # (``SubproblemView`` writes it); the plan drops the padding.
        g = torch.where(b.mask[:, None], g, torch.zeros_like(g))
        h = torch.where(b.mask[:, None, None], h, torch.zeros_like(h))
        total = c if total is None else total + c
        hs.append(h.reshape(-1))
        gs.append(g.reshape(-1))
    d = plan.dim
    out = []
    for vals, perm, starts, targets, size in (
        (hs, plan.h_perm, plan.h_starts, plan.h_targets, d * d),
        (gs, plan.g_perm, plan.g_starts, plan.g_targets, d),
    ):
        v = torch.cat(vals).index_select(0, perm)[:, None]
        dense = v.new_zeros(size)
        out.append(dense.index_copy_(0, targets, segment_sum(v, starts)[:, 0]))
    return total, (out[0].view(d, d), out[1])


def batch_cost(batch, variables: dict, runs=None):
    """Masked total cost of one batch, every form: ½·Σρ(‖r‖²) of residuals
    (an adaptive kernel takes its parameters from slot 0), Σ fn of plain
    costs."""
    from torch.func import vmap

    if batch.batched != "cm":
        vals = _gather_vals(batch, variables)
        if batch.batched:
            r = batch.fn(batch.params, *vals)
            return _masked_sum(batch, 0.5 * batch.kernel.rho((r * r).sum(dim=-1)))

        def one(params, *vals_one):
            return _cost_value_one(batch, params, vals_one)

        in_dims = (None if batch.params is None else 0,) + (0,) * len(vals)
        return _masked_sum(batch, vmap(one, in_dims=in_dims)(batch.params, *vals))
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
