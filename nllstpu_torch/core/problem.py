"""Problem definition: variable families + type-grouped cost batches.

Port of ``nllstpu/core/problem.py``: variables of one manifold family are
stacked into a host-side ``[n, *shape]`` numpy block; costs of one type
(same function, kernel, families, kind and Jacobian) are added one at a
time (``add_cost``) or in bulk (``add_cost_batch``) and finalize into a
padded struct-of-arrays :class:`CostBatch`.  A batch is per-cost (``fn``
of one cost's values, vmapped; Jacobians by autodiff unless a hand one is
given), row-major (``batched=True``, whole ``[B, ...]`` arrays and a hand
Jacobian) or components-major (``batched="cm"``, ``[ambient, B]`` slots;
without a hand Jacobian one is synthesized by forward-mode autodiff
through the retractions, :func:`auto_cm_jacobian`).  Host bookkeeping
stays numpy; :func:`nllstpu_torch.core.optimize.compile_problem` uploads
it once.

Every problem carries an explicit ``dtype`` and ``device``: PyTorch's own
default is float32, and the tests solve in float64.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .. import config
from .manifolds import Manifold
from .robust import AdaptiveRobustifier, NoRobust, Robustifier

#: Batch padding granularity (as in the JAX package, so padded batches are
#: identical between the two).
BATCH_ALIGN = 8


def family_name(manifold: Manifold) -> str:
    """Stable string key of a variable family — the same strings the JAX
    package uses (dataclass ``repr``), so stacked-variable dicts carry
    across unchanged."""
    return repr(manifold)


@dataclasses.dataclass(frozen=True)
class VarHandle:
    """Reference to one variable block: (family, index-within-family)."""

    manifold: Manifold
    index: int

    @property
    def family(self) -> str:
        return family_name(self.manifold)


class _Family:
    """Growable ``[n, *shape]`` numpy storage of one manifold family."""

    def __init__(self, manifold: Manifold, np_dtype):
        self.manifold = manifold
        self._buf = np.zeros((8,) + manifold.shape, dtype=np_dtype)
        self.n = 0

    @property
    def values(self) -> np.ndarray:
        return self._buf[: self.n]

    def add_many(self, values) -> int:
        k = values.shape[0]
        need = self.n + k
        if need > self._buf.shape[0]:
            new = np.zeros(
                (max(need, 2 * self._buf.shape[0]),) + self._buf.shape[1:],
                dtype=self._buf.dtype,
            )
            new[: self.n] = self._buf[: self.n]
            self._buf = new
        self._buf[self.n : need] = values
        first = self.n
        self.n = need
        return first


@dataclasses.dataclass
class _CostGroup:
    """Host-side costs of one type before finalization: single costs
    (``params``/``indices`` lists, from ``add_cost``) and bulk chunks."""

    kind: str  # "residual" or "cost"
    fn: Callable
    kernel: Any
    families: tuple
    jacobian: Callable
    batched: Any  # False, True or "cm"
    params: list = dataclasses.field(default_factory=list)
    indices: list = dataclasses.field(default_factory=list)
    chunks: list = dataclasses.field(default_factory=list)
    # each chunk: (params [k, ...] numpy or None, indices [k, nslots])


def auto_cm_jacobian(fn, manifolds):
    """A components-major ``jacobian(params, *vals_cm) -> (r [n, B], jac
    [n, S, B])`` for a cm residual ``fn`` without a hand Jacobian (the JAX
    package's ``_auto_cm_jacobian``): one forward-mode pass
    (``torch.func.jvp``) of (fn ∘ retract_cm) at the zero tangent per
    tangent column, every cost's column riding the same broadcast basis
    tangent, so the batch stays components-major."""
    from torch.func import jvp

    dofs = [m.dof for m in manifolds]

    def jac_fn(params, *vals_cm):
        b = vals_cm[0].shape[-1]

        def g(*tangents):
            newv = tuple(m.retract_cm(v, t) for m, v, t in zip(manifolds, vals_cm, tangents))
            return torch.atleast_2d(fn(params, *newv))

        zeros = tuple(vals_cm[0].new_zeros(d, b) for d in dofs)
        r, cols = None, []
        for slot, d in enumerate(dofs):
            for j in range(d):
                tans = [torch.zeros_like(z) for z in zeros]
                tans[slot][j] = 1
                r, col = jvp(g, zeros, tuple(tans))
                cols.append(col)
        return r, torch.stack(cols, dim=1)  # [n, S, B]

    return jac_fn


@dataclasses.dataclass
class CostBatch:
    """Finalized, padded struct-of-arrays batch of one cost type (host
    numpy; the compiled problem holds the device copies).  ``jacobian`` is
    the hand Jacobian in the batch's layout — cm: ``(params, *vals_cm) ->
    (r [nres, B], J [nres, S, B])`` (synthesized when none was given);
    row-major: ``(params, *vals) -> (r [B, nres], J [B, nres, S])``;
    per-cost: one cost's ``(r [nres], J [nres, S])`` — or None (per-cost
    autodiff)."""

    fn: Callable
    kernel: Any
    manifolds: tuple  # per slot
    idx: tuple  # per slot: int32 [B_pad] indices into the family array
    params: Any  # [B_pad, ...] numpy array or None
    mask: Any  # bool [B_pad]; False for padding
    n: int  # true cost count
    jacobian: Callable
    batched: Any = "cm"  # False (per-cost), True (row-major) or "cm"
    kind: str = "residual"  # "residual" (½ρ(‖r‖²)) or "cost" (fn's value)
    # Where a compile reorders the batch (the Schur layouts), each column's
    # column in the batch as ``Problem.batches`` gave it (None: unchanged):
    # ``SubproblemView`` maps its masks through it.
    take: Any = None

    @property
    def block_dof(self) -> int:
        """Tangent size of one cost's variables, the kernel slot of an
        adaptive batch included."""
        return sum(m.dof for m in self.manifolds)

    @property
    def adaptive(self) -> bool:
        """Slot 0 holds the parameters of an adaptive kernel; ``fn`` and
        ``jacobian`` take the other slots."""
        return isinstance(self.kernel, AdaptiveRobustifier)


class Problem:
    """User-facing problem container (reference ``NLLSProblem``)."""

    def __init__(self, dtype=None, device=None):
        self.dtype = dtype or config.default_dtype
        self.device = config.resolve_device(device)
        self._np_dtype = config.numpy_dtype(self.dtype)
        self._families: dict = {}
        self._groups: dict = {}
        self._group_order: list = []
        # Bumped on structural changes (new variables or costs); value edits
        # keep it, so that compiled solvers are reused (the runner cache,
        # ``SubproblemView``).
        self.structure_version = 0

    # -- variables ---------------------------------------------------------

    def _family(self, manifold: Manifold) -> _Family:
        name = family_name(manifold)
        fam = self._families.get(name)
        if fam is None:
            fam = _Family(manifold, self._np_dtype)
            self._families[name] = fam
        return fam

    def add_variable(self, manifold: Manifold, value) -> VarHandle:
        """Add one variable block; returns its handle (reference
        ``addvariable!``)."""
        value = np.asarray(value, dtype=self._np_dtype)
        if value.shape != manifold.shape:
            raise ValueError(
                f"variable value shape {value.shape} != manifold shape {manifold.shape}"
            )
        return self.add_variables(manifold, value[None])[0]

    def get_value(self, handle: VarHandle) -> np.ndarray:
        """A copy of one variable's value from the host store."""
        return self._families[handle.family].values[handle.index].copy()

    def add_variables(self, manifold: Manifold, values) -> list:
        """Bulk-add ``k`` variables from a stacked ``[k, *shape]`` array;
        returns their handles."""
        values = np.asarray(values, dtype=self._np_dtype)
        if values.shape[1:] != manifold.shape:
            raise ValueError(
                f"stacked value shape {values.shape[1:]} != manifold shape "
                f"{manifold.shape}"
            )
        first = self._family(manifold).add_many(values)
        self.structure_version += 1
        return [VarHandle(manifold, first + i) for i in range(values.shape[0])]

    def set_value(self, handle: VarHandle, value):
        """Write one variable's value into the host store."""
        self._families[handle.family].values[handle.index] = np.asarray(
            value, dtype=self._np_dtype)

    def set_values(self, variables: dict):
        """Write a variables dict (family -> stacked tensor or array) back
        into the host store."""
        for name, arr in variables.items():
            if isinstance(arr, torch.Tensor):
                arr = arr.detach().cpu().numpy()
            self._families[name].values[:] = arr

    def num_variables(self) -> int:
        return sum(f.n for f in self._families.values())

    def num_costs(self) -> int:
        """Real costs over every group (reference ``countcosts``)."""
        return sum(self._group_indices(g).shape[0] for g in self._groups.values())

    def __repr__(self):
        fams = ", ".join(f"{name}×{fam.n}" for name, fam in self._families.items())
        return (f"Problem({self.num_variables()} variables [{fams}], "
                f"{self.num_costs()} costs in {len(self._group_order)} type groups)")

    def manifold_of(self, name: str) -> Manifold:
        return self._families[name].manifold

    def family_names(self):
        return list(self._families.keys())

    def stacked_variables(self) -> dict:
        """Variables as a dict of stacked tensors on the problem's device
        (the solver state)."""
        return {
            name: torch.as_tensor(fam.values.copy(), dtype=self.dtype).to(self.device)
            for name, fam in self._families.items()
        }

    # -- costs -------------------------------------------------------------

    @staticmethod
    def _kernel(kind, kernel, manifolds):
        """The group's kernel (NoRobust by default for residuals, None for
        plain costs), checked as the JAX package checks it."""
        if kind not in ("residual", "cost"):
            raise ValueError(f"unknown cost kind {kind!r}")
        if kernel is None:
            return NoRobust() if kind == "residual" else None
        if isinstance(kernel, AdaptiveRobustifier):
            if kind != "residual":
                raise ValueError("adaptive kernels only apply to residual costs")
            if manifolds[0] != kernel.manifold or len(manifolds) < 2:
                raise ValueError(
                    "first slot of an adaptive cost must be the kernel variable "
                    f"({kernel.manifold}), followed by the residual's variables"
                )
            return kernel
        if not isinstance(kernel, Robustifier):
            raise TypeError(f"kernel {kernel!r} is not a robust kernel of the port")
        if kind == "cost":
            if not isinstance(kernel, NoRobust):
                raise ValueError("plain costs are not robustified")
            return None
        return kernel

    def _group(self, kind, fn, kernel, manifolds, jacobian, batched, has_params):
        key = (kind, fn, kernel, manifolds, jacobian, batched, has_params)
        group = self._groups.get(key)
        if group is None:
            group = _CostGroup(kind, fn, kernel, manifolds, jacobian, batched)
            self._groups[key] = group
            self._group_order.append(key)
        return group

    def add_cost(self, fn: Callable, variables, params: Any = None, kernel: Any = None,
                 kind: str = "residual", jacobian: Callable = None):
        """Add one cost block (reference ``addcost!``).  ``fn(params,
        *values)`` returns the residual vector (``kind="residual"``,
        robustified as ½·ρ(‖r‖²)) or a scalar cost (``kind="cost"``, used
        as it is), of one cost's variable values (torch tensors of the
        manifolds' shapes); ``params`` is an array (or None).  An adaptive
        kernel's variable comes first in ``variables`` and ``fn`` takes the
        others.  ``jacobian(params, *values) -> (r, J)`` optionally gives
        the Jacobian in tangent coordinates.  Costs group by ``fn``
        identity: pass the same function object for costs of one type."""
        variables = tuple(variables)
        if not variables:
            raise ValueError("a cost must depend on at least one variable")
        if len(variables) > config.MAX_ARGS:
            raise ValueError(f"at most {config.MAX_ARGS} variable blocks per cost")
        manifolds = tuple(h.manifold for h in variables)
        for h in variables:
            fam = self._families.get(h.family)
            if fam is None or not (0 <= h.index < fam.n):
                raise ValueError(f"unknown variable handle {h}")
        kernel = self._kernel(kind, kernel, manifolds)
        group = self._group(kind, fn, kernel, manifolds, jacobian, False, params is not None)
        group.params.append(None if params is None else np.asarray(params))
        group.indices.append(tuple(h.index for h in variables))
        self.structure_version += 1

    def add_cost_batch(
        self,
        fn: Callable,
        slots: list,
        params: Any = None,
        kernel: Any = None,
        kind: str = "residual",
        jacobian: Callable = None,
        batched=False,
    ):
        """Bulk-add ``k`` costs of one type (the JAX package's signature).
        ``slots`` is a list of ``(manifold, index_array[k])``; ``params``
        an array with leading dimension ``k``.  ``batched`` gives ``fn``'s
        form:

        - ``False`` (the default): ``fn`` of one cost, as in :meth:`add_cost`;
        - ``"cm"``: ``fn(params, *vals_cm)`` returns the residual ``[nres, B]`` of
          components-major slot values ``[ambient, B]``; ``jacobian``
          returns ``(r, J [nres, S, B])`` in tangent coordinates, and is
          synthesized by :func:`auto_cm_jacobian` when not given;
        - ``True``: ``fn(params, *vals)`` of whole ``[B, ...]`` arrays
          returns ``[B, nres]``, with a hand ``jacobian`` ``(r, J [B, nres,
          S])``.

        ``kernel`` is a fixed :class:`Robustifier` or an
        :class:`AdaptiveRobustifier`; for the latter, slot 0 is the kernel's
        parameter variable and ``fn``/``jacobian`` take the other slots
        (reference convention, src/residual.jl:46-47)."""
        if batched not in (False, True, "cm"):
            raise ValueError(f"batched={batched!r}: one of False, True, 'cm'")
        if not slots:
            raise ValueError("a cost must depend on at least one variable")
        if len(slots) > config.MAX_ARGS:
            raise ValueError(f"at most {config.MAX_ARGS} variable blocks per cost")
        manifolds = tuple(m for m, _ in slots)
        idx = np.stack([np.asarray(i, dtype=np.int32) for _, i in slots], axis=1)
        for man, col in zip(manifolds, idx.T):
            fam = self._families.get(family_name(man))
            n = fam.n if fam is not None else 0
            if col.size and (col.min() < 0 or col.max() >= n):
                raise ValueError(
                    f"variable index out of range for family {family_name(man)}"
                )
        kernel = self._kernel(kind, kernel, manifolds)
        if batched:
            if kind != "residual":
                raise ValueError("batched costs must be residuals")
            if isinstance(kernel, AdaptiveRobustifier) and batched != "cm":
                raise ValueError("adaptive kernels require batched='cm'")
            if jacobian is None and batched != "cm":
                raise ValueError("batched=True requires a (batched) hand jacobian")
        group = self._group(kind, fn, kernel, manifolds, jacobian, batched, params is not None)
        group.chunks.append((None if params is None else np.asarray(params), idx))
        self.structure_version += 1

    @staticmethod
    def _group_indices(g) -> np.ndarray:
        """``[n, nslots]`` variable indices of one group's real costs, in
        the order :meth:`batches` emits them (single costs, then chunks)."""
        parts = ([np.array(g.indices, dtype=np.int32)] if g.indices else []) + [
            ci for _, ci in g.chunks
        ]
        if not parts:
            return np.zeros((0, len(g.families)), np.int32)
        return np.concatenate(parts)

    @staticmethod
    def _group_params(g):
        """``[n, ...]`` parameters of one group's real costs (or None), in
        the order of :meth:`_group_indices`."""
        praw = ([np.stack(g.params)] if g.indices and g.params[0] is not None else []) + [
            cp for cp, _ in g.chunks if cp is not None
        ]
        return np.concatenate(praw) if praw else None

    def batches(self) -> list:
        """Finalize cost groups into padded :class:`CostBatch` objects:
        single costs first, then bulk chunks, in the order added."""
        out = []
        for key in self._group_order:
            g = self._groups[key]
            ind = self._group_indices(g)
            n = ind.shape[0]
            n_pad = -(-n // BATCH_ALIGN) * BATCH_ALIGN
            idx_arr = np.zeros((len(g.families), n_pad), dtype=np.int32)
            idx_arr[:, :n] = ind.T
            mask = np.zeros(n_pad, dtype=bool)
            mask[:n] = True
            params = None
            raw = self._group_params(g)
            if raw is not None:
                if np.issubdtype(raw.dtype, np.floating):
                    raw = raw.astype(self._np_dtype)
                params = np.zeros((n_pad,) + raw.shape[1:], dtype=raw.dtype)
                params[:n] = raw
            jacobian = g.jacobian
            if jacobian is None and g.batched == "cm":
                adaptive = isinstance(g.kernel, AdaptiveRobustifier)
                jacobian = auto_cm_jacobian(g.fn, g.families[1:] if adaptive else g.families)
            out.append(
                CostBatch(
                    fn=g.fn,
                    kernel=g.kernel,
                    manifolds=g.families,
                    idx=tuple(idx_arr[i] for i in range(len(g.families))),
                    params=params,
                    mask=mask,
                    n=n,
                    jacobian=jacobian,
                    batched=g.batched,
                    kind=g.kind,
                )
            )
        return out

    # -- cost subsets and incidence -------------------------------------------

    def subproblem(self, predicate) -> "Problem":
        """A new problem sharing this problem's variables (the same host
        store) that keeps only the costs ``predicate`` selects (reference
        ``subproblem``): a callable ``(slot_handles) -> bool``, one
        :class:`VarHandle` (the costs touching it) or an iterable of
        handles.  Handle predicates select by vectorised numpy over the
        stacked indices; a callable is evaluated per cost.  Selected costs
        keep their group's hand Jacobian and batch form."""
        predicate, targets = self._normalize_predicate(predicate)
        sub = Problem(dtype=self.dtype, device=self.device)
        sub._families = self._families  # shared, as in the reference
        for key in self._group_order:
            g = self._groups[key]
            ind = self._group_indices(g)
            if ind.shape[0] == 0:
                continue
            sel = self._select_rows(g, ind, predicate, targets)
            if not sel.any():
                continue
            params = self._group_params(g)
            sub.add_cost_batch(
                g.fn,
                [(man, ind[sel, s]) for s, man in enumerate(g.families)],
                params=None if params is None else params[sel],
                kernel=g.kernel, kind=g.kind, jacobian=g.jacobian, batched=g.batched,
            )
        return sub

    @staticmethod
    def _normalize_predicate(predicate):
        """Handle and iterable predicates → per-family sorted index arrays
        (``(None, targets)``); a callable → ``(predicate, None)``."""
        if callable(predicate):
            return predicate, None
        handles = [predicate] if isinstance(predicate, VarHandle) else list(predicate)
        targets = {}
        for h in handles:
            targets.setdefault(h.family, []).append(h.index)
        return None, {f: np.unique(np.asarray(ix, dtype=np.int64)) for f, ix in targets.items()}

    @staticmethod
    def _select_rows(g, ind, predicate, targets):
        """Boolean selection over one group's real costs: vectorised numpy
        for handle targets, one call per cost for a callable."""
        n = ind.shape[0]
        if targets is not None:
            sel = np.zeros(n, dtype=bool)
            for s, man in enumerate(g.families):
                t = targets.get(family_name(man))
                if t is not None:
                    sel |= np.isin(ind[:, s], t)
            return sel
        return np.fromiter(
            (bool(predicate(tuple(VarHandle(m, int(i)) for m, i in zip(g.families, row))))
             for row in ind),
            dtype=bool, count=n,
        )

    def subset_masks(self, predicate) -> list:
        """Per-batch boolean masks, aligned with :meth:`batches` and padded
        as it pads, of the costs ``predicate`` keeps (the same forms as
        :meth:`subproblem`): the batches keep the whole problem's shapes,
        so a compiled solver takes these masks as values and swaps cost
        subsets without compiling again (``SubproblemView``)."""
        predicate, targets = self._normalize_predicate(predicate)
        masks = []
        for key in self._group_order:
            g = self._groups[key]
            ind = self._group_indices(g)
            n = ind.shape[0]
            m = np.zeros(-(-n // BATCH_ALIGN) * BATCH_ALIGN, dtype=bool)
            if n:
                m[:n] = self._select_rows(g, ind, predicate, targets)
            masks.append(m)
        return masks

    def varcostmap(self) -> dict:
        """The variable-cost incidence (reference ``getvarcostmap``) in COO
        form: per family a ``(var_idx, cost_id)`` pair of int64 arrays, cost
        ids global over the problem in the order :meth:`batches` emits the
        costs."""
        rows = {name: [] for name in self._families}
        cols = {name: [] for name in self._families}
        base = 0
        for key in self._group_order:
            g = self._groups[key]
            ind = self._group_indices(g)
            cost_ids = base + np.arange(ind.shape[0], dtype=np.int64)
            for s, man in enumerate(g.families):
                rows[family_name(man)].append(ind[:, s].astype(np.int64))
                cols[family_name(man)].append(cost_ids)
            base += ind.shape[0]
        empty = np.zeros(0, np.int64)
        return {
            name: (np.concatenate(rows[name]) if rows[name] else empty,
                   np.concatenate(cols[name]) if cols[name] else empty)
            for name in self._families
        }

    def var_cost_counts(self) -> dict:
        """Per family, how many costs touch each variable (the row sums of
        :meth:`varcostmap`'s incidence)."""
        coo = self.varcostmap()
        return {
            name: np.bincount(coo[name][0], minlength=fam.n).astype(np.int64)
            for name, fam in self._families.items()
        }
