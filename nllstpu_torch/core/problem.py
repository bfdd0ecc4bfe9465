"""Problem definition: variable families + type-grouped cost batches.

Port of ``nllstpu/core/problem.py`` for the slice the solver's main path
needs: variables of one manifold family are stacked into a host-side
``[n, *shape]`` numpy block; costs of one type are added in bulk with
``add_cost_batch(batched="cm")`` and a hand Jacobian, and finalize into a
padded struct-of-arrays :class:`CostBatch`.  Host bookkeeping stays numpy;
:func:`nllstpu_torch.core.optimize.compile_problem` uploads it once.

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
    """Host-side chunks of one cost type before finalization."""

    fn: Callable
    kernel: Any
    families: tuple
    jacobian: Callable
    chunks: list = dataclasses.field(default_factory=list)
    # each chunk: (params [k, ...] numpy or None, indices [k, nslots])


@dataclasses.dataclass
class CostBatch:
    """Finalized, padded struct-of-arrays batch of one cost type (host
    numpy; the compiled problem holds the device copies)."""

    fn: Callable
    kernel: Any
    manifolds: tuple  # per slot
    idx: tuple  # per slot: int32 [B_pad] indices into the family array
    params: Any  # [B_pad, ...] numpy array or None
    mask: Any  # bool [B_pad]; False for padding
    n: int  # true cost count
    jacobian: Callable  # (params, *vals_cm) -> (r [nres, B], J [nres, S, B])
    batched: str = "cm"

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
        return [VarHandle(manifold, first + i) for i in range(values.shape[0])]

    def set_values(self, variables: dict):
        """Write a variables dict (family -> stacked tensor or array) back
        into the host store."""
        for name, arr in variables.items():
            if isinstance(arr, torch.Tensor):
                arr = arr.detach().cpu().numpy()
            self._families[name].values[:] = arr

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

    def add_cost_batch(
        self,
        fn: Callable,
        slots: list,
        params: Any = None,
        kernel: Any = None,
        jacobian: Callable = None,
        batched="cm",
    ):
        """Bulk-add ``k`` residual costs of one type.  ``slots`` is a list of
        ``(manifold, index_array[k])``; ``params`` an array with leading
        dimension ``k``.  ``fn(params, *vals_cm)`` returns the residual
        ``[nres, B]`` of components-major slot values ``[ambient, B]`` and
        ``jacobian`` returns ``(r, J [nres, S, B])`` in tangent coordinates.
        The port takes components-major batches with a hand Jacobian only.

        ``kernel`` is a fixed :class:`Robustifier` or an
        :class:`AdaptiveRobustifier`; for the latter, slot 0 is the kernel's
        parameter variable and ``fn``/``jacobian`` take the other slots
        (reference convention, src/residual.jl:46-47)."""
        if batched != "cm":
            raise NotImplementedError(
                "the port takes components-major batches (batched='cm') only"
            )
        if jacobian is None:
            raise NotImplementedError(
                "the port needs a hand Jacobian; autodiff Jacobians come with "
                "the dense path"
            )
        if not slots:
            raise ValueError("a cost must depend on at least one variable")
        if len(slots) > config.MAX_ARGS:
            raise ValueError(f"at most {config.MAX_ARGS} variable blocks per cost")
        manifolds = tuple(m for m, _ in slots)
        idx = np.stack([np.asarray(i, dtype=np.int32) for _, i in slots], axis=1)
        for (man, _), col in zip(slots, idx.T):
            fam = self._families.get(family_name(man))
            n = fam.n if fam is not None else 0
            if col.size and (col.min() < 0 or col.max() >= n):
                raise ValueError(
                    f"variable index out of range for family {family_name(man)}"
                )
        kernel = NoRobust() if kernel is None else kernel
        if isinstance(kernel, AdaptiveRobustifier):
            if manifolds[0] != kernel.manifold or len(slots) < 2:
                raise ValueError(
                    "first slot of an adaptive cost must be the kernel variable "
                    f"({kernel.manifold}), followed by the residual's variables"
                )
        elif not isinstance(kernel, Robustifier):
            raise TypeError(f"kernel {kernel!r} is not a robust kernel of the port")
        key = (fn, kernel, manifolds, jacobian, params is None)
        group = self._groups.get(key)
        if group is None:
            group = _CostGroup(fn, kernel, manifolds, jacobian)
            self._groups[key] = group
            self._group_order.append(key)
        group.chunks.append((None if params is None else np.asarray(params), idx))

    def batches(self) -> list:
        """Finalize cost groups into padded :class:`CostBatch` objects."""
        out = []
        for key in self._group_order:
            g = self._groups[key]
            ind = np.concatenate([ci for _, ci in g.chunks])
            n = ind.shape[0]
            n_pad = -(-n // BATCH_ALIGN) * BATCH_ALIGN
            idx_arr = np.zeros((len(g.families), n_pad), dtype=np.int32)
            idx_arr[:, :n] = ind.T
            mask = np.zeros(n_pad, dtype=bool)
            mask[:n] = True
            params = None
            if g.chunks[0][0] is not None:
                raw = np.concatenate([cp for cp, _ in g.chunks])
                if np.issubdtype(raw.dtype, np.floating):
                    raw = raw.astype(self._np_dtype)
                params = np.zeros((n_pad,) + raw.shape[1:], dtype=raw.dtype)
                params[:n] = raw
            out.append(
                CostBatch(
                    fn=g.fn,
                    kernel=g.kernel,
                    manifolds=g.families,
                    idx=tuple(idx_arr[i] for i in range(len(g.families))),
                    params=params,
                    mask=mask,
                    n=n,
                    jacobian=g.jacobian,
                )
            )
        return out
