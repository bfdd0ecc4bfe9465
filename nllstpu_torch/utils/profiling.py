"""Profiling and timing helpers (port of ``nllstpu/utils/profiling.py``):
a fence that waits for the device and reads a value back, a best-of-N
wall timer fenced by it, a ``torch.profiler`` trace, and the program's own
spans and counters.

Spans (:func:`span`) mark the graph driver's pieces and the set-up's phases
under names that start with ``nt.`` (``docs/API.md`` lists them).  While a
``torch.profiler`` session records, a span is a ``record_function``: its
event lands in the same trace, on the same clock, as the card's kernels.
While none records, a span costs one flag check.  Set-up spans
(:func:`setup_span`) also time themselves on the host clock, into the
record of the ``optimize`` call in flight (``Result.setup_seconds``).
Every call's counters add up in :func:`totals`.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch
from torch.autograd import profiler as _autograd_profiler


def _leaves(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def fence(tree) -> float:
    """Wait for every tensor in ``tree`` (nested dicts, lists, tuples):
    ``torch.cuda.synchronize`` on the card, then one readback of the sum of
    their sums in float32, which it returns."""
    leaves = list(_leaves(tree))
    if not leaves:
        return 0.0
    for dev in {t.device for t in leaves if t.is_cuda}:
        torch.cuda.synchronize(dev)
    total = sum(t.detach().float().sum().cpu() for t in leaves)
    return float(total)


def timed(fn, *args, repeats: int = 3):
    """Best-of-``repeats`` wall time of ``fn(*args)``, each call ended by
    :func:`fence`.  Returns ``(best_seconds, last_output)``."""
    best, out = float("inf"), None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args)
        fence(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA where a card
    is present), written to ``log_dir`` for TensorBoard; yields the
    profiler (``key_averages()``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof


_NULL = contextlib.nullcontext()
#: What a span is while the profiler records.
_record_function = torch.profiler.record_function
#: The set-up seconds of the ``optimize`` call in flight (:func:`setup_record`).
_setup = None
_TOTALS = collections.Counter()


class _Span:
    """A span that the profiler records while it is on, and that times
    itself: ``seconds`` after it closes, added into ``into`` (a dict, or
    None) under its name without the ``nt.`` prefix."""

    __slots__ = ("name", "into", "seconds", "_event", "_t0")

    def __init__(self, name: str, into):
        self.name, self.into, self.seconds, self._event = name, into, 0.0, None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._event = _record_function(self.name)
            self._event.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self.into is not None:
            key = self.name.removeprefix("nt.")
            self.into[key] = self.into.get(key, 0.0) + self.seconds
        if self._event is not None:
            self._event.__exit__(*exc)
        return False


def span(name: str):
    """A named span of the program: a ``torch.profiler.record_function``
    while a profiler records, else a shared null context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, None)


def setup_span(name: str) -> _Span:
    """A set-up phase's span, timed always (its ``seconds``) and added
    into the set-up record open (:func:`setup_record`), if any, under
    ``name`` without the ``nt.`` prefix."""
    return _Span(name, _setup)


@contextlib.contextmanager
def setup_record():
    """Collects the set-up spans' seconds of the block into the dict it
    yields (the innermost record open takes them)."""
    global _setup
    outer, _setup = _setup, {}
    try:
        yield _setup
    finally:
        _setup = outer


def totals() -> collections.Counter:
    """The process totals of every ``optimize`` call's counters (the same
    Counter, live): ``optimize_calls``, ``iterations``, ``linear_solves``,
    ``replays.<piece>`` (graph pieces), ``pcg_solves``,
    ``pcg_iterations`` and ``setup.<phase>`` (seconds)."""
    return _TOTALS
