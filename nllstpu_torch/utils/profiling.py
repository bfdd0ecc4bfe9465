"""Profiling and timing helpers (port of ``nllstpu/utils/profiling.py``):
a fence that waits for the device and reads a value back, a best-of-N
wall timer fenced by it, and a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import time

import torch


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
