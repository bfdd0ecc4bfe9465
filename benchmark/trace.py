"""The profiler's trace, reduced: device intervals, busy time, idle gaps.

``read`` exports a ``torch.profiler`` session's Chrome trace into a temporary
directory (under ``TMPDIR``), parses it and deletes it.  The traced window
runs from the start of the first ``solve`` span (the harness's own
``record_function`` around each solve) to the end of the last.  Device time
is the union of the intervals of kernels, copies and fills on the card;
an idle gap is a stretch of the window with none, named by the innermost host
event that covers its middle (an operator, a CUDA runtime call, or one of the
benchmark's own spans).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"})
#: A host gap with no host event over it: Python between the calls.
NO_HOST_EVENT = "host: no operator or runtime call"
#: The benchmark's own spans (``record_function``), which last long.
SPANS = frozenset({"solve", "set_start", "optimize", "snapshot"})


@dataclasses.dataclass
class Trace:
    """Intervals in microseconds of the trace's clock: ``kernels`` (name,
    start, duration) of the card's kernels, ``device`` every device interval,
    ``host`` the host events, ``window`` (start, end)."""

    kernels: list
    device: list
    host: list
    window: tuple

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in union(self.device, self.window)) * 1e-6

    def kernel_seconds(self, match) -> tuple:
        """``(count, seconds)`` of the kernels whose name ``match`` accepts."""
        hits = [d for name, _, d in self.kernels if match(name)]
        return len(hits), sum(hits) * 1e-6

    def gaps(self) -> list:
        """``(start, end)`` of each stretch of the window the card is idle."""
        out, t = [], self.window[0]
        for a, b in union(self.device, self.window):
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if t < self.window[1]:
            out.append((t, self.window[1]))
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the idle time by
        what the host was doing, each as ``[name, seconds]``, most first."""
        ops = collections.Counter()
        for name, _, d in self.kernels:
            ops[short_name(name)] += d * 1e-6
        idle = collections.Counter()
        host = sorted(self.host, key=lambda e: e[1])
        starts = [e[1] for e in host]
        spans = [e for e in host if e[0] in SPANS]
        span_starts = [e[1] for e in spans]
        for a, b in self.gaps():
            t = (a + b) / 2
            name = host_at(host, starts, t)
            if name == NO_HOST_EVENT:
                name = host_at(spans, span_starts, t, len(spans))
            idle[name] += (b - a) * 1e-6
        return {"device_ops": [[n, s] for n, s in ops.most_common(top)],
                "idle_gaps": [[n, s] for n, s in idle.most_common(top)]}


def short_name(name: str) -> str:
    """A kernel's name without its parameter list: up to the first ``(`` at
    template depth 0 after the return type's (``void (anonymous
    namespace)::`` kept)."""
    prefix = "void (anonymous namespace)::"
    depth, start = 0, len(prefix) if name.startswith(prefix) else 0
    for i in range(start, len(name)):
        ch = name[i]
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > start:
            return name[:i]
    return name


def union(intervals, window) -> list:
    """The union of ``(start, duration)`` intervals clipped to ``window``, as
    sorted ``(start, end)``."""
    lo, hi = window
    spans = sorted((max(s, lo), min(s + d, hi)) for s, d in intervals)
    out = []
    for a, b in spans:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def host_at(host, starts, t, look_back: int = 512) -> str:
    """The name of the innermost (shortest) host event covering ``t``, among
    the ``look_back`` events of ``host`` (sorted by start, ``starts`` their
    starts) that began last before it.  The benchmark's own spans last long
    and began earlier: the caller asks for them apart."""
    best = None
    i = bisect.bisect_right(starts, t)
    for name, s, d in host[max(0, i - look_back):i]:
        if s + d >= t and (best is None or d < best[1]):
            best = (name, d)
    return best[0] if best else NO_HOST_EVENT


def parse(events) -> Trace:
    """A :class:`Trace` from a Chrome trace's ``traceEvents``."""
    kernels, device, host, spans = [], [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name, s, d = e.get("cat"), e.get("name", ""), float(e["ts"]), float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            device.append((s, d))
            if cat == "kernel":
                kernels.append((name, s, d))
        elif cat in HOST_CATS:
            host.append((name, s, d))
            if cat == "user_annotation" and name == "solve":
                spans.append((s, s + d))
    if not spans:
        raise ValueError("the trace holds no solve span")
    return Trace(kernels, device, host, (min(a for a, _ in spans), max(b for _, b in spans)))


def read(prof) -> Trace:
    """Export ``prof``'s trace, parse it, delete the file."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return parse(events)
