"""The program's own spans and counters, shared by the readers.

The port marks its work with spans (``nllstpu_torch.utils.profiling.span``):
``nt.optimize`` around each ``optimize`` call and ``nt.piece.<piece>``
around each graph piece's replay and the host read of its outputs.  While
the profiler records they are ``record_function`` events on the trace's
clock, among its host events.  The port's counters add up over the process
in ``profiling.totals()``: every ``optimize`` call of the run, set-up's
warm-up solve included.  Where the program has neither (an earlier
commit), these helpers give None, and the readers with them.
"""

OPTIMIZE = "nt.optimize"
PIECE = "nt.piece."
#: The harness's own span around each ``optimize`` call.
HARNESS_OPTIMIZE = "optimize"


def spans(trace, match) -> list:
    """The union of the host events whose name ``match`` accepts, clipped
    to the traced window: sorted, disjoint ``(start, end)``."""
    lo, hi = trace.window
    out = []
    for a, b in sorted((max(s, lo), min(s + d, hi)) for name, s, d in trace.host if match(name)):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def intersect(a: list, b: list) -> list:
    """The common stretches of two sorted lists of disjoint ``(start, end)``."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def idle_split(trace):
    """The card's idle seconds in the traced window, split by the program's
    spans: ``piece`` inside a graph piece's span (``nt.piece.*``, within
    ``nt.optimize``), ``driver`` inside ``nt.optimize`` outside every
    piece, ``outside`` the rest of the window (the harness between calls);
    the three add up to the window's idle time.  ``by_piece`` splits
    ``piece`` by the piece's name (without ``nt.piece.``); ``harness`` is
    the part of ``outside`` within the harness's own ``optimize`` spans.
    ``pieces`` is the number of piece spans.  None without a trace or an
    ``nt.optimize`` span."""
    if trace is None:
        return None
    calls = spans(trace, lambda n: n == OPTIMIZE)
    if not calls:
        return None
    gaps = trace.gaps()
    in_calls = intersect(gaps, calls)
    names = sorted({n for n, _, _ in trace.host if n.startswith(PIECE)})
    by_piece = {n.removeprefix(PIECE): length(intersect(in_calls, spans(trace, n.__eq__))) * 1e-6
                for n in names}
    in_pieces = length(intersect(in_calls, spans(trace, lambda n: n.startswith(PIECE))))
    harness = intersect(gaps, spans(trace, HARNESS_OPTIMIZE.__eq__))
    return {"piece": in_pieces * 1e-6, "driver": (length(in_calls) - in_pieces) * 1e-6,
            "outside": (length(gaps) - length(in_calls)) * 1e-6, "by_piece": by_piece,
            "harness": (length(harness) - length(intersect(harness, calls))) * 1e-6,
            "pieces": sum(name.startswith(PIECE) for name, _, _ in trace.host)}


def totals():
    """The program's process totals (``profiling.totals()``, a Counter),
    or None where the program keeps none."""
    try:
        from nllstpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "totals", None)
    return None if read is None else read()
