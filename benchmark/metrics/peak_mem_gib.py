"""The device allocator's peak over set-up and window
(``torch.cuda.max_memory_allocated``), in GiB: it bounds the largest problem
that fits on one card."""

LAYER, UNIT, SOURCE, MOVES = "end to end", "GiB", "device_trace", None


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
