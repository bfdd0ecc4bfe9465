"""The yardstick's peaks and work counts.

Peaks: NVIDIA's published H100 SXM figures at the full 700 W power limit
(3.35 TB/s of HBM3; 67 TFLOP/s in float32 outside the tensor cores).  The
run prints the card's power limit beside them.

The counts are worked out from the cell's own shapes, for the work the
algorithm needs whatever implements it: each input byte read once, each
output byte written once.  They are copied from the bound functions of the
repository's smoke check (``assembly_flops``, ``struct_work``), restated over
the observation pattern instead of the program's tables.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
#: Bytes of a float32 value: every counted value is one.
ELT = 4


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the float32 operations over their rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)


def assembly_flops(n_obs: int, dr: int, dl: int, n: int) -> int:
    """Operations of assembling ``n_obs`` observations of ``n`` residual rows:
    g_l, the h_ll upper triangle, the W block, the a_rr upper triangle and
    b_r, each entry a length-n product, then ρ′· and + 2ρ″·g·g (2n + 5
    operations)."""
    entries = dl * (dl + 1) // 2 + dl * dr + dr * (dr + 1) // 2
    return n_obs * (2 * dl + entries * (2 * n + 5) + 2 * dr)


def assembly_work(shapes: dict) -> tuple:
    """``(bytes, operations)`` of one assembly of the Schur blocks from the
    residuals and Jacobians: per observation its Jacobian row block, its
    residual, ρ′ and ρ″ and its two indices in; per point h_ll and g_l, per
    observation its W block, per camera a_rr and b_r out."""
    k, c, p = shapes["n_obs"], shapes["n_cams"], shapes["n_pts"]
    n, dr, dl = shapes["n"], shapes["dr"], shapes["dl"]
    nbytes = k * ((n * (dr + dl) + n + 2) * ELT + 8) + ELT * (
        p * (dl * dl + dl) + k * dl * dr + c * (dr * dr + dr))
    return nbytes, assembly_flops(k, dr, dl, n)


def reduction_work(shapes: dict) -> tuple:
    """``(bytes, operations)`` of one damped reduction to the camera system
    on W's block structure: each (point, camera) block of W read once, each
    point's h_ll and g_l read once, the incidence list once; per block Y =
    H⁻¹W and its rhs term, per point and camera pair i ≤ j the block Y_iᵀW_j
    (the upper triangle on i = j); S, its rhs and the inverses written once."""
    tracks = np.asarray(shapes["tracks"], dtype=np.int64)  # distinct cameras per point
    dr, dl, c = shapes["dr"], shapes["dl"], shapes["n_cams"]
    p = tracks.shape[0]
    held = int(tracks.sum()) * dr  # W's columns held, over all points
    nbytes = (held * dl + p * dl * dl + p * dl) * ELT + int(tracks.sum()) * 8
    nbytes += ((c * dr) ** 2 + c * dr + p * dl * dl) * ELT
    pairs_off = int((tracks * (tracks - 1) // 2).sum())
    entries = int(tracks.sum()) * dr * (dr + 1) // 2 + pairs_off * dr * dr
    ops = 2 * dl * entries + 2 * dl * dl * held + 2 * dl * held
    return nbytes, ops
