"""The least time the card could take for the distance kernels' work.

Frozen copy (commit 6863543) of ``chip_smoke.py``'s ``bound`` and
``distance_bound`` and their constants: the larger of the bytes (each
input map read once, each output map written once) over the H100's
device-memory rate and the operations over its float32 rate outside the
tensor cores (the distance kernels' integer work counted at that rate).
Both rates are NVIDIA's published H100 SXM figures at 700 W.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# One step of a distance map (load, compare, min, store). Each pass of an
# x-scan takes one step per cell, and each output cell one step per sense
# of its relaxation: the least any exact method needs.
OPS_PER_STEP = 4


def bound_ms(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S) * 1e3


def distance_bound_ms(n_in: int, n_out: int, cells: int, scan_passes: int,
                      senses: int) -> float:
    """``n_in`` u8 maps read and ``n_out`` written once, of ``cells`` cells
    each; ``scan_passes`` x-scan passes and ``senses`` relaxation senses
    per output map."""
    return bound_ms((n_in + n_out) * cells,
                    OPS_PER_STEP * cells * (scan_passes + n_out * senses))


def edit_bound_ms(map_shape_zyx, skipmode: int) -> float | None:
    """One TF edit's distance kernels: K3 (two one-sided x-scans, four
    outputs of one y sense each) and K4 (eight outputs of one z sense
    each) at skipmode 3; K5 (the two-sided x-scan, a two-sided y-relax)
    and the two-sided K4 at skipmode 2. None at skipmodes without a
    distance map."""
    cells = math.prod(map_shape_zyx)
    if skipmode == 3:
        return (distance_bound_ms(1, 4, cells, 2, 1)
                + distance_bound_ms(4, 8, cells, 0, 1))
    if skipmode == 2:
        return (distance_bound_ms(1, 1, cells, 2, 2)
                + distance_bound_ms(1, 1, cells, 0, 2))
    return None
