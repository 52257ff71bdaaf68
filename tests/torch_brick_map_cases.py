"""The skip maps both test modules of K1's map inputs run
(``test_torch_brick_maps``: the plain twin on the CPU;
``test_torch_frame_glue_cuda``: the kernel on the card)."""

import numpy as np

# (the map's shape, the volume's) as the frame hands them, transposed for
# the slice axis: the kingsnake's map (795 x 1024 x 1024 at block 4) along
# each axis, the beetle's (494 x 832 x 832), the (1, 1, 1) stand-in for no
# map, widths that are not multiples of the pooling factors, and a map
# fewer than 8 rows deep.
SHAPES = {
    "kingsnake-z": ((199, 256, 256), (795, 1024, 1024)),
    "kingsnake-y": ((256, 199, 256), (1024, 795, 1024)),
    "kingsnake-x": ((256, 199, 256), (1024, 795, 1024)),
    "beetle": ((124, 208, 208), (494, 832, 832)),
    "no-map": ((1, 1, 1), (64, 40, 40)),
    "ragged": ((10, 13, 27), (40, 52, 108)),
    "shallow-v": ((12, 5, 300), (48, 20, 1200)),
}
# Slabs per volume plane: aligned sampling, and a plane-pair lerp.
SLABS = {"aligned": 1.0, "lerp": 0.6}
CONTENTS = ("empty", "full", "random", "first", "last")


def case_map(map_shape, content: str) -> np.ndarray:
    """A u8 skip map (0 = occupied; otherwise a distance): none occupied,
    all, a random mix, or one occupied cell in the first or last plane."""
    rng = np.random.default_rng(sum(map_shape) + CONTENTS.index(content))
    if content == "full":
        return np.zeros(map_shape, np.uint8)
    if content == "random":
        return rng.integers(0, 6, map_shape, dtype=np.uint8)
    occ = rng.integers(1, 30, map_shape, dtype=np.uint8)
    if content in ("first", "last"):
        m = 0 if content == "first" else map_shape[0] - 1
        occ[m, rng.integers(map_shape[1]), rng.integers(map_shape[2])] = 0
    return occ


def case_slabs(vol_shape, slabs: str) -> int:
    """The slab count of ``SLABS[slabs]``, as the engine rounds it."""
    return int(max(2, round(vol_shape[0] * SLABS[slabs])))
