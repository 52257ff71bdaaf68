"""The occupancy map and the occupied-voxel count (``accel/occupancy.py``):
the port's integer and float paths against the JAX package's, on the CPU.

The float path (a TF range that is not monotone, ``imin > imax``) is held
cell for cell to the JAX ``occupancy_map`` and ``occupied_voxel_count``,
with a precomputed or an on-the-fly gradient, at block sizes that do not
divide the volume, and to the port's own integer path wherever a TF is
monotone. ``voxel_alpha_positive`` is checked at every u8 intensity and
intensity x gradient pair.

XLA's CPU compiler fuses the jitted float test's ``v * (1/255) - lo`` into
a fused multiply-add. Where a TF edge is exactly a u8 level (1/3 = 85/255,
0.6 = 153/255, 1.0 = 255/255) the exact result is 0 and the fused one a tiny non-zero
value, so the jitted test (the JAX engine's path) flips that level. The
port rounds each operation, as JAX does op by op, its integer path and
the reference's shader; the flips are pinned by count below and listed in
ROADMAP C.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkvolume_tpu.accel import occupancy as jocc
from vkvolume_tpu.tf import transfer_function as jtf
from vkvolume_tpu_torch.accel import occupancy as tocc
from vkvolume_tpu_torch.tf import transfer_function as ttf
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# Every u8 intensity paired with every u8 gradient value.
_V = np.arange(256, dtype=np.uint8)
_VI, _GI = (a.reshape(16, 64, 64).copy()
            for a in np.meshgrid(_V, _V, indexing="ij"))
_EDGES = (0.0, 0.05, 0.086, 0.1, 0.12, 0.2, 0.25, 0.3, 1 / 3, 0.35, 0.4,
          0.5, 0.6, 0.7, 0.8, 0.9, 0.999, 1.0)


def _tfs(imin, imax, gmin, gmax):
    kw = dict(intensity_min=imin, intensity_max=imax, gradient_min=gmin,
              gradient_max=gmax)
    return jtf.tf_params(**kw), ttf.tf_params(**kw)


def _on_edge(u8, edge):
    """The voxels whose u8 value, times f32(1/255), is exactly ``edge``."""
    return (u8.astype(np.float32) * np.float32(1.0 / 255.0)
            == np.float32(edge))


@pytest.mark.parametrize("imin,imax,gmin,gmax,fma_flips", [
    (0.1, 0.7, 0.0, 0.0, 0),            # monotone, intensity only
    (0.7, 0.1, 0.0, 0.0, 0),            # inverted intensity range
    (0.35, 0.8, 0.6, 0.2, 0),           # inverted gradient range
    (0.9, 0.3, 0.8, 0.12, 0),           # both inverted
    (1.0, 2.0, 0.0, 0.0, 256),          # none positive; 1.0 is level 255
    (1 / 3, 0.5, 0.0, 0.0, 256),        # edge on the u8 level 85
    (0.8, 0.6, 0.6, 0.8, 204),          # gradient edge on the level 153
    (0.999, 1 / 3, 1 / 3, 0.999, 255),  # inverted, gradient edge on 85
])
def test_voxel_alpha_positive_at_every_u8_pair(imin, imax, gmin, gmax,
                                               fma_flips):
    jt, tt = _tfs(imin, imax, gmin, gmax)
    got = tocc.voxel_alpha_positive(torch.from_numpy(_VI),
                                    torch.from_numpy(_GI), tt).numpy()
    # JAX op by op: equal at every pair.
    eager = np.asarray(jocc.voxel_alpha_positive(jnp.asarray(_VI),
                                                 jnp.asarray(_GI), jt))
    np.testing.assert_array_equal(got, eager)
    # Jitted, as the JAX engine runs it: flips only on an exact edge.
    fused = np.asarray(jax.jit(jocc.voxel_alpha_positive)(
        jnp.asarray(_VI), jnp.asarray(_GI), jt))
    flips = got != fused
    assert int(flips.sum()) == fma_flips
    assert not (flips & ~(_on_edge(_VI, imin) | _on_edge(_GI, gmin))).any()
    # Without a gradient TF, the test of intensity alone.
    jt1, tt1 = _tfs(imin, imax, 0.0, 0.0)
    got1 = tocc.voxel_alpha_positive(torch.from_numpy(_VI), None,
                                     tt1).numpy()
    np.testing.assert_array_equal(got1, np.asarray(
        jocc.voxel_alpha_positive(jnp.asarray(_VI), None, jt1)))


def test_float_path_equals_integer_path_for_monotone_tfs():
    """For every monotone pair of edges, with and without a gradient range,
    the float path's map and count equal the integer path's (both round
    each operation)."""
    rng = np.random.default_rng(7)
    vol = torch.from_numpy((rng.random((11, 13, 14)) ** 2 * 255.0)
                           .astype(np.uint8))
    grad = torch.from_numpy(rng.integers(0, 256, (11, 13, 14),
                                         dtype=np.uint8))
    shape = (4, 5, 5)
    n = 0
    for lo in _EDGES:
        for hi in _EDGES:
            if hi <= lo:
                continue
            for g in ((0.0, 0.0), (lo, hi)):
                _, tt = _tfs(lo, hi, *g)
                thr = tocc._tf_thresholds(tt)
                assert thr is not None
                gu = grad if tt.use_gradient else None
                np.testing.assert_array_equal(
                    tocc._occupancy_general(vol, gu, tt, shape).numpy(),
                    tocc._occupancy_u8(vol, gu, shape, *thr).numpy())
                want = tocc._count_u8(vol, gu, *thr)
                assert int(tocc.voxel_alpha_positive(vol, gu, tt).sum()) \
                    == want
                n += 1
    assert n == 2 * len(_EDGES) * (len(_EDGES) - 1) // 2


def _volume(shape, seed=3):
    """Dim noise and three blobs whose cores saturate over several blocks
    (empty under an inverted intensity range)."""
    rng = np.random.default_rng(seed)
    vol = rng.random(shape) ** 4 * 120.0
    zz, yy, xx = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    for _ in range(3):
        c = rng.random(3) * np.asarray(shape)
        r2 = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
        vol += 700.0 * np.exp(-r2 / 40.0)
    return np.clip(vol, 0, 255).astype(np.uint8)


TFS = {
    "monotone": (0.35, 0.8, 0.0, 0.0),
    "monotone-grad": (0.15, 0.9, 0.05, 0.45),
    "inverted": (0.7, 0.15, 0.0, 0.0),
    "inverted-grad": (0.15, 0.9, 0.45, 0.05),
    "both-inverted-grad": (0.8, 0.35, 0.4, 0.12),
    "none-positive": (1.0, 2.0, 0.0, 0.0),
}


@pytest.mark.parametrize("block", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("tf_key", sorted(TFS))
def test_occupancy_map_and_count_match_jax(tf_key, block):
    imin, imax, gmin, gmax = TFS[tf_key]
    vol = _volume((17, 23, 29))
    jt, tt = _tfs(imin, imax, gmin, gmax)
    from vkvolume_tpu.accel.gradient import gradient_map as jgrad
    from vkvolume_tpu_torch.accel.gradient import gradient_map as tgrad

    jg = jgrad(jnp.asarray(vol), 1.0, use_gradient=True)
    tg = tgrad(torch.from_numpy(vol), 1.0, use_gradient=True)
    shape = tuple(-(-s // block) for s in vol.shape)
    tf_host = (imin, imax, gmin, gmax)
    maps = []
    for on_the_fly in (False, True):
        for host in (None, tf_host):
            want = np.asarray(jocc.occupancy_map(
                jnp.asarray(vol), jg, jt, shape,
                on_the_fly_gradient=on_the_fly, tf_host=host))
            got = tocc.occupancy_map(torch.from_numpy(vol), tg, tt, shape,
                                     on_the_fly_gradient=on_the_fly,
                                     tf_host=host).numpy()
            np.testing.assert_array_equal(got, want)
            n_want = int(jocc.occupied_voxel_count(
                jnp.asarray(vol), jg, jt, on_the_fly_gradient=on_the_fly,
                tf_host=host))
            n_got = tocc.occupied_voxel_count(
                torch.from_numpy(vol), tg, tt,
                on_the_fly_gradient=on_the_fly, tf_host=host)
            assert isinstance(n_got, int) and n_got == n_want
            maps.append(got)
    # The on-the-fly gradient is the precomputed one.
    for m in maps[1:]:
        np.testing.assert_array_equal(m, maps[0])
    if tf_key == "none-positive":
        assert (maps[0] == tocc.EMPTY).all() and n_got == 0
    else:
        assert 0 < n_got < vol.size
        if block == 2:
            assert (maps[0] == tocc.OCCUPIED).any() \
                and (maps[0] == tocc.EMPTY).any()
    assert (tocc._tf_thresholds(tt, tf_host) is None) == \
        tf_key.startswith(("inverted", "both"))


@pytest.mark.parametrize("skipmode", [1, 2, 3])
@pytest.mark.parametrize("use_precomputed_gradient", [True, False])
def test_engine_maps_for_inverted_tf_match_jax(skipmode,
                                               use_precomputed_gradient):
    """The engines' TF edits to an inverted intensity range (and an
    inverted gradient range), precomputed or on-the-fly gradients: maps
    bit-exact, the benchmark-mode occupancy equal."""
    from vkvolume_tpu.engine import Engine as JEngine
    from vkvolume_tpu.engine import RenderOptions as JRO
    from vkvolume_tpu.engine import VolumeOptions as JVO
    from vkvolume_tpu.engine import from_array as jfrom
    from vkvolume_tpu_torch.engine import Engine as TEngine
    from vkvolume_tpu_torch.engine import RenderOptions as TRO
    from vkvolume_tpu_torch.engine import VolumeOptions as TVO
    from vkvolume_tpu_torch.engine import from_array as tfrom
    from vkvolume_tpu_torch.options import SkippingType

    vol = _volume((21, 26, 30), seed=11)
    kw = dict(intensity_min=0.8, intensity_max=0.3, gradient_min=0.05,
              gradient_max=0.5,
              use_precomputed_gradient=use_precomputed_gradient)
    jeng = JEngine(JRO(skipping_type=SkippingType(skipmode)),
                   benchmark_mode=True, renderer="sweep")
    teng = TEngine(TRO(skipping_type=SkippingType(skipmode)),
                   benchmark_mode=True, renderer="pallas", device="cpu")
    jv, tv = jfrom(vol, JVO(**kw), block_size=3), tfrom(vol, TVO(**kw),
                                                        block_size=3,
                                                        device="cpu")
    js, ts = jeng.add_volume(jv), teng.add_volume(tv)
    assert ts.occupied_voxel_percent == js.occupied_voxel_percent
    np.testing.assert_array_equal(tv.dist_maps.numpy(),
                                  np.asarray(jv.dist_maps))
    assert (tv.gradient is None) == (not use_precomputed_gradient)
    for o in (jv.options, tv.options):
        o.gradient_min, o.gradient_max = 0.5, 0.05
    js, ts = (jeng.update_transfer_function(jv, timed_runs=1),
              teng.update_transfer_function(tv, timed_runs=1))
    assert ts.occupied_voxel_percent == js.occupied_voxel_percent
    np.testing.assert_array_equal(tv.dist_maps.numpy(),
                                  np.asarray(jv.dist_maps))


def _block_or_reference(vol, grad, map_shape, ti, tg):
    """numpy: a cell is OCCUPIED where one of its voxels passes ``v >= ti``
    (and ``g >= tg`` with a gradient map), cells of ``ceil(extent / map
    extent)`` voxels per axis; the padding past the ragged edge passes as
    a voxel of value 0 would (``0 >= ti``) without a gradient map, and
    never with one."""
    if ti > 255 or tg > 255:
        return np.full(map_shape, tocc.EMPTY, np.uint8)
    b = [-(-e // m) for e, m in zip(vol.shape, map_shape)]
    passed = vol >= ti
    if grad is not None:
        passed &= grad >= tg
    cells = np.full([m * k for m, k in zip(map_shape, b)],
                    grad is None and ti == 0)
    d, h, w = vol.shape
    cells[:d, :h, :w] = passed
    (mz, my, mx), (bz, by, bx) = map_shape, b
    occ = cells.reshape(mz, bz, my, by, mx, bx).any(axis=(1, 3, 5))
    return np.where(occ, tocc.OCCUPIED, tocc.EMPTY).astype(np.uint8)


# Ragged extents (x widths off multiples of 16), one voxel, and a map
# wider than ceil(extent / block) would make it (whole cells of padding).
@pytest.mark.parametrize("shape,map_shape", [
    ((1, 1, 1), None), ((37, 50, 61), None), ((9, 13, 45), None),
    ((6, 5, 33), None), ((4, 4, 4), (3, 3, 3))])
@pytest.mark.parametrize("block", [2, 3, 4, 5, 6])
def test_integer_path_is_a_block_or(shape, map_shape, block):
    """``_occupancy_u8`` (the plain version the kernel is held to) against a
    numpy block-OR, every threshold pair of the grid, with and without a
    gradient map."""
    rng = np.random.default_rng(block)
    vol = (rng.random(shape) ** 3 * 256).astype(np.uint8)
    grad = rng.integers(0, 256, shape, dtype=np.uint8)
    if map_shape is None:
        map_shape = tuple(-(-s // block) for s in shape)
    kinds = set()
    for ti in (0, 1, 128, 255, 256):
        for g, tg in [(None, 0)] + [(grad, t) for t in (0, 1, 255)]:
            got = tocc._occupancy_u8(
                torch.from_numpy(vol), None if g is None else
                torch.from_numpy(g), map_shape, ti, tg).numpy()
            want = _block_or_reference(vol, g, map_shape, ti, tg)
            assert got.dtype == np.uint8 and got.shape == map_shape
            np.testing.assert_array_equal(got, want)
            kinds.update(np.unique(got).tolist())
    assert kinds == {tocc.OCCUPIED, tocc.EMPTY}


def test_cpu_route_never_launches_the_kernel():
    """On the CPU the map takes the plain version: no kernel launch, by
    ``_occupancy_u8``, the public map or an engine's edits; the kernel's
    wrapper refuses a CPU tensor."""
    from vkvolume_tpu_torch.accel import occupancy_cuda
    from vkvolume_tpu_torch.engine import Engine, RenderOptions, from_array
    from vkvolume_tpu_torch.options import SkippingType

    before = dict(occupancy_cuda.LAUNCHES)
    vol = _volume((13, 17, 19), seed=5)
    t = torch.from_numpy(vol)
    for g in (None, t):
        tocc._occupancy_u8(t, g, (4, 5, 5), 40, 3)
    _, tt = _tfs(0.15, 0.9, 0.05, 0.45)
    tocc.occupancy_map(t, t, tt, (4, 5, 5))
    for skipmode in (2, 3):
        eng = Engine(RenderOptions(skipping_type=SkippingType(skipmode)),
                     renderer="pallas", device="cpu")
        v = from_array(vol, block_size=4, device="cpu")
        eng.add_volume(v)
        eng.update_transfer_function(v)
    assert occupancy_cuda.LAUNCHES == before == {"occupancy": 0}
    with pytest.raises(ValueError, match="CUDA"):
        occupancy_cuda.occupancy_u8(t, None, (4, 5, 5), 40, 0)
