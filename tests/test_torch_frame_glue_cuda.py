"""The frame glue's kernels (``csrc/frame_glue.cu``, ``render/frame_cuda.py``)
against their plain twins on the same CUDA tensors, and the w-grid frame
that runs them. Marked ``cuda``: they skip without a CUDA device. On a
machine with a card and without JAX (from the repository's root):

    python -m pytest --noconftest -m cuda -q \\
        tests/test_torch_frame_glue_cuda.py

The volume has the kingsnake's extent (795 x 1024 x 1024, the benchmark's
stretch fit) with random boxes of random texture in it, under TF-b
(intensity 0.2-0.8, gradient 0.06-0.12) and the isotropic distance map, at
1200 x 1200 (the engine pads the image to 1280 columns). The poses take
the two-pass warp's variant A (the benchmark's still pose, and one with
the opposite sweep sign), variant B and the single-pass warp (K8), along
all three slice axes. Tolerances:

* ``frame_grid`` and the epilogue's lum and alpha: bit for bit, since the
  plain versions are elementwise float32 operations that the kernels round
  in the same order;
* the positions: 2e-5 relative (2e-5 grid cells below one cell) where both
  cover the pixel, the coverage differing on at most 0.01 % of them: the
  plain pixel rays come from matrix products that cuBLAS sums in another
  order;
* the epilogue's depth: 1e-6, for the same reason (its clip position);
* the whole frame: at most 0.01 % of the pixels beyond 8/255 of the frame
  the plain glue draws (the caller's-rays route of ``_frame_body``).
"""

import warnings

import numpy as np
import pytest
import torch

from vkvolume_tpu_torch.bench.harness import benchmark_camera
from vkvolume_tpu_torch.engine import (Engine, RenderOptions, SkippingType,
                                       VolumeOptions, from_array)
from vkvolume_tpu_torch.render import (frame_cuda, sweep_bricks,
                                       sweep_frame, warp_cuda)
from vkvolume_tpu_torch.render.ray_setup import make_rays

pytestmark = pytest.mark.cuda

SHAPE = (795, 1024, 1024)          # the kingsnake, (z, y, x)
SIZE = 1200
TF_B = dict(intensity_min=0.2, intensity_max=0.8, gradient_min=0.06,
            gradient_max=0.12)
# (azimuth, elevation) -> (the plan's warp, its slice axis).
POSES = {(30.0, 20.0): ("A", 2), (150.0, 20.0): ("A", 2),
         (100.0, 20.0): ("B", 0), (90.0, 20.0): ("K8", 0),
         (30.0, 70.0): ("B", 1)}
POS_RTOL = 2e-5
COVER_DIFF = 1e-4                   # share of positions
DEPTH_TOL = 1e-6
FRAME_GT8_PCT = 0.01


def _boxes(dev, seed=0):
    """Zero, with random boxes of random values: occupied and empty map
    cells, surfaces in every direction."""
    g = torch.Generator(device=dev).manual_seed(seed)
    vol = torch.zeros(SHAPE, dtype=torch.uint8, device=dev)
    corners = torch.rand((200, 3), generator=g, device=dev)
    sizes = torch.randint(8, 160, (200, 3), generator=g, device=dev)
    for c, s in zip(corners.cpu().tolist(), sizes.cpu().tolist()):
        lo = [int(ci * n) for ci, n in zip(c, SHAPE)]
        box = vol[lo[0]:lo[0] + s[0], lo[1]:lo[1] + s[1], lo[2]:lo[2] + s[2]]
        box.copy_(torch.randint(0, 256, box.shape, generator=g, device=dev,
                                dtype=torch.uint8))
    return vol


@pytest.fixture(scope="module")
def engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    eng = Engine(RenderOptions(skipping_type=SkippingType.DISTANCE,
                               clip_distance=50.0,
                               early_ray_termination=True),
                 renderer="pallas", device=dev)
    with warnings.catch_warnings():
        # from_array copies its array with torch.tensor, which warns when
        # handed a tensor.
        warnings.simplefilter("ignore", UserWarning)
        vol = from_array(_boxes(dev), VolumeOptions(**TF_B), block_size=4,
                         device=dev)
    d, h, w = SHAPE
    vol.set_scale((100.0 / w, 100.0 / h, 100.0 / d))
    eng.add_volume(vol)
    torch.cuda.synchronize()
    return eng


def _capture(eng, cam):
    """One frame of ``cam``, with what its w-grid frame was handed and
    computed: ``_frame_body``'s arguments, the glue's geometry and K1's
    outputs (lum, alpha, firsts), and the frame."""
    got = {}
    saved = (sweep_frame._frame_body, frame_cuda.frame_epilogue)

    def body(*a, **k):
        got["body"] = (a, k)
        return saved[0](*a, **k)

    def epilogue(geom, lum, alpha, firsts):
        got["geom"], got["k1"] = geom, (lum, alpha, firsts)
        return saved[1](geom, lum, alpha, firsts)

    sweep_frame._frame_body, frame_cuda.frame_epilogue = body, epilogue
    try:
        got["out"] = eng.render(cam, SIZE, SIZE)
    finally:
        sweep_frame._frame_body, frame_cuda.frame_epilogue = saved
    torch.cuda.synchronize()
    assert eng.last_renderer == "pallas" and "geom" in got, \
        "the frame did not take the glue kernels"
    return got


@pytest.fixture(scope="module")
def frames(engine):
    out = {}
    for (az, el), (warp, p_axis) in POSES.items():
        got = _capture(engine, benchmark_camera(1.0, az, el))
        assert (got["geom"].warp, got["geom"].p_axis) == (warp, p_axis)
        out[(az, el)] = got
    return out


def _dev(engine):
    return engine.volumes[0].density.device


@pytest.mark.parametrize("pose", POSES)
def test_frame_grid_bit_exact(engine, frames, pose):
    geom = frames[pose]["geom"]
    got = frame_cuda.frame_grid(geom, _dev(engine))
    want = frame_cuda.grid_plain(geom, _dev(engine))
    torch.cuda.synchronize()
    names = ("wu", "wv", "s_lo", "s_hi", "kappa", "cov")
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                   msg=lambda m: f"{name}: {m}")
    assert bool(got[5].any())


@pytest.mark.parametrize("pose", POSES)
def test_frame_positions_match(engine, frames, pose):
    geom = frames[pose]["geom"]
    got = frame_cuda.frame_positions(geom, _dev(engine))
    want = frame_cuda.positions_plain(geom, _dev(engine))
    torch.cuda.synchronize()
    for name, g, w in zip(frame_cuda.Positions._fields, got, want):
        assert (g is None) == (w is None), name
        if g is None:
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, name
        vg, vw = g > -5.0, w > -5.0
        differ = float((vg != vw).to(torch.float64).mean())
        both = vg & vw
        err = ((g - w).abs() / w.abs().clamp(min=1.0))[both]
        worst = float(err.max()) if err.numel() else 0.0
        print(f"{pose} {geom.warp} {name} {tuple(g.shape)}: coverage "
              f"differs on {differ:.3g}, worst error {worst:.3g}, exact "
              f"{float((g == w).to(torch.float64).mean()):.4f}")
        assert differ <= COVER_DIFF, (name, differ)
        assert worst <= POS_RTOL, (name, worst)


@pytest.mark.parametrize("pose", POSES)
def test_frame_epilogue_matches(engine, frames, pose):
    f = frames[pose]
    lum, alpha, firsts = f["k1"]
    got = frame_cuda.frame_epilogue(f["geom"], lum, alpha, firsts)
    want = frame_cuda.epilogue_plain(f["geom"], lum, alpha, firsts)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (3, f["geom"].Hi, f["geom"].Wi)
    assert torch.equal(got[:2], want[:2])
    err = float((got[2] - want[2]).abs().max())
    hits = int((want[2] > 0.0).sum())
    print(f"{pose}: depth err {err:.3g} over {hits} hits")
    assert hits > 0 and err <= DEPTH_TOL


def test_one_launch_of_each_per_frame(engine, frames):
    cam = benchmark_camera(1.0, 30.0, 20.0)
    before = dict(frame_cuda.LAUNCHES)
    k1 = sweep_bricks.LAUNCHES["sweep_bricks"]
    k2 = warp_cuda.LAUNCHES["resample_rows"]
    for _ in range(3):
        engine.render(cam, SIZE, SIZE)
    torch.cuda.synchronize()
    assert {k: frame_cuda.LAUNCHES[k] - before[k] for k in before} == {
        "frame_grid": 3, "frame_positions": 3, "frame_epilogue": 3}
    assert sweep_bricks.LAUNCHES["sweep_bricks"] - k1 == 3
    assert warp_cuda.LAUNCHES["resample_rows"] - k2 == 6


def test_no_sync_inside_the_frame(engine, frames):
    """A cached pose's frame, from its first launch to its return, neither
    copies to the card from pageable memory nor waits for it."""
    cam = benchmark_camera(1.0, 30.0, 20.0)
    engine.render(cam, SIZE, SIZE)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine.render(cam, SIZE, SIZE)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("pose", POSES)
def test_frame_matches_the_plain_glue_frame(engine, frames, pose):
    """The frame through the glue kernels against the same frame through
    the plain glue (``_frame_body`` handed its own pixel rays)."""
    a, k = frames[pose]["body"]
    uniforms = sweep_frame.unpack_frame_scalars(a[3])[0]
    fused = sweep_frame._frame_body(*a, **k)
    plain = sweep_frame._frame_body(
        *a, **k, rays=make_rays(uniforms, k["height"], k["width"],
                                _dev(engine)))
    torch.cuda.synchronize()
    diff = (fused.color - plain.color).abs().amax(-1)
    gt8 = 100.0 * float((diff > 8.0 / 255.0).to(torch.float64).mean())
    covered = 100.0 * float((plain.color[..., 3] > 8.0 / 255.0)
                            .to(torch.float64).mean())
    print(f"{pose}: {gt8:.4g} % of pixels beyond 8/255 (covered "
          f"{covered:.3g} %), max {float(diff.max()):.3g}")
    assert covered > 1.0
    assert gt8 <= FRAME_GT8_PCT
    np.testing.assert_array_equal(fused.num_volume_samples.cpu().numpy(),
                                  plain.num_volume_samples.cpu().numpy())
