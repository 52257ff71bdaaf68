"""The CUDA kernels against their plain PyTorch versions on the card, at
small shapes. Marked ``cuda``: they skip without a CUDA device. On a
machine with a card and without JAX, run them without this directory's
conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from vkvolume_tpu_torch.accel import distance, distance_cuda
from vkvolume_tpu_torch.bench.harness import benchmark_camera, make_engine
from vkvolume_tpu_torch.options import Test as TTest
from vkvolume_tpu_torch.render import sweep_bricks, sweep_frame, warp_cuda
from torch_sweep_frames import frame_parts

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on_card(a: np.ndarray, dev, offset: int = 0) -> torch.Tensor:
    """``a`` as a contiguous tensor on the card whose base lies ``offset``
    bytes past an aligned one (a slice of a larger buffer)."""
    buf = torch.empty(a.nbytes + offset, dtype=torch.uint8, device=dev)
    t = buf[offset:].view(torch.from_numpy(a).dtype).view(a.shape)
    t.copy_(torch.from_numpy(a))
    return t


# Tile edges of the line kernels: X and Y off multiples of the tile width
# (and of 4), Z = 1, and z lines of 3000 cells, longer than one table holds
# (segments with halos). K3: cap 255 (8 levels, a 255-row halo), a 520 x
# 520 plane (x tiled), y lines of 3000 cells (segments with a halo of cap)
# and an input whose base is not 4-byte aligned (byte loads).
@pytest.mark.parametrize("shape,p,cap,offset", [
    ((9, 11, 13), 0.1, 63, 0), ((13, 7, 140), 0.03, 63, 0),
    ((24, 32, 40), 0.004, 15, 0), ((5, 7, 33), 0.05, 63, 0),
    ((1, 37, 70), 0.05, 63, 0), ((3000, 2, 3), 0.002, 63, 0),
    ((9, 11, 13), 0.1, 255, 0), ((2, 520, 520), 0.0005, 63, 0),
    ((2, 520, 520), 0.0005, 255, 0), ((1, 3000, 5), 0.001, 63, 0),
    ((1, 3000, 8), 0.0005, 255, 0), ((13, 7, 140), 0.03, 1, 0),
    ((13, 7, 140), 0.03, 63, 1), ((4, 40, 64), 0.01, 63, 3)])
def test_distance_kernels_bit_exact(dev, shape, p, cap, offset):
    rng = np.random.default_rng(0)
    occ = _on_card(np.where(rng.random(shape) < p, 0, 255).astype(np.uint8),
                   dev, offset)
    before = distance_cuda.LAUNCHES["scan_and_relax_multi"]
    xy = distance_cuda.scan_and_relax_multi(occ, cap)
    assert distance_cuda.LAUNCHES["scan_and_relax_multi"] == before + 1
    torch.testing.assert_close(xy, distance.scan_and_relax_multi(occ, cap),
                               rtol=0, atol=0)
    torch.testing.assert_close(distance_cuda.relax_z_direct_multi(xy),
                               distance.relax_z_direct_multi(xy), rtol=0,
                               atol=0)


@pytest.mark.parametrize("shape,p", [((9, 11, 13), 0.1), ((13, 7, 140), 0.03),
                                     ((70, 9, 300), 0.0), ((1, 45, 77), 0.02),
                                     ((3, 130, 9), 0.01), ((2, 520, 520), 0.0),
                                     ((2, 520, 520), 0.0005),
                                     ((1, 3000, 5), 0.001),
                                     ((3000, 2, 3), 0.002)])
def test_isotropic_kernels_bit_exact(dev, shape, p):
    """K5 and the two-sided K4 (p=0: one occupied cell, distances past
    255 cells saturate). A 520 x 520 plane (264 KB) is more than a block's
    shared memory: K5 tiles x. Lines of 3000 cells run in segments."""
    rng = np.random.default_rng(0)
    occ = np.where(rng.random(shape) < p, 0, 255).astype(np.uint8)
    occ[0, 0, 0] = 0
    occ = torch.tensor(occ, device=dev)
    xy = distance_cuda.scan_and_relax(occ)
    torch.testing.assert_close(xy, distance.scan_and_relax(occ, 0, (0,)),
                               rtol=0, atol=0)
    z = distance_cuda.relax_z_direct(xy[0])
    torch.testing.assert_close(z, distance.relax_z_direct(xy[0], (0,)),
                               rtol=0, atol=0)
    torch.testing.assert_close(distance_cuda.isotropic_distance_cuda(occ)[0],
                               distance.isotropic_distance(occ), rtol=0,
                               atol=0)


@pytest.mark.parametrize("u16,encode", [(True, True), (True, False),
                                        (False, False), (False, True)])
def test_resample_rows_kernel(dev, u16, encode):
    rng = np.random.default_rng(1)
    C, Ho, Wo, Ws = 3, 24, 384, 301
    pos = (rng.random((Ho, Wo)) * (Ws + 4) - 3).astype(np.float32)
    pos[rng.random((Ho, Wo)) < 0.1] = -10.0
    if u16:
        src = rng.integers(0, 65536, (C, Ho, Ws)).astype(np.uint16)
    else:
        src = rng.random((C, Ho, Ws)).astype(np.float32)
    s, q = torch.tensor(src, device=dev), torch.tensor(pos, device=dev)
    got = warp_cuda.resample_rows(s, q, encode_out=encode)
    want = warp_cuda.resample_rows_reference(s, q, encode_out=encode)
    assert got.dtype == want.dtype
    if encode:
        assert int((got.int() - want.int()).abs().max()) <= 1
    else:
        scale = 65535.0 if u16 else 1.0
        assert float((got - want).abs().max()) <= 1e-6 * scale


def _warp_case(rng, variant, C, Hi, Wi, H, W):
    """Random grid channels in [0, 1] (a count channel of integers as the
    fourth) and pass positions with masked cells and both clamps touched,
    for warp variant A or B; the scales the frame gives them."""
    chans = rng.random((C, Hi, Wi)).astype(np.float32)
    if C == 4:
        chans[3] = rng.integers(0, 1700, (Hi, Wi))
    Hp = -(-H // 128) * 128

    def pos(lines, n_pos, n_src):
        q = rng.uniform(-3.0, n_src + 2.0, (lines, n_pos)).astype(np.float32)
        q[rng.random((lines, n_pos)) < 0.1] = -10.0
        return q

    if variant == "A":
        p1, p2 = pos(Hi, W, Wi), pos(W, Hp, Hi)
    else:
        p1, p2 = pos(Wi, Hp, Hi), pos(Hp, W, Wi)
    return chans, p1, p2, ([65535.0] * 3 + [1.0])[:C]


# Rows off 32 and off 16 bytes: Hi and Wi odd (u16 and f32 rows), H off
# the padding.
@pytest.mark.parametrize("C", [3, 4])
@pytest.mark.parametrize("variant", ["A", "B"])
@pytest.mark.parametrize("Hi,Wi,H,W", [(67, 77, 50, 90), (40, 33, 130, 61)])
def test_warp_two_pass_kernels(dev, variant, C, Hi, Wi, H, W):
    """The two-pass warp (two K2 launches) against its plain version:
    u16 within 1 LSB per pass, so the decoded output within 1 LSB of each
    channel's scale (plus 1e-6 of it); the measured maximum is printed."""
    rng = np.random.default_rng(Hi + C)
    chans, p1, p2, scales = _warp_case(rng, variant, C, Hi, Wi, H, W)
    args = [torch.tensor(a, device=dev) for a in (chans, p1, p2)]
    fused, plain = ((warp_cuda.warp_two_pass_b, warp_cuda.warp_two_pass_b_plain)
                    if variant == "B" else
                    (warp_cuda.warp_two_pass, warp_cuda.warp_two_pass_plain))
    before = warp_cuda.LAUNCHES["resample_rows"]
    got = fused(*args, scales=scales)
    assert warp_cuda.LAUNCHES["resample_rows"] == before + 2
    want = plain(*args, scales=scales)
    assert got.shape == want.shape == (C, -(-H // 128) * 128, W)
    sc = torch.tensor(scales, device=dev)[:, None]
    err = ((got - want).abs().reshape(C, -1).amax(1) * sc[:, 0]).max()
    print(f"two-pass warp {variant}, C={C}: max error "
          f"{float(err):.3g} LSB of the scale")
    assert float(err) <= 1.0 + 1e-6 * 65535.0


# (dataset, skipmode, slab density): bench.py's aligned intensity-only
# frame; the CLI's gradient TF with the plane-pair lerp (n_slabs 166 != Np
# 49); the gradient TF aligned; the lerp with an intensity-only TF.
@pytest.mark.parametrize("key,skipmode,density", [
    ("beetle", 3, "auto"), ("beetle-grad", 2, "auto"),
    ("beetle-grad", 2, "axis"), ("beetle", 2, "ref")])
def test_frame_kernels_match_plain_versions(dev, key, skipmode, density):
    """A small beetle frame on the card: K1 against its plain version on
    the frame's own inputs, and the whole frame against the CPU engine."""
    eng, _, vol, _ = make_engine(key, skipmode, 4, scale=0.1,
                                 test=TTest.NONE, ert=True, device="cuda")
    cpu, _, _, _ = make_engine(key, skipmode, 4, volume_u8=vol,
                               test=TTest.NONE, ert=True, device="cpu")
    eng.options.slab_density = cpu.options.slab_density = density
    torch.testing.assert_close(eng.volumes[0].dist_maps.cpu(),
                               cpu.volumes[0].dist_maps, rtol=0, atol=0)
    cam = benchmark_camera(aspect=1.0)
    got = eng.render(cam, 256, 256).color.cpu()
    want = cpu.render(cam, 256, 256).color
    assert float((want[..., 3] > 0).float().mean()) > 0.05
    assert float((got - want).abs().amax(-1).gt(2e-3).float().mean()) <= 1e-3

    f = frame_parts(eng, cam, 256, 256)
    u, p, plan, gp, vol_t, occ_t, tf, grad_t, n_slabs = (
        f[k] for k in ("u", "p", "plan", "gp", "vol_t", "occ_t", "tf",
                       "grad_t", "n_slabs"))
    assert (grad_t is not None) == bool(tf.use_gradient)
    aligned = density == "axis" or (density == "auto"
                                    and not tf.use_gradient)
    assert (n_slabs == vol_t.shape[0]) == aligned
    wu, wv = sweep_frame.w_grid(gp, plan["Hi"], plan["Wi"], dev)
    sgn = 1 if plan["sgn_p"] > 0 else -1
    fields = sweep_bricks.grid_fields(u, wu, wv, sgn, p, max(vol_t.shape),
                                      n_slabs)
    for ert in (True, False):
        inp = sweep_bricks.brick_inputs(
            vol_t, occ_t, tf, u, (wu, wv, *fields[:2], fields[3],
                                  fields[2]),
            p_axis=p, ert=ert, count_samples=True, n_slabs=n_slabs,
            sgn=sgn, tile_h=plan["tile_h"], dist_leap=skipmode >= 2,
            grad_t=grad_t)
        k = sweep_bricks.sweep_bricks_kernel(inp)
        r = sweep_bricks.sweep_bricks_reference(inp)
        assert torch.equal(k[3], r[3]) and torch.equal(k[2], r[2])
        assert float((k[0] - r[0]).abs().max()) <= 1e-5
        assert float((k[1] - r[1]).abs().max()) <= 1e-5


@pytest.mark.parametrize("shape", [(21, 10, 140), (1, 9, 33), (3000, 5, 3),
                                   (2, 3000, 5), (2, 520, 520)])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("direction", [0, 1, -1])
def test_relax_kernel_bit_exact(dev, axis, direction, shape):
    """K6 along z or y, two- or one-sided, on tile edges: Z = 1, lines of
    3000 cells (segments), a 520 x 520 plane."""
    rng = np.random.default_rng(axis * 3 + direction + 1)
    occ = torch.tensor(np.where(rng.random(shape) < 0.01, 0, 255)
                       .astype(np.uint8), device=dev)
    D = distance.axis_scan(occ, 2, 0).clamp(max=255).to(torch.uint8)
    got = distance_cuda.relax(D, axis, direction)
    torch.testing.assert_close(
        got, distance.relax(D, axis, direction).to(torch.uint8), rtol=0,
        atol=0)


@pytest.mark.parametrize("C", [3, 4])
def test_warp_pixels_kernel(dev, C):
    """K8 against its plain version: uncovered pixels and positions past
    the grid's edges included."""
    rng = np.random.default_rng(C)
    Hi, Wi, H, W = 72, 640, 40, 384
    chans = torch.tensor(rng.random((C, Hi, Wi)).astype(np.float32),
                         device=dev)
    gx = rng.uniform(-3.0, Wi + 2.0, (H, W)).astype(np.float32)
    gx[rng.random((H, W)) < 0.1] = -10.0
    gy = rng.uniform(-3.0, Hi + 2.0, (H, W)).astype(np.float32)
    gx, gy = torch.tensor(gx, device=dev), torch.tensor(gy, device=dev)
    got = warp_cuda.warp_to_pixels(chans, gx, gy)
    want = warp_cuda.warp_to_pixels_plain(chans, gx, gy)
    assert float((got - want).abs().max()) <= 1e-6


# (extra CLI flags, size, azimuth): the per-slab sweep (fewer slabs than
# voxel planes) with the single-pass warp, intensity-only and gradient TF.
@pytest.mark.parametrize("flags", [["--sampling", "0.5", "--gmax", "0"],
                                   ["--sampling", "0.25"]])
def test_slab_sweep_and_single_pass_warp_frame(dev, flags):
    """K7 against its plain version on a frame's own inputs (ERT on and
    off, sample counts on), and the K7 + K8 frame against the CPU engine."""
    from vkvolume_tpu_torch import cli
    from vkvolume_tpu_torch.render import sweep_slabs

    args = ["--synth", "beetle", "--synth-scale", "0.1", "--width", "384",
            "--height", "256"] + flags
    engines = []
    for device in ("cuda", "cpu"):
        eng, vols = cli.setup_engine(cli.build_parser().parse_args(
            args + ["--device", device]))
        eng.add_volume(vols[0])
        engines.append(eng)
    eng, cpu = engines
    cam = cli.cli_camera(384, 256)
    before = (sweep_slabs.LAUNCHES["sweep_slabs"],
              warp_cuda.LAUNCHES["warp_to_pixels"])
    got = eng.render(cam, 384, 256).color.cpu()
    assert sweep_slabs.LAUNCHES["sweep_slabs"] == before[0] + 1
    assert warp_cuda.LAUNCHES["warp_to_pixels"] == before[1] + 1
    want = cpu.render(cam, 384, 256).color
    assert float((want[..., 3] > 0).float().mean()) > 0.02
    assert float((got - want).abs().amax(-1).gt(2e-3).float().mean()) <= 1e-3

    f = frame_parts(eng, cam, 384, 256)
    u, p, plan = f["u"], f["p"], f["plan"]
    assert f["n_slabs"] < f["vol_t"].shape[0]
    wu, wv = sweep_frame.w_grid(f["gp"], plan["Hi"], plan["Wi"], dev)
    rays = sweep_frame.grid_rays(u, wu, wv, p, plan["sgn_p"])
    for ert in (True, False):
        inp = sweep_slabs.slab_inputs(
            f["vol_t"], f["occ_t"], f["tf"], rays, u, f["grad_t"], p_axis=p,
            ert=ert, count_samples=True, n_slabs=f["n_slabs"],
            dist_leap=True, separable=True)
        k = sweep_slabs.sweep_slabs_kernel(inp)
        r = sweep_slabs.sweep_slabs_plain(inp)
        assert torch.equal(k[3], r[3]) and torch.equal(k[2], r[2])
        assert int(k[3].sum()) > 0
        assert float((k[0] - r[0]).abs().max()) <= 1e-5
        assert float((k[1] - r[1]).abs().max()) <= 1e-5


def _brick_frame(key, skipmode, density, azimuth):
    """``frame_parts`` of a small beetle frame on the card."""
    eng, _, _, _ = make_engine(key, skipmode, 4, scale=0.1, test=TTest.NONE,
                               ert=True, device="cuda")
    eng.options.slab_density = density
    return frame_parts(eng, benchmark_camera(aspect=1.0, azimuth=azimuth),
                       256, 256)


@pytest.mark.parametrize("azimuth", [30.0, 210.0])
@pytest.mark.parametrize("key,skipmode,density", [
    ("beetle", 3, "auto"), ("beetle-grad", 2, "auto"),
    ("beetle-grad", 2, "axis"), ("beetle", 2, "ref")])
def test_brick_kernels_at_tile_h_32(dev, key, skipmode, density, azimuth):
    """Every K1 variant at tile_h 32 (the tile of the orbit's side poses),
    both sweep signs, ERT on and off: the walk kernel's lists are the plain
    walk's, and the compositing kernel over them gives the interleaved
    plain sweep bit for bit."""
    f = _brick_frame(key, skipmode, density, azimuth)
    u, p, plan, gp, vol_t, occ_t, tf, grad_t, n_slabs = (
        f[k] for k in ("u", "p", "plan", "gp", "vol_t", "occ_t", "tf",
                       "grad_t", "n_slabs"))
    wu, wv = sweep_frame.w_grid(gp, plan["Hi"] // 32 * 32, plan["Wi"], dev)
    sgn = 1 if plan["sgn_p"] > 0 else -1
    assert sgn == (-1 if azimuth == 30.0 else 1)
    s_lo, s_hi, cov, kappa = sweep_bricks.grid_fields(
        u, wu, wv, sgn, p, max(vol_t.shape), n_slabs)
    for ert in (True, False):
        inp = sweep_bricks.brick_inputs(
            vol_t, occ_t, tf, u, (wu, wv, s_lo, s_hi, kappa, cov), p_axis=p,
            ert=ert, count_samples=True, n_slabs=n_slabs, sgn=sgn, tile_h=32,
            dist_leap=True, grad_t=grad_t)
        before = dict(sweep_bricks.LAUNCHES)
        lists = sweep_bricks.brick_walk(inp)
        got = sweep_bricks.sweep_bricks_composite(inp, lists)
        assert sweep_bricks.LAUNCHES == {k: n + 1 for k, n in before.items()}
        want = sweep_bricks.brick_walk_plain(inp)
        assert torch.equal(lists.cnt, want.cnt)
        assert torch.equal(lists.entries(), want.entries())
        assert int(want.cnt.sum()) > 0
        for a, b in zip(got, sweep_bricks.sweep_bricks_reference(inp)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("flags", [["--sampling", "0.5", "--gmax", "0"],
                                   ["--sampling", "0.25"]])
def test_slab_walk_kernel(dev, flags):
    """K7's walk kernel against the plain walk on a small frame's rays
    (separable and per-cell v), and the compositing kernel over its lists
    against the interleaved plain sweep, bit for bit."""
    from vkvolume_tpu_torch import cli
    from vkvolume_tpu_torch.render import sweep_slabs

    eng, vols = cli.setup_engine(cli.build_parser().parse_args(
        ["--synth", "beetle", "--synth-scale", "0.1", "--width", "384",
         "--height", "256", "--device", "cuda"] + flags))
    eng.add_volume(vols[0])
    f = frame_parts(eng, cli.cli_camera(384, 256), 384, 256)
    u, p, plan = f["u"], f["p"], f["plan"]
    wu, wv = sweep_frame.w_grid(f["gp"], plan["Hi"], plan["Wi"], dev)
    rays = sweep_frame.grid_rays(u, wu, wv, p, plan["sgn_p"])
    for separable in (True, False):
        inp = sweep_slabs.slab_inputs(
            f["vol_t"], f["occ_t"], f["tf"], rays, u, f["grad_t"], p_axis=p,
            ert=True, count_samples=True, n_slabs=f["n_slabs"],
            dist_leap=True, separable=separable)
        lists = sweep_slabs.slab_walk(inp)
        want = sweep_slabs.slab_walk_plain(inp)
        assert torch.equal(lists.cnt, want.cnt)
        assert torch.equal(lists.entries(), want.entries())
        assert int(want.cnt.sum()) > 0
        got = sweep_slabs.sweep_slabs_composite(inp, lists)
        for a, b in zip(got, sweep_slabs.sweep_slabs_plain(inp)):
            assert torch.equal(a, b)
