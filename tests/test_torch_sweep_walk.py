"""The two sweeps split as their kernels run them: a walk that lists each
tile's visited bricks (K1) or slabs (K7), then a composite over the lists.
On CPU tensors, the plain walk and the plain composite against the plain
sweep that interleaves them as the TPU kernel does (``sweep_bricks_
reference``, ``sweep_slabs_plain``, held against the JAX kernels in
``test_torch_sweep_bricks.py`` / ``test_torch_sweep_slabs.py``): the same
lum, alpha, first-hit planes and sample counts, bit for bit. Inputs: the
port's own frames of the synthetic beetle at scale 0.1, cut to a window of
the plan's w-grid."""

import numpy as np
import pytest
import torch

from vkvolume_tpu_torch import cli
from vkvolume_tpu_torch.bench.harness import benchmark_camera, make_engine
from vkvolume_tpu_torch.options import Test
from vkvolume_tpu_torch.render import sweep_bricks, sweep_frame, sweep_slabs
from torch_sweep_frames import frame_parts
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROWS = slice(128, 192)      # a 64 x 256 window of the plan's w-grid
COLS = slice(128, 384)


def _frame(eng, cam, w, h):
    """``frame_parts`` of the engine's frame, with its w-grid ``wu``, ``wv``
    cut to the window."""
    f = frame_parts(eng, cam, w, h)
    wu, wv = sweep_frame.w_grid(f["gp"], f["plan"]["Hi"], f["plan"]["Wi"],
                                "cpu")
    return dict(f, wu=wu[ROWS, COLS].contiguous(),
                wv=wv[ROWS, COLS].contiguous())


# K1's four variants: (dataset, skipmode, slab density) -> (aligned,
# gradient TF): bench.py's aligned intensity frame, the CLI's gradient +
# plane-pair lerp, the gradient TF aligned, the lerp with intensity only.
K1_VARIANTS = {"aligned": ("beetle", 3, "auto"),
               "gradient lerp": ("beetle-grad", 2, "auto"),
               "gradient aligned": ("beetle-grad", 2, "axis"),
               "lerp": ("beetle", 2, "ref")}


@pytest.fixture(scope="module")
def brick_frames():
    """Per K1 variant, the frames at azimuths 30 (sweep sign -1) and 210
    (+1)."""
    out = {}
    for name, (key, skipmode, density) in K1_VARIANTS.items():
        eng, _, _, _ = make_engine(key, skipmode, 4, scale=0.1,
                                   test=Test.NONE, ert=True, device="cpu")
        eng.options.slab_density = density
        out[name] = {az: _frame(eng, benchmark_camera(aspect=1.0,
                                                      azimuth=az), 256, 256)
                     for az in (30.0, 210.0)}
    return out


def _brick_inputs(f, tile_h, ert, count):
    sgn = 1 if f["plan"]["sgn_p"] > 0 else -1
    s_lo, s_hi, cov, kappa = sweep_bricks.grid_fields(
        f["u"], f["wu"], f["wv"], sgn, f["p"], max(f["vol_t"].shape),
        f["n_slabs"])
    return sweep_bricks.brick_inputs(
        f["vol_t"], f["occ_t"], f["tf"], f["u"],
        (f["wu"], f["wv"], s_lo, s_hi, kappa, cov), p_axis=f["p"], ert=ert,
        count_samples=count, n_slabs=f["n_slabs"], sgn=sgn, tile_h=tile_h,
        dist_leap=True, grad_t=f["grad_t"])


def _check_lists(lists, any_cov, sgn, cap):
    """Every tile's list: in sweep order without repeats, inside [0, cap),
    empty where the tile covers no ray."""
    cnt = lists.cnt.to(torch.int64)
    assert lists.lst.shape == (cnt.numel(), cap)
    assert bool((cnt[~any_cov] == 0).all())
    assert bool((cnt <= cap).all())
    for t in range(cnt.numel()):
        row = lists.lst[t, :cnt[t]].to(torch.int64)
        assert bool(((row >= 0) & (row < cap)).all())
        assert bool((sgn * torch.diff(row) > 0).all())


# (ERT, sample counting) run on both sweep signs in each case.
MODES = [(True, True), (False, True), (True, False)]


@pytest.mark.parametrize("tile_h", sweep_bricks.TILE_HS)
@pytest.mark.parametrize("variant", list(K1_VARIANTS))
def test_brick_walk_and_composite_match_interleaved_sweep(brick_frames,
                                                          variant, tile_h):
    aligned_want = variant in ("aligned", "gradient aligned")
    visited = 0
    for az, f in brick_frames[variant].items():
        for ert, count in MODES:
            inp = _brick_inputs(f, tile_h, ert, count)
            p = inp.params
            assert bool(p["aligned"]) == aligned_want
            assert bool(p["use_gradient"]) == variant.startswith("gradient")
            assert p["sgn"] == (-1 if az == 30.0 else 1)
            lists = sweep_bricks.brick_walk_plain(inp)
            got = sweep_bricks.sweep_bricks_composite_plain(inp, lists)
            want = sweep_bricks.sweep_bricks_reference(inp)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            assert float(want[1].max()) > 0.3              # real content
            assert (int(want[3].sum()) > 0) == count
            tiles = (inp.cov.reshape(p["H"] // tile_h, tile_h, -1, 128)
                     .any(dim=3).any(dim=1).reshape(-1))
            _check_lists(lists, tiles, p["sgn"], -(-p["n_slabs"] // 8))
            visited += int(lists.cnt.sum())
    assert visited > 0


@pytest.fixture(scope="module")
def slab_frames():
    """The CLI's frames that plan the per-slab sweep (fewer slabs than voxel
    planes): intensity TF (``--gmax 0``) and gradient TF, at azimuths 30
    (sweep sign -1) and 210 (+1)."""
    out = {}
    for tf, flags in (("intensity", ["--sampling", "0.5", "--gmax", "0"]),
                      ("gradient", ["--sampling", "0.25"])):
        eng, vols = cli.setup_engine(cli.build_parser().parse_args(
            ["--synth", "beetle", "--synth-scale", "0.1", "--device", "cpu"]
            + flags))
        eng.add_volume(vols[0])
        out[tf] = {az: _frame(eng, cli.cli_camera(384, 256, az), 384, 256)
                   for az in (30.0, 210.0)}
    return out


@pytest.mark.parametrize("separable", [True, False])
@pytest.mark.parametrize("tf", ["intensity", "gradient"])
def test_slab_walk_and_composite_match_interleaved_sweep(slab_frames, tf,
                                                         separable):
    visited = 0
    for az, f in slab_frames[tf].items():
        rays = sweep_frame.grid_rays(f["u"], f["wu"], f["wv"], f["p"],
                                     f["plan"]["sgn_p"])
        assert f["n_slabs"] < f["vol_t"].shape[0]
        for ert, count in MODES:
            inp = sweep_slabs.slab_inputs(
                f["vol_t"], f["occ_t"], f["tf"], rays, f["u"], f["grad_t"],
                p_axis=f["p"], ert=ert, count_samples=count,
                n_slabs=f["n_slabs"], dist_leap=True, separable=separable)
            sgn = int(inp.meta[2])
            assert sgn == (-1 if az == 30.0 else 1)
            assert bool(inp.params["use_gradient"]) == (tf == "gradient")
            lists = sweep_slabs.slab_walk_plain(inp)
            got = sweep_slabs.sweep_slabs_composite_plain(inp, lists)
            want = sweep_slabs.sweep_slabs_plain(inp)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            assert float(want[1].max()) > 0.3              # real content
            assert (int(want[3].sum()) > 0) == count
            tiles = (inp.cov.reshape(-1, 8, inp.cov.shape[1] // 128, 128)
                     .any(dim=3).any(dim=1).reshape(-1))
            _check_lists(lists, tiles, sgn, f["n_slabs"])
            visited += int(lists.cnt.sum())
    assert visited > 0


def _walk_stats(inp):
    """A walk's ``stats`` with sector maps of its coarse maps."""
    stats = {"windows": 0, "words": 0,
             "coarse": sweep_bricks.sector_map(inp.coarse)}
    if hasattr(inp, "cskip"):
        stats["cskip"] = sweep_bricks.sector_map(inp.cskip)
    return stats


def _slab_inputs(f, separable=True, ert=True, count=True):
    rays = sweep_frame.grid_rays(f["u"], f["wu"], f["wv"], f["p"],
                                 f["plan"]["sgn_p"])
    return sweep_slabs.slab_inputs(
        f["vol_t"], f["occ_t"], f["tf"], rays, f["u"], f["grad_t"],
        p_axis=f["p"], ert=ert, count_samples=count, n_slabs=f["n_slabs"],
        dist_leap=True, separable=separable)


def test_walks_count_the_windows_they_reduce(brick_frames, slab_frames):
    """``stats`` (the walk kernels' bound): a K1 walk reduces one tight
    window per step and a coarse one per leap, so at least one window per
    listed brick; a K7 walk one per step, at least one per listed slab.
    Each window reads at most its 16-row view's 32 words a row, held in
    that many map sectors; the sectors marked are the same whoever asks,
    and a walk without sector maps counts the same windows and words."""
    for inp in (_brick_inputs(brick_frames["gradient lerp"][30.0], 16, True,
                              True),
                _slab_inputs(slab_frames["gradient"][210.0])):
        walk = (sweep_bricks.brick_walk_plain if hasattr(inp, "cskip")
                else sweep_slabs.slab_walk_plain)
        stats = _walk_stats(inp)
        lists = walk(inp, stats)
        assert stats["windows"] >= int(lists.cnt.sum()) > 0
        assert 0 < stats["words"] <= 16 * 32 * stats["windows"]
        maps = [k for k in ("coarse", "cskip") if k in stats]
        sectors = sum(int(stats[k].sum()) for k in maps)
        assert 0 < sectors < sum(stats[k].numel() for k in maps)
        assert sectors <= stats["words"]
        plain = {"windows": 0}
        walk(inp, plain)
        assert plain == {"windows": stats["windows"],
                         "words": stats["words"]}
        again = _walk_stats(inp)
        walk(inp, again)
        for k in maps:
            assert torch.equal(again[k], stats[k])


# (frames, case) of each sweep variant for the sample counts below.
PASSED_CASES = [("brick", v) for v in K1_VARIANTS] + [
    ("slab", "intensity"), ("slab", "gradient")]


@pytest.mark.parametrize("sweep,case", PASSED_CASES)
def test_reads_count_the_samples_each_step_takes(brick_frames, slab_frames,
                                                 sweep, case):
    """``reads["passed"]`` (the operations side of the sweeps' bound): of
    the samples in range, those past the intensity TF and those that
    composite. Nested: composited <= past the intensity TF <= in range,
    the first two equal without a gradient TF; every pixel with alpha above 0
    composited at least once; ERT takes no more than the full sweep; the
    counts leave the result unchanged."""
    counts = {}
    for ert in (False, True):
        if sweep == "brick":
            inp = _brick_inputs(brick_frames[case][30.0], 16, ert, True)
            plain = sweep_bricks.sweep_bricks_reference
        else:
            inp = _slab_inputs(slab_frames[case][30.0], ert=ert)
            plain = sweep_slabs.sweep_slabs_plain
        reads = {"vol": sweep_bricks.sector_map(inp.vol),
                 "grad": (None if inp.grad is None
                          else sweep_bricks.sector_map(inp.grad)),
                 "passed": torch.zeros(2, dtype=torch.int64)}
        got = plain(inp, reads)
        for a, b in zip(got, plain(inp)):
            assert torch.equal(a, b)
        past, composited = reads["passed"].tolist()
        in_range = int(got[3].sum())
        assert in_range >= past >= composited >= int((got[1] > 0).sum()) > 0
        if not inp.params["use_gradient"]:
            assert past == composited
        counts[ert] = (in_range, past, composited)
    assert all(a <= b for a, b in zip(counts[True], counts[False]))


def test_capture_returns_the_sweep_a_frame_runs():
    """``harness.capture`` hands back the inputs of the frame's sweep and
    restores the sweep wrappers; the captured inputs give the frame's
    grid."""
    from vkvolume_tpu_torch.bench.harness import capture

    eng, _, _, _ = make_engine("beetle", 3, 4, scale=0.1, test=Test.NONE,
                               ert=True, device="cpu")
    saved = (sweep_bricks.sweep_bricks_kernel, sweep_slabs.sweep_slabs_kernel)
    name, inp = capture(eng, benchmark_camera(aspect=1.0), 256, 256)
    assert (sweep_bricks.sweep_bricks_kernel,
            sweep_slabs.sweep_slabs_kernel) == saved
    assert name == "K1" and isinstance(inp, sweep_bricks.BrickInputs)
    plan = frame_parts(eng, benchmark_camera(aspect=1.0), 256, 256)["plan"]
    assert (inp.params["H"], inp.params["W"]) == (plan["Hi"], plan["Wi"])
    assert inp.params["tile_h"] == plan["tile_h"]


def test_wrappers_run_the_plain_split_for_cpu_tensors(brick_frames):
    """On CPU tensors the walk and composite wrappers run their plain
    versions and launch nothing; lists compare by their defined entries."""
    inp = _brick_inputs(brick_frames["lerp"][210.0], 8, True, True)
    before = dict(sweep_bricks.LAUNCHES)
    lists = sweep_bricks.brick_walk(inp)
    got = sweep_bricks.sweep_bricks_composite(inp, lists)
    assert sweep_bricks.LAUNCHES == before
    want = sweep_bricks.brick_walk_plain(inp)
    assert torch.equal(lists.cnt, want.cnt)
    assert torch.equal(lists.entries(), want.entries())
    assert lists.entries().numel() == int(want.cnt.sum())
    for a, b in zip(got, sweep_bricks.sweep_bricks_kernel(inp)):
        assert torch.equal(a, b)
    assert np.array_equal(lists.entries().numpy(),
                          np.concatenate([want.lst[t, :c].numpy() for t, c in
                                          enumerate(want.cnt.tolist())]))
