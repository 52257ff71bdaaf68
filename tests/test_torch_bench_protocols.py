"""The port's measurement protocols (``vkvolume_tpu_torch.bench.parity``,
``.ess_ratio``, ``.orbit``, ``.session``) on the CPU at small scales,
against the JAX package where it has the same function (its harness, with
Pallas in interpret mode) and against the rules of the scripts they port
(``scripts/tpu_parity.py``, ``ess_ratio.py``, ``orbit_bench.py``,
``interactive_session.py``)."""

import functools
import json

import numpy as np
import pytest
import torch

from vkvolume_tpu.bench import harness as jh
from vkvolume_tpu.options import Test as JTest
from vkvolume_tpu.render import sweep_pallas
from vkvolume_tpu_torch.bench import ess_ratio, orbit, parity, session
from vkvolume_tpu_torch.bench import harness as th
from vkvolume_tpu_torch.bench.datasets import DATASETS, synthesize
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# The scripts' output keys: tpu_parity.py:164-183 (the image statistics
# of a row), ess_ratio.py:61-70 (a row), orbit_bench.py:51-68 (the line).
PARITY_KEYS = {"max_abs_diff", "mean_abs_diff", "pct_pixels_gt_8_of_255",
               "alpha_mean_ref", "alpha_mean_got", "covered_px"}
ESS_KEYS = {"frame_ms", "fps", "update_ms", "occupancy_pct", "rep_ms",
            "renderer_counts", "stages", "wall_s"}
ORBIT_KEYS = {"metric", "value", "unit", "vs_baseline", "fps",
              "map_update_ms", "occupancy_pct", "frames", "scale", "wall_s",
              "rep_ms", "rep_spread", "renderer_used", "renderer_counts",
              "orbit_deg_per_frame"}
SESSION_KEYS = {"dataset", "scale", "width", "height", "skipmode",
                "n_edits", "total_ms_median", "total_ms_max", "prewarm_s",
                "pipelined_ms_per_edit", "renderer_counts", "edits",
                "protocol", "extra_edits"}
# What the port adds to each: the card's name and power limit; the
# parity row's pixel counts and covered-pixel share; the session's load
# and first-frame seconds.
CARD_KEYS = {"device", "power_limit"}

# 256x144 (16:9 as the matrix's 1920x1080): the JAX engine routes a CPU
# frame whose width is not a multiple of 128 to the XLA sweep, so the
# comparisons use tile-aligned sizes.
W, H = 256, 144


@pytest.fixture
def jax_interpret(monkeypatch):
    monkeypatch.setattr(sweep_pallas, "_frame_jit", functools.partial(
        sweep_pallas._frame_jit, interpret=True))


def test_parity_row_matches_jax(jax_interpret):
    """(a) beetle-grad at scale 0.2, 256x144, skipmode 3: ``parity_row`` of
    the port's production and oracle frames against ``parity_row`` of the
    JAX package's, each built as the script builds it (``make_engine(...,
    benchmark_mode=False)``, one frame). Pixel counts within 1e-3 of the
    covered pixels; the mean and max differences and the alpha means
    within 1e-4 (the two packages' frames agree within ~1e-5 a pixel here:
    XLA's fused multiply-adds)."""
    key, sm, scale = "beetle-grad", 3, 0.2
    vol = synthesize(DATASETS[key], scale=scale)
    cam = jh.benchmark_camera(aspect=W / H)
    jax_frames = {}
    for renderer, skipmode in (("pallas", sm), ("marcher", 2)):
        eng = jh.make_engine(key, skipmode, 4, volume_u8=vol,
                             renderer=renderer, benchmark_mode=False)[0]
        jax_frames[renderer] = torch.from_numpy(
            np.array(eng.render(cam, W, H).color))
        assert eng.last_renderer == renderer
    got = parity.render_config("pallas", key, sm, W, H, scale, vol,
                               device="cpu", frames=0)
    ref = parity.render_config("marcher", key, parity.ORACLE_SKIPMODE, W, H,
                               scale, vol, device="cpu")
    assert (got.renderer, ref.renderer) == ("pallas", "marcher")
    assert got.frame_ms is None and got.repair_px is None
    mine = parity.parity_row(got.color, ref.color)
    want = parity.parity_row(jax_frames["pallas"], jax_frames["marcher"])
    assert PARITY_KEYS <= set(mine)
    assert want["px_gt_8_of_255"] > 0.01 * want["covered_px"]  # a real gap
    for k in ("covered_px", "covered_either_px", "px_gt_8_of_255"):
        assert abs(mine[k] - want[k]) <= 1e-3 * want["covered_px"], k
    for k in ("max_abs_diff", "mean_abs_diff", "alpha_mean_ref",
              "alpha_mean_got"):
        assert mine[k] == pytest.approx(want[k], abs=1e-4), k
    n_px = W * H
    assert mine["pct_pixels_gt_8_of_255"] == pytest.approx(
        100.0 * mine["px_gt_8_of_255"] / n_px)


@pytest.mark.parametrize("key", ["beetle", "beetle-grad"])
def test_default_frames_are_skipmode_invariant(key):
    """(b) Empty-space skipping never changes what is sampled: the port's
    production frames at skipmodes 0-3 are equal bit for bit."""
    vol = synthesize(DATASETS[key], scale=0.1)
    frames = [parity.render_config("pallas", key, sm, W, H, 0.1, vol,
                                   device="cpu", frames=0)
              for sm in (0, 1, 2, 3)]
    assert all(f.renderer == "pallas" for f in frames)
    assert (frames[0].color[..., 3] > 0).float().mean() > 0.05
    for f in frames[1:]:
        assert torch.equal(f.color, frames[0].color)


def test_the_two_shares_have_their_own_denominators():
    """(c) On a 10x10 pair: 20 pixels covered in the oracle, 5 more in the
    frame only, 3 of the 25 off by more than 8/255 (one of them only by
    8/255 in two channels: not counted). The image share divides by 100,
    the covered share by the 25 covered in either frame."""
    ref = torch.zeros(10, 10, 4)
    ref.view(-1, 4)[:20] = torch.tensor([0.2, 0.3, 0.4, 0.5])
    got = ref.clone()
    got.view(-1, 4)[20:25] = torch.tensor([0.01, 0.01, 0.01, 0.02])
    got.view(-1, 4)[0, 0] += 0.5                   # far
    got.view(-1, 4)[21, 3] += 0.1                  # far, frame-only pixel
    got.view(-1, 4)[5, 3] += 9.0 / 255.0           # far
    got.view(-1, 4)[6, 1:3] += 8.0 / 255.0         # at the threshold
    row = parity.parity_row(got, ref)
    assert row["px_gt_8_of_255"] == 3
    assert row["covered_px"] == 20 and row["covered_either_px"] == 25
    assert row["pct_pixels_gt_8_of_255"] == pytest.approx(3.0)
    assert row["pct_covered_gt_8_of_255"] == pytest.approx(12.0)
    empty = parity.parity_row(torch.zeros(4, 4, 4), torch.zeros(4, 4, 4))
    assert empty["pct_covered_gt_8_of_255"] == 0.0
    assert empty["covered_either_px"] == 0


def script_budget(n_probe, n_px):
    """scripts/tpu_parity.py:46-49, as written there."""
    for frac in (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1 / 2, 1.0):
        if 1.25 * n_probe <= max(2048, int(n_px * frac)):
            break
    return frac


@pytest.mark.parametrize("n_probe,n_px,want", [
    # 1920x1080: the budget of each fraction over 1.25 is its edge.
    (0, 2073600, 1 / 32), (51840, 2073600, 1 / 32),
    (51841, 2073600, 1 / 16), (103680, 2073600, 1 / 16),
    (103681, 2073600, 1 / 8), (207361, 2073600, 1 / 4),
    (414721, 2073600, 1 / 2), (829440, 2073600, 1 / 2),
    (829441, 2073600, 1.0), (2073600, 2073600, 1.0),
    # 256x144: the 2048-pixel floor holds 1/32 up to 1638.
    (1638, 36864, 1 / 32), (1639, 36864, 1 / 16), (1843, 36864, 1 / 16),
    (1844, 36864, 1 / 8)])
def test_repair_budget_fraction_follows_the_script(n_probe, n_px, want):
    """(d) The power-of-two bucket with 1.25 headroom at its edges."""
    assert parity.repair_budget_fraction(n_probe, n_px) == want
    assert script_budget(n_probe, n_px) == want


def test_repair_budget_fraction_equals_the_script_everywhere():
    for n_px in (36864, 2073600):
        for n in range(0, n_px + 1, 97):
            assert parity.repair_budget_fraction(n, n_px) == \
                script_budget(n, n_px)


def test_run_matrix_writes_every_column(tmp_path):
    """The matrix over beetle's four skipmodes with repair: the JAX
    record's row keys, every repair column computed (none reused), the
    invariance recorded for both columns, the rows' statistics those of
    ``parity_row`` on ``render_config``'s frames; and through ``main``."""
    out = tmp_path / "parity.json"
    configs = [f"beetle:{sm}" for sm in (0, 1, 2, 3)]
    logs = []
    res = parity.run_matrix(configs, width=W, height=H, scale=0.1,
                            frames=1, out=str(out), device="cpu",
                            log=logs.append)
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert res["device"] == "cpu" and res["power_limit"] is None
    assert res["skipmode_invariant"] == {
        "beetle": {"default": True, "edge_repair": True}}
    assert len(logs) == 4
    vol = synthesize(DATASETS["beetle"], scale=0.1)
    ref = parity.render_config("marcher", "beetle", 2, W, H, 0.1, vol,
                               device="cpu").color
    rep = parity.render_config("pallas", "beetle", 3, W, H, 0.1, vol,
                               edge_repair=True, device="cpu", frames=0)
    for cfg in configs:
        row = res[cfg]
        assert PARITY_KEYS | {"renderer_used", "image", "scale", "frame_ms",
                              "wall_s", "edge_repair"} <= set(row)
        assert row["renderer_used"] == "pallas" and row["image"] == "256x144"
        assert row["frame_ms"] > 0
        r = row["edge_repair"]
        assert "reused_from" not in r and r["frame_ms"] > 0
        assert (r["repaired_px"], r["budget_px"]) == rep.repair_px
        assert 0 < r["repaired_px"] <= r["budget_px"]
        want = parity.parity_row(rep.color, ref)
        assert {k: r[k] for k in want} == want
        assert r["pct_covered_gt_8_of_255"] < row["pct_covered_gt_8_of_255"]
    rows = [{k: v for k, v in res[c].items()
             if k not in ("frame_ms", "wall_s", "edge_repair")}
            for c in configs]
    assert all(r == rows[0] for r in rows)
    parity.main(["--configs", "beetle:1", "--width", str(W), "--height",
                 str(H), "--scale", "0.1", "--no-repair", "--frames", "0",
                 "--out", str(tmp_path / "p1.json"), "--device", "cpu"])
    one = json.loads((tmp_path / "p1.json").read_text())
    assert one["beetle:1"] == {**rows[0], "frame_ms": None,
                               "wall_s": one["beetle:1"]["wall_s"]}


def test_run_matrix_raises_when_skipmodes_differ(tmp_path, monkeypatch):
    """A frame that changes with the skipmode is recorded as such, the
    file written, and the matrix raises."""
    real = parity.render_config

    def skewed(renderer, dataset, skipmode, *a, **k):
        f = real(renderer, dataset, skipmode, *a, **k)
        if skipmode == 3 and renderer == "pallas":
            f.color = f.color.clone()
            f.color[0, 0, 0] += 1e-6
        return f

    monkeypatch.setattr(parity, "render_config", skewed)
    out = tmp_path / "parity.json"
    with pytest.raises(AssertionError, match="differ across skipmodes"):
        parity.run_matrix(["beetle:2", "beetle:3"], width=W, height=H,
                          scale=0.05, repair=False, frames=0, out=str(out),
                          device="cpu")
    assert json.loads(out.read_text())["skipmode_invariant"] == {
        "beetle": {"default": False}}


def test_ess_ratio_rows_match_jax_run_config(tmp_path, jax_interpret):
    """(e) Through ``main``: the script's row keys; per skipmode the
    renderer counts and occupancy of JAX's ``run_config`` at the same
    configuration (beetle, scale 0.05, 128x128, 1 frame a repetition),
    and the three stages."""
    out = tmp_path / "ess.json"
    ess_ratio.main(["--datasets", "beetle", "--skipmodes", "0,3",
                    "--frames", "1", "--scale", "0.05", "--width", "128",
                    "--height", "128", "--out", str(out), "--device",
                    "cpu"])
    res = json.loads(out.read_text())
    assert set(res) == CARD_KEYS | {"beetle:0", "beetle:3"}
    for sm in (0, 3):
        row = res[f"beetle:{sm}"]
        assert set(row) == ESS_KEYS
        assert set(row["stages"]) == {"plan_ms", "sweep_ms", "warp_ms"}
        assert len(row["rep_ms"]) == 5
        want = jh.run_config("beetle", sm, 4, width=128, height=128,
                             frames=1, scale=0.05)
        assert row["renderer_counts"] == want.renderer_counts
        assert row["occupancy_pct"] == want.occupancy


def test_orbit_line_matches_jax_run_config(tmp_path, jax_interpret,
                                           monkeypatch):
    """(e) The script's keys and the card's; the renderer counts and
    occupancy of JAX's orbit ``run_config`` at the same configuration
    (beetle skipmode 2, scale 0.05, 128x128, 1 frame a repetition, 2
    degrees a frame). The JAX side runs without ``freeze_orbit_statics``,
    the Mosaic workaround the port does not have: it pins every pose to
    an envelope plan, which changes the warp's tier
    (``pallas_xla_warp``)."""
    monkeypatch.setattr(jh, "freeze_orbit_statics", lambda *a, **k: None)
    out = tmp_path / "orbit.json"
    orbit.main(["--frames", "1", "--scale", "0.05", "--width", "128",
                "--height", "128", "--out", str(out), "--device", "cpu"])
    line = json.loads(out.read_text())
    assert set(line) == ORBIT_KEYS | CARD_KEYS
    assert line["orbit_deg_per_frame"] == 2.0 and line["frames"] == 1
    assert line["metric"] == ("ms/frame 128x128 beetle skipmode=2 ORBIT "
                              "2.0 deg/frame")
    assert line["vs_baseline"] == pytest.approx(
        1000.0 / (623.8 / (128 * 128 / 1200.0 ** 2)) / line["value"])
    want = jh.run_config("beetle", 2, 4, width=128, height=128, frames=1,
                         scale=0.05, test=JTest.NONE, ert=True,
                         renderer="pallas", orbit_deg=2.0)
    assert line["renderer_counts"] == want.renderer_counts
    assert line["occupancy_pct"] == want.occupancy


def test_session_dirty_tracking(tmp_path):
    """(f) After each slider edit the session's frame equals a fresh
    engine's first frame at that TF; each extra's ``equals_before`` is
    right: the undos and the ESS toggle give the frame back, the other
    edits change it."""
    frames = {}
    out = tmp_path / "interactive.json"
    res = session.run(scale=0.05, width=W, height=H, n_edits=4,
                      out=str(out), device="cpu",
                      on_frame=lambda label, f: frames.setdefault(
                          label, []).append(f.color.clone()),
                      log=lambda m: None)
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert set(res) == SESSION_KEYS | CARD_KEYS | {"load_s",
                                                   "first_frame_s"}
    assert res["prewarm_s"] is None and res["n_edits"] == 4
    imins = [e["imin"] for e in res["edits"]]
    base = DATASETS["beetle"].imin
    peak = base + 0.25 * 2 / 3          # the triangle over 4 edits
    assert imins == pytest.approx([base, peak, peak, base])
    vol = synthesize(DATASETS["beetle"], scale=0.05)
    for imin in sorted(set(imins)):
        eng = th.make_engine("beetle", 2, 4, volume_u8=vol,
                             benchmark_mode=False, device="cpu")[0]
        eng.volumes[0].options.intensity_min = imin
        eng.update_transfer_function(eng.volumes[0])
        fresh = eng.render(th.benchmark_camera(W / H), W, H).color
        for got in frames[f"imin={imin}"]:
            assert torch.equal(got, fresh), imin
    assert not torch.equal(frames[f"imin={imins[0]}"][0],
                           frames[f"imin={imins[1]}"][0])
    extras = {e["edit"]: e for e in res["extra_edits"]}
    assert list(extras) == ["sampling=1.5", "sampling=1.0", "translate+8x",
                            "translate-back", "spin15", "spin0",
                            "skipmode=3", "skipmode=2"]
    for name, e in extras.items():
        changes = name in ("sampling=1.5", "translate+8x", "spin15")
        assert e["equals_before"] is not changes, name
        assert e["renderer"] == "pallas"
    assert torch.equal(frames["start"][0], frames["first"][0])
    assert sum(res["renderer_counts"].get(k, 0)
               for k in ("pallas", "sweep", "marcher")) == 1 + 4 + 4 + 1 + 8


def test_session_main_writes_the_core_result(tmp_path, capsys):
    out = tmp_path / "s.json"
    session.main(["--scale", "0.05", "--width", str(W), "--height", str(H),
                  "--edits", "2", "--no-extras", "--out", str(out),
                  "--device", "cpu"])
    res = json.loads(out.read_text())
    assert "extra_edits" not in res and len(res["edits"]) == 2
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"total_ms_median", "total_ms_max",
                         "renderer_counts"}


@pytest.mark.parametrize("module", [parity, ess_ratio, orbit, session],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_protocols_refuse_without_a_card(module, tmp_path):
    """Each protocol runs on the card by default and raises without one,
    before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "never.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--out", str(out)])
    assert not out.exists()
