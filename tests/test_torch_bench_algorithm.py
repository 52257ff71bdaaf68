"""The port's protocols of the algorithm's work and error
(``vkvolume_tpu_torch.bench.sample_count`` and ``.warp_vs_quadrature``,
ports of ``scripts/sample_count_ab.py`` and ``warp_vs_quadrature.py``)
on the CPU at 256x144, against the JAX package's frames built as the
scripts build them (its harness, Pallas in interpret mode), with the
scripts' statistics computed here from those frames."""

import functools
import json

import numpy as np
import pytest

from vkvolume_tpu.bench import harness as jh
from vkvolume_tpu.options import Test as JTest
from vkvolume_tpu.render import sweep_pallas
from vkvolume_tpu_torch.bench import parity, sample_count
from vkvolume_tpu_torch.bench import warp_vs_quadrature as wq
from vkvolume_tpu_torch.bench.datasets import DATASETS, synthesize
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# 256x144 (16:9 as the protocols' 1920x1080): the JAX engine routes a CPU
# frame whose width is not a multiple of 128 to the XLA sweep.
W, H = 256, 144
CARD_KEYS = {"device", "power_limit"}
# The scripts' keys: sample_count_ab.py:62-71 (a renderer), :78-83 (the
# ratio), :87-88 (the config); warp_vs_quadrature.py:66-72, :74-76.
COUNT_KEYS = {"renderer_used", "mean_per_covered", "p50", "p90", "p99",
              "total_msamples", "covered_px", "wall_s"}
RATIO_KEYS = {"total", "p50", "p90", "p99"}
WQ_KEYS = {"renderer_used", "pct_all", "pct_covered", "max_abs", "mean_abs",
           "alpha_mean_got"}
WQ_CONFIG_KEYS = {"dataset", "skipmode", "scale", "image", "alpha_mean_ref"}


@pytest.fixture
def jax_interpret(monkeypatch):
    monkeypatch.setattr(sweep_pallas, "_frame_jit", functools.partial(
        sweep_pallas._frame_jit, interpret=True))


def script_counts(eng, width, height):
    """``scripts/sample_count_ab.py:44-61`` on a JAX engine: (counts,
    covered)."""
    eng.options.early_ray_termination = False
    col = np.asarray(eng.render(jh.benchmark_camera(aspect=width / height),
                                width, height).color)
    d = eng.volumes[0].density.shape
    sf = eng.volumes[0].options.sampling_factor
    n_steps_max = float(np.floor(np.ceil(max(d) * np.sqrt(3.0)) * sf))
    return col[..., 0] * n_steps_max, col[..., 3] > 0


@pytest.mark.parametrize("skipmode", [2, 3])
def test_sample_count_matches_jax(skipmode, tmp_path, jax_interpret):
    """The port's ``sample_count`` row against the script's statistics of
    the JAX frames (beetle, scale 0.2, 256x144). Tolerances:

    * the w-grid frame (``pallas``): both packages' brick sweeps count
      the same samples per grid cell and pass them through the same u16
      two-pass warp, whose plain version rounds as JAX's does, so each
      statistic is held within 1e-4 relative (float32 rounding only);
    * the marcher: XLA's CPU compiler fuses multiply-adds in the JAX
      march, which flips a few rays' events by one step and a ray's
      coverage at the silhouette (``ROADMAP.md`` §C): ``covered_px``
      within 1e-3 of itself, the mean and the total within 1e-3
      relative, each percentile within one sample;
    * the ratio: its total within 1e-3 relative, its percentiles within
      1e-2 relative (p99 is the tail of a few hundred pixels, which the
      flips move most).
    """
    key, scale = "beetle", 0.2
    out = tmp_path / "sample_count.json"
    res = sample_count.run([f"{key}:{skipmode}"], width=W, height=H,
                           scale=scale, out=str(out), device="cpu",
                           log=lambda m: None)
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert set(res) == CARD_KEYS | {f"{key}:{skipmode}"}
    assert res["device"] == "cpu" and res["power_limit"] is None
    row = res[f"{key}:{skipmode}"]
    assert set(row) == {"pallas", "marcher", "ratio", "config"}
    assert row["config"] == dict(dataset=key, skipmode=skipmode, scale=scale,
                                 image=f"{W}x{H}", ert=False)
    assert set(row["ratio"]) == RATIO_KEYS

    vol = synthesize(DATASETS[key], scale=scale)
    counts = {}
    for renderer in sample_count.RENDERERS:
        eng = jh.make_engine(key, skipmode, 4, volume_u8=vol,
                             renderer=renderer, benchmark_mode=False,
                             test=JTest.NUM_TEXTURE_SAMPLES)[0]
        c, covered = script_counts(eng, W, H)
        assert eng.last_renderer == renderer
        got = row[renderer]
        assert set(got) == COUNT_KEYS and got["renderer_used"] == renderer
        want = sample_count.count_stats(c, covered)
        assert want["covered_px"] > 0.1 * W * H
        assert abs(got["covered_px"] - want["covered_px"]) <= \
            1e-3 * want["covered_px"]
        for k in ("mean_per_covered", "total_msamples", "p50", "p90", "p99"):
            if renderer == "pallas":
                assert got[k] == pytest.approx(want[k], rel=1e-4), k
            elif k.startswith("p"):
                assert abs(got[k] - want[k]) <= 1.0, k
            else:
                assert got[k] == pytest.approx(want[k], rel=1e-3), k
        counts[renderer] = c
    p, m = counts["pallas"], counts["marcher"]
    both = (p > 0) & (m > 0)
    ratio = p[both] / np.maximum(m[both], 1.0)
    want = dict(total=float(p.sum() / max(m.sum(), 1.0)),
                p50=float(np.percentile(ratio, 50)),
                p90=float(np.percentile(ratio, 90)),
                p99=float(np.percentile(ratio, 99)))
    # The sweep samples slabs a per-ray march leaps over.
    assert want["total"] > 1.0
    assert row["ratio"]["total"] == pytest.approx(want["total"], rel=1e-3)
    for k in ("p50", "p90", "p99"):
        assert row["ratio"][k] == pytest.approx(want[k], rel=1e-2), k


@pytest.fixture(scope="module")
def wq_run(tmp_path_factory):
    """``warp_vs_quadrature.run`` on present-grad at scale 0.2, 256x144,
    with the frames it rendered, and the JAX package's frames of the same
    renderers (Pallas in interpret mode)."""
    key, scale = "present-grad", 0.2
    out = tmp_path_factory.mktemp("wq") / "wq.json"
    frames = {}
    real = parity.render_config

    def recording(renderer, *a, **k):
        f = real(renderer, *a, **k)
        frames[renderer] = f.color
        return f

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(parity, "render_config", recording)
        res = wq.run([f"{key}:2"], width=W, height=H, scale=scale,
                     parity_record=str(out) + ".none", out=str(out),
                     device="cpu", log=lambda m: None)
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    vol = synthesize(DATASETS[key], scale=scale)
    jax_frames = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sweep_pallas, "_frame_jit", functools.partial(
            sweep_pallas._frame_jit, interpret=True))
        for renderer in ("marcher",) + wq.RENDERERS:
            eng = jh.make_engine(key, 2, 4, volume_u8=vol,
                                 renderer=renderer, benchmark_mode=False)[0]
            jax_frames[renderer] = np.array(eng.render(
                jh.benchmark_camera(aspect=W / H), W, H).color)
            assert eng.last_renderer == renderer
    return res, res[f"{key}:2"], frames, jax_frames


def test_warp_vs_quadrature_matches_jax(wq_run):
    """Each column against the script's statistics of the JAX frames
    (``scripts/warp_vs_quadrature.py:58-72``): ``pct_all`` and
    ``pct_covered`` within 1e-3 of the pixels (0.1 points), ``mean_abs``,
    ``max_abs``, ``alpha_mean_got`` and the oracle's alpha mean within
    1e-4 (the packages' frames agree within ~1e-5 a pixel here: XLA's
    fused multiply-adds)."""
    res, row, _, jax_frames = wq_run
    assert set(res) == CARD_KEYS | {"present-grad:2"}
    assert res["device"] == "cpu" and res["power_limit"] is None
    assert set(row) == set(wq.RENDERERS) | {"config",
                                            "matches_parity_record"}
    assert WQ_CONFIG_KEYS <= set(row["config"])
    assert row["config"]["image"] == f"{W}x{H}"
    assert row["matches_parity_record"] is None
    ref = jax_frames["marcher"]
    cov = ref[..., 3] > 1e-6
    assert row["config"]["alpha_mean_ref"] == pytest.approx(
        float(ref[..., 3].mean()), abs=1e-4)
    for renderer in wq.RENDERERS:
        col = row[renderer]
        assert WQ_KEYS | {"parity", "wall_s"} <= set(col)
        assert col["renderer_used"] == renderer
        got = jax_frames[renderer]
        d = np.abs(got - ref)
        bad = d.max(-1) > 8.0 / 255.0
        want = dict(pct_all=100.0 * float(bad.mean()),
                    pct_covered=100.0 * float(bad[cov].mean()),
                    max_abs=float(d.max()), mean_abs=float(d.mean()),
                    alpha_mean_got=float(got[..., 3].mean()))
        assert want["pct_all"] > 0.0
        for k in ("pct_all", "pct_covered"):
            assert col[k] == pytest.approx(want[k], abs=0.1), k
        for k in ("max_abs", "mean_abs", "alpha_mean_got"):
            assert col[k] == pytest.approx(want[k], abs=1e-4), k
    # Here the gap is the warp's: the XLA sweep, the same quadrature
    # without grid and warp, is off far less than the w-grid frame.
    assert row["sweep"]["pct_covered"] < 0.25 * row["pallas"]["pct_covered"]


def test_warp_vs_quadrature_pallas_column_is_parity_row(wq_run):
    """The ``parity`` block of each column is ``parity.parity_row`` of the
    frames the run rendered, and the script's shares agree with it."""
    _, row, frames, _ = wq_run
    for renderer in wq.RENDERERS:
        col = row[renderer]
        assert col["parity"] == parity.parity_row(frames[renderer],
                                                  frames["marcher"])
        assert col["pct_all"] == pytest.approx(
            col["parity"]["pct_pixels_gt_8_of_255"])


def test_warp_vs_quadrature_holds_the_parity_record(tmp_path, capsys):
    """``matches_parity_record``: None without a row at this image size
    and scale, true when the record's ``px_gt_8_of_255`` equals the
    pallas column's, false (and ``main`` exits 1 after writing the file)
    when the record's count is changed."""
    record, out = tmp_path / "parity.json", tmp_path / "wq.json"
    args = ["--configs", "beetle:2", "--renderers", "pallas", "--scale",
            "0.1", "--width", str(W), "--height", str(H), "--parity-record",
            str(record), "--out", str(out), "--device", "cpu"]
    record.write_text(json.dumps({"beetle:2": {
        "image": "1920x1080", "scale": 0.1, "px_gt_8_of_255": 0}}))
    assert wq.main(args) == 0
    row = json.loads(out.read_text())["beetle:2"]
    assert row["matches_parity_record"] is None
    n = row["pallas"]["parity"]["px_gt_8_of_255"]
    assert n > 0
    for px, matches, rc in ((n, True, 0), (n + 1, False, 1)):
        out.unlink()
        record.write_text(json.dumps({"beetle:2": {
            "image": f"{W}x{H}", "scale": 0.1, "px_gt_8_of_255": px}}))
        assert wq.main(args) == rc
        assert json.loads(out.read_text())["beetle:2"][
            "matches_parity_record"] is matches
    assert "differs from" in capsys.readouterr().err


@pytest.mark.parametrize("module,renderer", [(sample_count, "pallas"),
                                             (wq, "sweep")],
                         ids=["sample_count", "warp_vs_quadrature"])
def test_protocols_raise_when_a_frame_takes_another_renderer(
        module, renderer, tmp_path, monkeypatch):
    """A frame that did not take the renderer asked for is recorded as
    such, the file written, and the run raises."""
    real = parity.render_config
    real_count = sample_count.count_frame

    def routed(r, *a, **k):
        f = real(r, *a, **k)
        if r == renderer:
            f.renderer = "marcher"
        return f

    def routed_count(r, *a, **k):
        c, covered, used, s = real_count(r, *a, **k)
        return c, covered, "marcher" if r == renderer else used, s

    monkeypatch.setattr(parity, "render_config", routed)
    monkeypatch.setattr(sample_count, "count_frame", routed_count)
    out = tmp_path / "out.json"
    with pytest.raises(AssertionError, match=f"'{renderer}': 'marcher'"):
        module.run(["beetle:2"], width=W, height=H, scale=0.05,
                   out=str(out), device="cpu", log=lambda m: None)
    assert json.loads(out.read_text())["beetle:2"][renderer][
        "renderer_used"] == "marcher"
