"""The port's benchmark harness (``vkvolume_tpu_torch.bench``: CSV schema,
``make_engine``, ``run_config``, ``stage_breakdown``, ``run_sweep`` and
the ``python -m vkvolume_tpu_torch.bench`` entry) against the JAX
package's harness on the CPU, at small scales (plain PyTorch versions of
the kernels)."""

import csv
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vkvolume_tpu.bench import harness as jh
from vkvolume_tpu.bench.datasets import DATASETS as JDATASETS
from vkvolume_tpu_torch.bench import harness as th
from vkvolume_tpu_torch.bench.datasets import DATASETS, synthesize
from vkvolume_tpu_torch.options import Test as TTest
from vkvolume_tpu_torch.render import sweep_frame
from vkvolume_tpu_torch.utils import timing
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KEYS = ("present", "present-grad", "beetle", "beetle-grad", "snake",
        "snake-grad")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_csv_columns_match_jax():
    assert th.CSV_COLUMNS == jh.CSV_COLUMNS


@pytest.mark.parametrize("fields", [
    ("beetle", 3, 4, 3.9712345678, 123.456789, 1.23456789, 0.086, 1.0, 0.0,
     0.0),
    ("snake", 0, 2, 0.6666666666, 75.305, 0.00004999, 0.04, 1.0, 0.1, 0.3)])
def test_bench_result_row_matches_jax(fields):
    assert th.BenchResult(*fields).row() == jh.BenchResult(*fields).row()


@pytest.mark.parametrize("key", KEYS)
def test_make_engine_occupancy_matches_jax(key):
    """Occupied voxel % of every dataset/TF configuration, exact."""
    _, jstats, vol, _ = jh.make_engine(key, 1, 4, scale=0.05)
    _, tstats, _, _ = th.make_engine(key, 1, 4, volume_u8=vol, device="cpu")
    assert tstats.occupied_voxel_percent == jstats.occupied_voxel_percent
    assert dataclasses.astuple(DATASETS[key]) == \
        dataclasses.astuple(JDATASETS[key])


@pytest.mark.parametrize("skipmode", [1, 2, 3])
@pytest.mark.parametrize("blocksize", [2, 3, 5, 6])
def test_maps_match_jax_at_block_sizes(skipmode, blocksize):
    """The occupancy / distance maps of block sizes that do not divide
    every extent (83/2, 83/3, 49/5, 83/6), bit-exact."""
    vol = synthesize(DATASETS["beetle-grad"], scale=0.1)
    jeng, _, _, _ = jh.make_engine("beetle-grad", skipmode, blocksize,
                                   volume_u8=vol, benchmark_mode=False)
    teng, _, _, _ = th.make_engine("beetle-grad", skipmode, blocksize,
                                   volume_u8=vol, benchmark_mode=False,
                                   device="cpu")
    jv, tv = jeng.volumes[0], teng.volumes[0]
    assert tv.map_shape_zyx == tuple(jv.map_shape_zyx)
    np.testing.assert_array_equal(tv.effective_block_size_xyz,
                                  np.asarray(jv.effective_block_size_xyz))
    want = np.asarray(jv.dist_maps)
    assert want.shape[0] == (8 if skipmode == 3 else 1)
    np.testing.assert_array_equal(tv.dist_maps.numpy(), want)


@pytest.mark.parametrize("fit", ["aspect", "stretch"])
def test_make_engine_fit_matches_jax(monkeypatch, fit):
    """The fit choice: the port's parameter against the JAX package's
    ``VKV_BENCH_FIT``."""
    monkeypatch.setenv("VKV_BENCH_FIT", fit)
    jeng, _, vol, _ = jh.make_engine("snake", 1, 4, scale=0.05,
                                     benchmark_mode=False)
    teng, _, _, _ = th.make_engine("snake", 1, 4, volume_u8=vol, fit=fit,
                                   benchmark_mode=False, device="cpu")
    np.testing.assert_array_equal(teng.volumes[0].model_matrix,
                                  np.asarray(jeng.volumes[0].model_matrix))


def test_make_engine_refuses_an_unknown_fit():
    with pytest.raises(ValueError, match="fit"):
        th.make_engine("beetle", 1, 4, scale=0.05, fit="cover", device="cpu")


@pytest.fixture(scope="module")
def engine():
    eng, _, _, _ = th.make_engine("beetle", 3, 4, scale=0.05,
                                  test=TTest.NONE, ert=True, device="cpu")
    return eng


def test_stage_breakdown_reproduces_the_frame(engine):
    """The captured sweep and pixel stage are the frame's, exactly; the
    breakdown has its three stages."""
    cam = th.benchmark_camera(1.0)
    out = engine.render(cam, 256, 256)
    assert engine.last_renderer == "pallas"
    (a, k), (pa, pk) = th.capture_stages(engine, cam, 256, 256)
    chans, rays, iterations = sweep_frame._frame_body(*a, **k,
                                                      return_chans=True)
    assert torch.equal(chans, pa[0])
    frame = sweep_frame._pixel_stage(chans, rays, *pa[2:], **pk)
    assert torch.equal(frame.color, out.color)
    assert torch.equal(frame.depth, out.depth)
    stages = th.stage_breakdown(engine, cam, 256, 256, reps=1, inner=1)
    assert set(stages) == {"plan_ms", "sweep_ms", "warp_ms"}
    assert all(v > 0 for v in stages.values())


def test_stage_breakdown_is_none_without_a_w_grid_frame(engine):
    engine.renderer = "sweep"
    try:
        assert th.stage_breakdown(engine, th.benchmark_camera(1.0), 128,
                                  128) is None
        assert engine.last_renderer == "sweep"
    finally:
        engine.renderer = "pallas"


@pytest.mark.parametrize("orbit_deg", [0.0, 5.0])
def test_run_config_protocol(orbit_deg):
    """reps x frames timed frames after one warm frame (and, in the orbit,
    one render of each timed pose); the orbit's timed poses each pay
    their host plan."""
    r = th.run_config("beetle", 2, 4, width=128, height=128, frames=2,
                      reps=2, scale=0.05, orbit_deg=orbit_deg,
                      keep_engine=True, device="cpu")
    assert len(r.rep_ms) == len(r.rep_host_ms) == 2
    assert r.rep_ms == r.rep_host_ms          # the host clock on the CPU
    assert r.frame_ms == float(np.median(r.rep_ms))
    assert r.framerate == pytest.approx(1000.0 / r.frame_ms)
    frames = 1 + 4 + (4 if orbit_deg else 0)
    counts = r.renderer_counts
    assert counts["pallas"] + counts["sweep"] == frames
    poses = [k for k in r.engine.volumes[0]._sweep_cache
             if isinstance(k, tuple) and k[0] == "pose"]
    assert len(poses) == (4 if orbit_deg else 1)
    assert r.row()[:3] == ["beetle", 2, 4]


def test_run_sweep_writes_the_jax_schema_and_resumes(tmp_path, monkeypatch):
    """One key, block sizes 2 and 4, skipmodes 0 and 3: the JAX header;
    skipmode 0 at the smallest block size only; a row already in the CSV
    is kept and not run again; the volume is synthesised once; the
    deterministic columns are the JAX make_engine's."""
    prefix = str(tmp_path / "benchmark_results")
    with open(f"{prefix}_3.csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(jh.CSV_COLUMNS)
        w.writerow(["beetle", 3, 4, 1.0, -1.0, 0.0, 0.086, 1.0, 0.0, 0.0])
    made = []

    def counting(ds, *a, **k):
        made.append(ds.key)
        return synthesize(ds, *a, **k)

    monkeypatch.setattr(th, "synthesize", counting)
    logs = []
    th.run_sweep(dataset_keys=("beetle",), skipmodes=(0, 3),
                 blocksizes=(4, 2), width=128, height=128, frames=1,
                 scale=0.05, out_prefix=prefix, device="cpu",
                 log=logs.append)
    assert made == ["beetle"]
    assert "beetle skipmode=3 b=4: already done" in logs
    rows = {}
    for sm in (0, 3):
        with open(f"{prefix}_{sm}.csv", newline="") as fh:
            got = list(csv.reader(fh))
        assert got[0] == jh.CSV_COLUMNS
        rows[sm] = got[1:]
    assert [r[:3] for r in rows[0]] == [["beetle", "0", "2"]]
    assert [r[:3] for r in rows[3]] == [["beetle", "3", "4"],
                                        ["beetle", "3", "2"]]
    assert rows[3][0][4] == "-1.0"                # the pre-written row
    vol = synthesize(DATASETS["beetle"], scale=0.05)
    for sm, row in ((0, rows[0][0]), (3, rows[3][1])):
        _, jstats, _, _ = jh.make_engine("beetle", sm, 2, volume_u8=vol)
        want = jh.BenchResult("beetle", sm, 2,
                              jstats.occupied_voxel_percent, 1.0, 0.0,
                              0.086, 1.0, 0.0, 0.0).row()
        det = [0, 1, 2, 3, 6, 7, 8, 9]
        assert [row[i] for i in det] == [str(want[i]) for i in det]
        assert float(row[4]) > 0 and float(row[5]) > 0


def test_time_jitted_is_the_median_call():
    calls = []
    s = timing.time_jitted(lambda x: calls.append(x), 7, warmup=2, iters=5,
                           device="cpu")
    assert calls == [7] * 7 and 0.0 <= s < 1.0


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with timing.profiler_trace(str(tmp_path / "t")):
        torch.ones(64).sum()
    with open(tmp_path / "t" / "trace.json") as fh:
        assert "traceEvents" in json.load(fh)
    with timing.profiler_trace(None):
        pass


def test_bench_entry_prints_one_line_without_jax(tmp_path):
    """``python -m vkvolume_tpu_torch.bench --device cpu`` prints one JSON
    line with bench.py's keys, with ``jax`` and the JAX package shadowed
    by modules that refuse to import."""
    for name in ("jax", "vkvolume_tpu"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f"raise ImportError('{name} imported')\n")
    # One ATen thread, as in this module (tests/torch_threads.py): the
    # suite's workers share a few cores.
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               BENCH_SCALE="0.05", BENCH_WIDTH="256", BENCH_HEIGHT="256",
               BENCH_FRAMES="1", BENCH_REPS="1")
    out = subprocess.run(
        [sys.executable, "-m", "vkvolume_tpu_torch.bench", "--device", "cpu"],
        cwd=tmp_path, env=env, check=True, capture_output=True,
        text=True).stdout
    lines = out.strip().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    keys = {"metric", "value", "unit", "vs_baseline", "fps", "map_update_ms",
            "occupancy_pct", "frames", "scale", "wall_s", "rep_ms",
            "rep_spread", "renderer_used", "renderer_counts", "protocol",
            "stages", "device", "power_limit"}
    assert keys <= set(r) and "frame_ms_stretch_equiv" not in r
    assert r["unit"] == "ms/frame" and r["protocol"] == "1x1"
    assert r["renderer_used"] == "pallas"
    assert {k for k, n in r["renderer_counts"].items() if n} == {"pallas"}
    assert set(r["stages"]) == {"plan_ms", "sweep_ms", "warp_ms"}
    assert r["device"] == "cpu" and r["power_limit"] is None
    assert r["fps"] == pytest.approx(1000.0 / r["value"])
    # The reference's skipmode-3 672.3 fps at 1200x1200, pixel-scaled.
    ref_ms = 1000.0 / (672.3 / (256 * 256 / 1200.0 ** 2))
    assert r["vs_baseline"] == pytest.approx(ref_ms / r["value"])


def test_bench_entry_refuses_without_a_card():
    from vkvolume_tpu_torch.bench.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])
