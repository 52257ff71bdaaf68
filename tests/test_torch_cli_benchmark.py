"""The port's CLI in benchmark mode (``--benchmark N``, ``--device cpu``):
the reference's log lines, and the forced Test.NUM_TEXTURE_SAMPLES frame
(ERT off, clip distance 1: the sample-count channel through the warp,
colour = count / floor(ceil(dim_max·√3)·sf)) against the JAX CLI's engine
with its Pallas frame in interpret mode, on the synthetic beetle at scale
0.1 at 256x256."""

import contextlib
import functools
import io

import numpy as np
import pytest

from vkvolume_tpu import cli as jcli
from vkvolume_tpu import utils as jutils
from vkvolume_tpu.bench.harness import benchmark_camera
from vkvolume_tpu.render import sweep_pallas
from vkvolume_tpu_torch import cli as tcli
from vkvolume_tpu_torch.options import Test as TTest
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BENCH_ARGS = ["--synth", "beetle", "--synth-scale", "0.1", "--width", "256",
              "--height", "256", "--benchmark", "2"]


@pytest.fixture(scope="module")
def bench_run():
    """One port CLI run in benchmark mode: (engine, last frame, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eng, _, out = tcli.run(BENCH_ARGS + ["--device", "cpu"])
    return eng, out, buf.getvalue()


def test_benchmark_mode_prints_reference_log_lines(bench_run):
    eng, out, stdout = bench_run
    logs = stdout.splitlines()
    for prefix in ("Updated gradient map in ", "Occupied voxels: ",
                   "Updated occupancy/distance map in ", "Prepared in ",
                   "ran 2 frames, averaged "):
        assert sum(line.startswith(prefix) for line in logs) == 1, prefix
    assert logs[-1].endswith(" fps")
    assert eng.options.test == TTest.NUM_TEXTURE_SAMPLES
    assert not eng.options.early_ray_termination
    # The sample-count frame: opaque where covered, counts in the colour.
    c = out.color.numpy()
    cov = c[..., 3] > 0
    assert cov.mean() > 0.05 and (c[cov, 3] == 1.0).all()
    assert out.num_volume_samples.numpy().max() > 0


def test_benchmark_frame_matches_jax_benchmark_frame(monkeypatch, bench_run):
    teng = bench_run[0]
    monkeypatch.setattr(jutils, "enable_compile_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr(sweep_pallas, "_frame_jit", functools.partial(
        sweep_pallas._frame_jit, interpret=True))
    jeng, jvols = jcli.setup_engine(jcli.build_parser().parse_args(
        BENCH_ARGS))
    for v in jvols:
        jeng.add_volume(v)
    cam = benchmark_camera(1.0, 30.0, 20.0)
    jout = jeng.render(cam, 256, 256)
    assert jeng.last_renderer == "pallas"
    tout = teng.render(cam, 256, 256)
    want = np.asarray(jout.color)
    got = tout.color.numpy()
    assert (want[..., 3] > 0).mean() > 0.05
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    # The port warps the count channel u16-encoded at scale 1, as the TPU
    # does: the first pass rounds interpolated counts to whole samples.
    # The JAX interpret warp is f32, so colours differ by at most half a
    # sample over the step budget floor(ceil(83·√3)) = 144.
    np.testing.assert_allclose(got, want, rtol=0, atol=0.5 / 144 + 1e-6)
