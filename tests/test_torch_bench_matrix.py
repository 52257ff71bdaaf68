"""The benchmark matrix's paths that no other port test holds: skipmodes 0
and 1 (the brick sweep with ``dist_leap`` off), block sizes 2 and 6
(new map shapes and coarse-map factors), and the present and snake
specimens. Each case: the port's engine from ``make_engine`` (plain
PyTorch on the CPU) against the JAX package's engine taking its Pallas
frame in interpret mode, in benchmark mode (ERT off, the sample-count
output) at 256x256, on the same synthetic volume: the maps
bit-exact, the sweep's per-cell sample counts exact, the frame within
the u16 warp's half sample."""

import functools

import numpy as np
import pytest

from vkvolume_tpu.bench import harness as jh
from vkvolume_tpu.render import sweep_pallas
from vkvolume_tpu_torch.bench import harness as th
from vkvolume_tpu_torch.bench.datasets import DATASETS, synthesize
from vkvolume_tpu_torch.render import sweep_slabs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

W = H = 256


# The snake (1024x1024x795 at full scale) at half the others' scale: its
# gradient frame is the slowest of the plain versions here.
@pytest.mark.parametrize("key,skipmode,blocksize,scale", [
    ("beetle", 0, 4, 0.1), ("beetle", 1, 4, 0.1), ("beetle", 3, 2, 0.1),
    ("beetle", 3, 6, 0.1), ("present", 3, 4, 0.1), ("snake-grad", 2, 3, 0.05)])
def test_matrix_frame_matches_jax_pallas_frame(monkeypatch, key, skipmode,
                                               blocksize, scale):
    interpret = functools.partial(sweep_pallas._frame_jit, interpret=True)
    jframe = {}

    def capture(*a, **k):
        jframe["a"], jframe["k"] = a, k
        return interpret(*a, **k)

    monkeypatch.setattr(sweep_pallas, "_frame_jit", capture)
    vol = synthesize(DATASETS[key], scale=scale)
    jeng, jstats, _, _ = jh.make_engine(key, skipmode, blocksize,
                                        volume_u8=vol)
    teng, tstats, _, _ = th.make_engine(key, skipmode, blocksize,
                                        volume_u8=vol, device="cpu")
    assert tstats.occupied_voxel_percent == jstats.occupied_voxel_percent
    np.testing.assert_array_equal(teng.volumes[0].dist_maps.numpy(),
                                  np.asarray(jeng.volumes[0].dist_maps))
    cam = jh.benchmark_camera(aspect=W / H)
    jout = jeng.render(cam, W, H)
    assert jeng.last_renderer == "pallas"
    tout = teng.render(cam, W, H)
    assert teng.last_renderer == "pallas"

    # The sweep's grid channels before the warp: the count colour, its
    # alpha (1 where covered) and each cell's sample count exact, the
    # first-hit depth within 1e-6.
    jchans = np.asarray(interpret(*jframe["a"], **jframe["k"],
                                  return_chans=True)[0])
    (_, _), (pa, _) = th.capture_stages(teng, cam, W, H)
    tchans = pa[0].numpy()
    assert tchans.shape == jchans.shape and tchans.shape[0] == 4
    for c in (0, 1, 3):
        np.testing.assert_array_equal(tchans[c], jchans[c])
    assert jchans[3].max() > 0
    np.testing.assert_allclose(tchans[2], jchans[2], rtol=0, atol=1e-6)

    # The frame. Alpha (1 where covered) exact; the colour, count / step
    # budget, within half a sample: the port warps the count channel
    # u16-encoded at scale 1 (whole samples after the first pass), as the
    # TPU does, the JAX interpret warp in f32 (tests/test_torch_cli_
    # benchmark.py). Depth within the u16 encoding of its two passes.
    want = np.asarray(jout.color)
    got = tout.color.numpy()
    assert got.shape == (H, W, 4) and np.isfinite(got).all()
    assert (want[..., 3] > 0).mean() > 0.05          # real content
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    steps = sweep_slabs.n_steps_max(max(vol.shape), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=0.5 / steps + 1e-6)
    np.testing.assert_allclose(tout.depth.numpy(), np.asarray(jout.depth),
                               rtol=0, atol=1e-4)
    dn = (tout.num_volume_samples.numpy()
          - np.asarray(jout.num_volume_samples).astype(np.int32))
    assert np.abs(dn).max() <= 1
