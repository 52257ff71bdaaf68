"""Multi-volume frames: the port's ``Engine.render`` blends per-volume
outputs as the JAX engine's ``render`` does (colour over, nearer depth,
and all three sample counters summed). Both engines hold two small
volumes; ``render_volume`` is replaced in both by the same seeded
per-volume outputs, so only the blend is compared."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkvolume_tpu.engine import Engine as JEngine
from vkvolume_tpu.engine import from_array as j_from_array
from vkvolume_tpu.render.marcher_xla import RenderOutput as JOutput
from vkvolume_tpu_torch.engine import Engine as TEngine
from vkvolume_tpu_torch.engine import from_array as t_from_array
from vkvolume_tpu_torch.render.ray_setup import RenderOutput as TOutput

H, W = 6, 10
COUNTERS = ("num_volume_samples", "num_distance_samples", "num_empty_samples")


def _outputs(seed, n):
    """``n`` per-volume outputs: premultiplied colours, reverse-Z depths
    and non-zero int32 counters, from a numpy seed."""
    rng = np.random.default_rng(seed)
    outs = []
    for _ in range(n):
        alpha = rng.uniform(0.0, 1.0, (H, W, 1))
        rgb = rng.uniform(0.0, 1.0, (H, W, 3)) * alpha
        outs.append(dict(
            color=np.concatenate([rgb, alpha], -1).astype(np.float32),
            depth=rng.uniform(0.0, 1.0, (H, W)).astype(np.float32),
            **{k: rng.integers(1, 1000, (H, W)).astype(np.int32)
               for k in COUNTERS}))
    return outs


@pytest.mark.parametrize("seed", [0, 1])
def test_render_blends_like_jax_engine(seed, monkeypatch):
    rng = np.random.default_rng(100 + seed)
    data = [rng.integers(0, 256, (8, 8, 8)).astype(np.uint8) for _ in range(2)]
    jeng, teng = JEngine(), TEngine(renderer="pallas", device="cpu")
    for d in data:
        jeng.add_volume(j_from_array(d))
        teng.add_volume(t_from_array(d, device="cpu"))
    outs = _outputs(seed, 2)

    def index(volumes, volume):
        return next(i for i, v in enumerate(volumes) if v is volume)

    def j_render_volume(volume, camera, width, height, depth_image=None):
        o = outs[index(jeng.volumes, volume)]
        return JOutput(**{k: jnp.asarray(v) for k, v in o.items()},
                       iterations=jnp.int32(1))

    def t_render_volume(volume, camera, width, height, depth_image=None):
        o = outs[index(teng.volumes, volume)]
        return TOutput(**{k: torch.from_numpy(v) for k, v in o.items()},
                       iterations=1)

    monkeypatch.setattr(jeng, "render_volume", j_render_volume)
    monkeypatch.setattr(teng, "render_volume", t_render_volume)
    want = jeng.render(None, W, H)
    got = teng.render(None, W, H)
    np.testing.assert_allclose(got.color.numpy(), np.asarray(want.color),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(want.depth))
    for k in COUNTERS:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      outs[0][k] + outs[1][k])
