"""The acceleration-map cache (``engine/accel_cache.py``,
``Engine(accel_cache_dir=)``): the JAX package's round-trip test on the
port, and a cache written by either package restored by the other (the
same key and file layout)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from vkvolume_tpu.engine import Engine as JEngine
from vkvolume_tpu.engine import RenderOptions as JRO
from vkvolume_tpu.engine import VolumeOptions as JVO
from vkvolume_tpu.engine import accel_cache as jcache
from vkvolume_tpu.engine import from_array as jfrom
from vkvolume_tpu_torch.engine import Engine, RenderOptions, VolumeOptions
from vkvolume_tpu_torch.engine import accel_cache as tcache
from vkvolume_tpu_torch.engine import from_array
from vkvolume_tpu_torch.options import SkippingType

from util import sphere_shell_volume

OPTS = dict(intensity_min=0.1, gradient_min=0.0, gradient_max=0.0)


def test_accel_cache_roundtrip(tmp_path):
    """``tests/test_engine.py::test_accel_cache_roundtrip`` on the port."""
    vol = sphere_shell_volume(24)

    def engine():
        return Engine(RenderOptions(skipping_type=SkippingType.DISTANCE),
                      renderer="pallas", device="cpu",
                      accel_cache_dir=str(tmp_path))

    v1 = from_array(vol, VolumeOptions(**OPTS), block_size=4, device="cpu")
    assert engine().add_volume(v1).map_update_ms is not None
    assert len(os.listdir(tmp_path)) == 1
    v2 = from_array(vol, VolumeOptions(**OPTS), block_size=4, device="cpu")
    eng2 = engine()
    stats = eng2.add_volume(v2)
    # restored, not recomputed
    assert stats.map_update_ms is None
    np.testing.assert_array_equal(v2.dist_maps.numpy(), v1.dist_maps.numpy())
    np.testing.assert_array_equal(v2.gradient.numpy(), v1.gradient.numpy())
    assert v2.dist_maps.device == v2.density.device
    # A restored engine renders, with the same frame.
    from vkvolume_tpu_torch.camera import orbit_camera

    cam = orbit_camera(radius=150.0, azimuth_deg=25.0, elevation_deg=15.0)
    eng1 = engine()
    eng1.volumes.append(v1)
    np.testing.assert_array_equal(eng2.render(cam, 128, 64).color.numpy(),
                                  eng1.render(cam, 128, 64).color.numpy())
    # different TF → different key → rebuild happens
    v3 = from_array(vol, VolumeOptions(**dict(OPTS, intensity_min=0.5)),
                    block_size=4, device="cpu")
    assert engine().add_volume(v3).map_update_ms is not None
    assert len(os.listdir(tmp_path)) == 2


@pytest.mark.parametrize("skipmode,precomputed", [
    (SkippingType.DISTANCE, True), (SkippingType.ANISOTROPIC_DISTANCE, True),
    (SkippingType.BLOCK, False)])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cache_is_shared_with_the_jax_package(tmp_path, skipmode,
                                              precomputed, writer):
    vol = sphere_shell_volume(20)
    opts = dict(OPTS, use_precomputed_gradient=precomputed)
    jv = jfrom(vol, JVO(**opts), block_size=3, name="shell")
    tv = from_array(vol, VolumeOptions(**opts), block_size=3, name="shell",
                    device="cpu")
    assert tcache._key(tv, skipmode) == jcache._key(jv, skipmode)
    jeng = JEngine(JRO(skipping_type=skipmode), renderer="sweep",
                   accel_cache_dir=str(tmp_path))
    teng = Engine(RenderOptions(skipping_type=skipmode), renderer="pallas",
                  device="cpu", accel_cache_dir=str(tmp_path))
    first, then = ((jeng, jv), (teng, tv)) if writer == "jax" else \
        ((teng, tv), (jeng, jv))
    assert first[0].add_volume(first[1]).map_update_ms is not None
    assert then[0].add_volume(then[1]).map_update_ms is None   # restored
    assert len(os.listdir(tmp_path)) == 1
    np.testing.assert_array_equal(tv.dist_maps.numpy(),
                                  np.asarray(jv.dist_maps))
    if precomputed:
        np.testing.assert_array_equal(tv.gradient.numpy(),
                                      np.asarray(jv.gradient))
    else:
        assert tv.gradient is None and jv.gradient is None
    assert isinstance(jv.dist_maps, jnp.ndarray)
