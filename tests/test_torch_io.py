"""Raw volume IO of the port (``vkvolume_tpu_torch.io``, ``Volume.from_file``,
``interop.volume_from_numpy``) against ``vkvolume_tpu.io``: headers parse
and write byte-equal, every dtype × endianness loads bit-equal, through the
native loader when it is built and through numpy when it is not."""

import dataclasses

import numpy as np
import pytest
import torch

from vkvolume_tpu import io as jio
from vkvolume_tpu.engine import volume as jvolume
from vkvolume_tpu.io import native as jnative
from vkvolume_tpu_torch import cli as tcli
from vkvolume_tpu_torch import interop
from vkvolume_tpu_torch import io as tio
from vkvolume_tpu_torch.engine import volume as tvolume
from vkvolume_tpu_torch.io import native as tnative

HEADER_TEXT = """832 832 494 # extents
0.001 0.001 0.001 # voxel size
400.0 2538.0 # normalisation range
uint16_t little # data type and endianness (big or little)
1 0 0 90 # rotation axis and angle (degrees)
"""

_RANGES = {"uint8_t": (0, 256), "int8_t": (-128, 128),
           "uint16_t": (0, 65536), "int16_t": (-32768, 32768)}


def _header(mod, dtype="uint16_t", endianness="little", extent=(13, 9, 7)):
    return mod.Header(extent=extent, voxel_size=(0.001, 0.002, 0.003),
                      normalisation_range=(-50.0, 900.0), dtype=dtype,
                      endianness=endianness, rotation_axis=(1.0, 0.0, 0.0),
                      rotation_angle_deg=90.0)


def test_parse_header_matches_jax():
    t = tio.parse_header(HEADER_TEXT)
    j = jio.parse_header(HEADER_TEXT)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.shape_zyx == (494, 832, 832) and t.np_dtype == j.np_dtype
    np.testing.assert_array_equal(t.image_transform, j.image_transform)


@pytest.mark.parametrize("bad", ["1 2\n", HEADER_TEXT.replace("uint16_t",
                                                              "float"),
                                 HEADER_TEXT.replace("little", "middle")])
def test_bad_headers_raise_like_jax(bad):
    with pytest.raises(ValueError):
        jio.parse_header(bad)
    with pytest.raises(ValueError):
        tio.parse_header(bad)


def test_write_header_is_byte_equal(tmp_path):
    tio.write_header(tmp_path / "t.header", _header(tio))
    jio.write_header(tmp_path / "j.header", _header(jio))
    assert (tmp_path / "t.header").read_bytes() == \
        (tmp_path / "j.header").read_bytes()


@pytest.mark.parametrize("dtype", sorted(_RANGES))
@pytest.mark.parametrize("endianness", ["little", "big"])
@pytest.mark.parametrize("use_native", [True, False])
def test_load_volume_matches_jax(monkeypatch, tmp_path, dtype, endianness,
                                 use_native):
    """save_volume writes byte-equal files and load_volume reads them back
    bit-equal to the JAX package (native loader or numpy path)."""
    if use_native and not tnative.available():
        pytest.skip("native loader not built (make -C native)")
    if not use_native:
        monkeypatch.setattr(tnative, "_find_lib", lambda: None)
    rng = np.random.default_rng(0)
    raw = rng.integers(*_RANGES[dtype], size=(7, 9, 13))
    tio.save_volume(tmp_path / "t.raw", raw, _header(tio, dtype, endianness))
    jio.save_volume(tmp_path / "j.raw", raw, _header(jio, dtype, endianness))
    for suffix in ("", ".header"):
        assert (tmp_path / f"t.raw{suffix}").read_bytes() == \
            (tmp_path / f"j.raw{suffix}").read_bytes()
    got, th = tio.load_volume(tmp_path / "t.raw")
    want, jh = jio.load_volume(tmp_path / "j.raw")
    assert got.dtype == np.uint8 and got.shape == (7, 9, 13)
    np.testing.assert_array_equal(got, want)
    assert dataclasses.asdict(th) == dataclasses.asdict(jh)
    assert tnative.available() == (use_native and jnative.available())


def test_normalise_matches_jax():
    v = np.random.default_rng(1).normal(300.0, 400.0, 5000).astype(np.float32)
    np.testing.assert_array_equal(tio.normalise_to_u8(v, 400.0, 2538.0),
                                  jio.normalise_to_u8(v, 400.0, 2538.0))


def test_size_mismatch_raises(tmp_path):
    h = _header(tio, "uint8_t")
    np.zeros(10, np.uint8).tofile(tmp_path / "v.raw")
    with pytest.raises(ValueError, match="File size"):
        tio.load_data(tmp_path / "v.raw", h)


def test_from_file_matches_jax(tmp_path):
    raw = np.random.default_rng(2).integers(0, 65536, size=(7, 9, 13))
    tio.save_volume(tmp_path / "v.raw", raw, _header(tio))
    t = tvolume.from_file(str(tmp_path / "v.raw"), block_size=2,
                          device="cpu")
    j = jvolume.from_file(str(tmp_path / "v.raw"), block_size=2)
    assert t.device == torch.device("cpu") and t.density.dtype == torch.uint8
    np.testing.assert_array_equal(t.density.numpy(), np.asarray(j.density))
    np.testing.assert_array_equal(t.image_transform, j.image_transform)
    assert dataclasses.asdict(t.header) == dataclasses.asdict(j.header)
    assert t.name == j.name and t.map_shape_zyx == j.map_shape_zyx


def test_set_spin_matches_jax():
    data = np.zeros((4, 5, 6), np.uint8)
    t = tvolume.from_array(data, device="cpu")
    j = jvolume.from_array(data)
    for v in (t, j):
        v.set_scale((2.0, 3.0, 4.0))
        v.node_transform[:3, 3] = (1.0, -2.0, 0.5)     # a translated node
        v.set_spin(0.7)
        v.set_spin(1.1)                      # absolute, not cumulative
    np.testing.assert_allclose(t.node_transform, j.node_transform,
                               rtol=0, atol=1e-7)
    np.testing.assert_array_equal(t.node_transform[:3, 3], (1.0, -2.0, 0.5))


def test_volume_from_numpy_carries_gradient_and_header():
    rng = np.random.default_rng(3)
    dens = rng.integers(0, 256, (4, 5, 6)).astype(np.uint8)
    grad = rng.integers(0, 256, (4, 5, 6)).astype(np.uint8)
    h = _header(tio)
    v = interop.volume_from_numpy(dens, np.eye(4), np.eye(4), 2,
                                  gradient=grad, header=h)
    np.testing.assert_array_equal(v.gradient.numpy(), grad)
    assert v.header is h


def test_cli_loads_raw_files_like_jax(monkeypatch, tmp_path):
    """The CLI's raw-file path: two files, per-volume options, the same
    fit scale and maps as the JAX CLI."""
    from vkvolume_tpu import cli as jcli
    from vkvolume_tpu import utils as jutils

    paths = []
    for i, seed in enumerate((4, 5)):
        raw = np.random.default_rng(seed).integers(0, 256, size=(12, 14, 16))
        p = tmp_path / f"v{i}.raw"
        tio.save_volume(p, raw, _header(tio, "uint8_t", extent=(16, 14, 12)))
        paths.append(str(p))
    argv = paths + ["--skipmode", "2"]
    teng, tvols = tcli.setup_engine(tcli.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    monkeypatch.setattr(jutils, "enable_compile_cache",
                        lambda *a, **k: None)
    jeng, jvols = jcli.setup_engine(jcli.build_parser().parse_args(argv))
    assert len(tvols) == 2 and tvols[0].options is not tvols[1].options
    for tv, jv in zip(tvols, jvols):
        np.testing.assert_allclose(tv.node_transform, jv.node_transform,
                                   rtol=1e-6)
        teng.add_volume(tv)
        jeng.add_volume(jv)
        np.testing.assert_array_equal(tv.dist_maps.numpy(),
                                      np.asarray(jv.dist_maps))
