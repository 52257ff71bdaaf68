"""The occupancy kernel (``csrc/occupancy.cu``, ``accel/occupancy_cuda.py``)
against its plain PyTorch version on the same CUDA tensors, bit for bit.
Marked ``cuda``: they skip without a CUDA device. On a machine with a card
and without JAX (from the repository's root):

    python -m pytest --noconftest -m cuda -q \
        tests/test_torch_occupancy_cuda.py
"""

import numpy as np
import pytest
import torch

from vkvolume_tpu_torch.accel import occupancy as tocc
from vkvolume_tpu_torch.accel import occupancy_cuda

pytestmark = pytest.mark.cuda

THRESHOLDS = [(ti, tg) for ti in (0, 1, 128, 255, 256) for tg in (0, 1, 255)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _held(vol, grad, map_shape, ti, tg):
    """The kernel's map (through ``_occupancy_u8``) equals the plain
    version's on the same tensors; one launch, none past 255."""
    before = occupancy_cuda.LAUNCHES["occupancy"]
    got = tocc._occupancy_u8(vol, grad, map_shape, ti, tg)
    launched = occupancy_cuda.LAUNCHES["occupancy"] - before
    assert launched == (0 if ti > 255 or tg > 255 else 1)
    if launched:
        want = tocc._occupancy_u8_plain(vol, grad, map_shape, ti, tg)
        torch.cuda.synchronize()
        assert got.dtype == torch.uint8 and got.shape == want.shape
        assert torch.equal(got, want), (tuple(vol.shape), map_shape, ti, tg,
                                        grad is not None)
    return got


# Ragged extents (x widths off multiples of 16: the byte loads), one voxel,
# a row wider than a tile (1100 bytes), and maps with whole cells of
# padding.
@pytest.mark.parametrize("shape,map_shape", [
    ((1, 1, 1), None), ((37, 50, 61), None), ((9, 13, 45), None),
    ((6, 5, 33), None), ((4, 4, 4), (3, 3, 3)), ((5, 6, 64), None),
    ((3, 9, 96), None), ((2, 3, 1100), None), ((2, 3, 1100), (1, 1, 1)),
    ((40, 70, 1040), None)])
@pytest.mark.parametrize("block", [2, 3, 4, 5, 6])
def test_occupancy_kernel_bit_exact(dev, shape, map_shape, block):
    rng = np.random.default_rng(block)
    vol = torch.tensor((rng.random(shape) ** 3 * 256).astype(np.uint8),
                       device=dev)
    grad = torch.tensor(rng.integers(0, 256, shape, dtype=np.uint8),
                        device=dev)
    if map_shape is None:
        map_shape = tuple(-(-s // block) for s in shape)
    kinds = set()
    for ti, tg in THRESHOLDS:
        for g in (None, grad):
            got = _held(vol, g, map_shape, ti, tg)
            kinds.update(torch.unique(got).tolist())
    assert kinds == {tocc.OCCUPIED, tocc.EMPTY}


def _sparse_volume(shape, dev, seed):
    """Zero, with random boxes of random values and a sprinkle of single
    voxels: occupied and empty cells, and box edges off the cell grid."""
    g = torch.Generator(device=dev).manual_seed(seed)
    vol = torch.zeros(shape, dtype=torch.uint8, device=dev)
    corners = torch.rand((300, 3), generator=g, device=dev)
    sizes = torch.randint(2, 60, (300, 3), generator=g, device=dev)
    for c, s in zip(corners.cpu().tolist(), sizes.cpu().tolist()):
        lo = [int(ci * n) for ci, n in zip(c, shape)]
        box = vol[lo[0]:lo[0] + s[0], lo[1]:lo[1] + s[1], lo[2]:lo[2] + s[2]]
        box.copy_(torch.randint(0, 256, box.shape, generator=g, device=dev,
                                dtype=torch.uint8))
    speck = torch.rand(shape, generator=g, device=dev) < 2e-5
    vol[speck] = 255
    return vol


def test_occupancy_kernel_at_the_kingsnake_shape(dev):
    """The benchmark's volume shape (795 x 1024 x 1024, block 4: a
    199 x 256 x 256 map), with and without a gradient map, at TF-b's
    thresholds and at the grid's edges."""
    shape = (795, 1024, 1024)
    vol = _sparse_volume(shape, dev, 1)
    grad = torch.randint(0, 256, shape, device=dev, dtype=torch.uint8,
                         generator=torch.Generator(device=dev).manual_seed(2))
    map_shape = tuple(-(-s // 4) for s in shape)
    assert map_shape == (199, 256, 256)
    for ti, tg in ((52, 16), (0, 0), (1, 255), (255, 1)):
        for g in (grad, None):
            got = _held(vol, g, map_shape, ti, tg)
            if (ti, tg) == (52, 16):
                n = int((got == tocc.OCCUPIED).sum())
                assert 0 < n < got.numel()


def test_occupancy_kernel_refuses_what_it_cannot_read(dev):
    """A base off 16 bytes, a strided view, a gradient of another shape,
    the wrong dtype: ValueError before any launch."""
    vol = torch.randint(0, 256, (8, 9, 32), device=dev, dtype=torch.uint8)
    buf = torch.zeros(vol.numel() + 16, device=dev, dtype=torch.uint8)
    shifted = buf[1:1 + vol.numel()].view(vol.shape)
    shifted.copy_(vol)
    before = occupancy_cuda.LAUNCHES["occupancy"]
    bad = [(shifted, None, "aligned"), (vol, shifted, "aligned"),
           (vol[:, :, ::2], None, "contiguous"),
           (vol.transpose(0, 2), None, "contiguous"),
           (vol, vol[:, :, ::2].contiguous(), "shape"),
           (vol.to(torch.int16), None, "uint8")]
    for v, g, what in bad:
        with pytest.raises(ValueError, match=what):
            tocc._occupancy_u8(v, g, (2, 3, 8), 10, 0)
    assert occupancy_cuda.LAUNCHES["occupancy"] == before


@pytest.mark.parametrize("use_gradient", [True, False])
def test_one_launch_per_tf_edit(dev, use_gradient):
    """At skipmode 2 every TF edit of the engine builds its map with one
    launch of the kernel, and its isotropic map is the plain occupancy
    map's."""
    from vkvolume_tpu_torch.accel import distance
    from vkvolume_tpu_torch.engine import (Engine, RenderOptions,
                                           VolumeOptions, from_array)
    from vkvolume_tpu_torch.options import SkippingType

    vol = _sparse_volume((70, 90, 100), dev, 3).cpu().numpy()
    opts = VolumeOptions(intensity_min=0.2, intensity_max=0.8,
                         gradient_min=0.06 if use_gradient else 0.0,
                         gradient_max=0.12 if use_gradient else 0.0)
    eng = Engine(RenderOptions(skipping_type=SkippingType.DISTANCE),
                 renderer="pallas", device="cuda")
    v = from_array(vol, opts, block_size=4, device="cuda")
    eng.add_volume(v)
    for imin in (0.2, 0.25, 0.3):
        v.options.intensity_min = imin
        before = occupancy_cuda.LAUNCHES["occupancy"]
        eng.update_transfer_function(v)
        assert occupancy_cuda.LAUNCHES["occupancy"] == before + 1
        ti, tg = tocc._tf_thresholds(None, (imin, 0.8, v.options.gradient_min,
                                            v.options.gradient_max))
        want = tocc._occupancy_u8_plain(
            v.density, v.gradient if use_gradient else None, v.map_shape_zyx,
            ti, tg)
        assert torch.equal(v.dist_maps[0], distance.isotropic_distance(want))
