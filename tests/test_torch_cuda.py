"""The CUDA kernels against their plain PyTorch versions on the card, at
small shapes. Marked ``cuda``: they skip without a CUDA device. On a
machine with a card and without JAX, run them without this directory's
conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from vkvolume_tpu_torch.accel import distance, distance_cuda
from vkvolume_tpu_torch.bench.harness import benchmark_camera, make_engine
from vkvolume_tpu_torch.options import Test as TTest
from vkvolume_tpu_torch.render import sweep_bricks, sweep_frame, warp_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,p,cap", [((9, 11, 13), 0.1, 63),
                                         ((13, 7, 140), 0.03, 63),
                                         ((24, 32, 40), 0.004, 15)])
def test_distance_kernels_bit_exact(dev, shape, p, cap):
    rng = np.random.default_rng(0)
    occ = torch.tensor(np.where(rng.random(shape) < p, 0, 255)
                       .astype(np.uint8), device=dev)
    xy = distance_cuda.scan_and_relax_multi(occ, cap)
    torch.testing.assert_close(xy, distance.scan_and_relax_multi(occ, cap),
                               rtol=0, atol=0)
    torch.testing.assert_close(distance_cuda.relax_z_direct_multi(xy),
                               distance.relax_z_direct_multi(xy), rtol=0,
                               atol=0)


@pytest.mark.parametrize("shape,p", [((9, 11, 13), 0.1), ((13, 7, 140), 0.03),
                                     ((70, 9, 300), 0.0)])
def test_isotropic_kernels_bit_exact(dev, shape, p):
    """K5 and the two-sided K4 (p=0: one occupied cell, distances past
    255 cells saturate)."""
    rng = np.random.default_rng(0)
    occ = np.where(rng.random(shape) < p, 0, 255).astype(np.uint8)
    occ[0, 0, 0] = 0
    occ = torch.tensor(occ, device=dev)
    xy = distance_cuda.scan_and_relax(occ)
    torch.testing.assert_close(xy, distance.scan_and_relax(occ, 0, (0,)),
                               rtol=0, atol=0)
    z = distance_cuda.relax_z_direct(xy[0])
    torch.testing.assert_close(z, distance.relax_z_direct(xy[0], (0,)),
                               rtol=0, atol=0)
    torch.testing.assert_close(distance_cuda.isotropic_distance_cuda(occ)[0],
                               distance.isotropic_distance(occ), rtol=0,
                               atol=0)


@pytest.mark.parametrize("u16,encode", [(True, True), (True, False),
                                        (False, False), (False, True)])
def test_resample_rows_kernel(dev, u16, encode):
    rng = np.random.default_rng(1)
    C, Ho, Wo, Ws = 3, 24, 384, 301
    pos = (rng.random((Ho, Wo)) * (Ws + 4) - 3).astype(np.float32)
    pos[rng.random((Ho, Wo)) < 0.1] = -10.0
    if u16:
        src = rng.integers(0, 65536, (C, Ho, Ws)).astype(np.uint16)
    else:
        src = rng.random((C, Ho, Ws)).astype(np.float32)
    s, q = torch.tensor(src, device=dev), torch.tensor(pos, device=dev)
    got = warp_cuda.resample_rows(s, q, encode_out=encode)
    want = warp_cuda.resample_rows_reference(s, q, encode_out=encode)
    assert got.dtype == want.dtype
    if encode:
        assert int((got.int() - want.int()).abs().max()) <= 1
    else:
        scale = 65535.0 if u16 else 1.0
        assert float((got - want).abs().max()) <= 1e-6 * scale


# (dataset, skipmode, slab density): bench.py's aligned intensity-only
# frame; the CLI's gradient TF with the plane-pair lerp (n_slabs 166 != Np
# 49); the gradient TF aligned; the lerp with an intensity-only TF.
@pytest.mark.parametrize("key,skipmode,density", [
    ("beetle", 3, "auto"), ("beetle-grad", 2, "auto"),
    ("beetle-grad", 2, "axis"), ("beetle", 2, "ref")])
def test_frame_kernels_match_plain_versions(dev, key, skipmode, density):
    """A small beetle frame on the card: K1 against its plain version on
    the frame's own inputs, and the whole frame against the CPU engine."""
    eng, _, vol, _ = make_engine(key, skipmode, 4, scale=0.1,
                                 test=TTest.NONE, ert=True, device="cuda")
    cpu, _, _, _ = make_engine(key, skipmode, 4, volume_u8=vol,
                               test=TTest.NONE, ert=True)
    eng.options.slab_density = cpu.options.slab_density = density
    torch.testing.assert_close(eng.volumes[0].dist_maps.cpu(),
                               cpu.volumes[0].dist_maps, rtol=0, atol=0)
    cam = benchmark_camera(aspect=1.0)
    got = eng.render(cam, 256, 256).color.cpu()
    want = cpu.render(cam, 256, 256).color
    assert float((want[..., 3] > 0).float().mean()) > 0.05
    assert float((got - want).abs().amax(-1).gt(2e-3).float().mean()) <= 1e-3

    v = eng.volumes[0]
    pose = next(p for k, p in v._sweep_cache.items()
                if isinstance(k, tuple) and k[0] == "pose")
    occ_t = next(t for k, t in v._sweep_cache.items()
                 if isinstance(k, tuple) and k[0] == "occ")
    plan, p = pose["plan"], pose["view"]["p_axis"]
    u, _, gp, _ = sweep_frame.unpack_frame_scalars(pose["packed"])
    vol_t = v._sweep_cache[p]
    tf = eng._tf(v)
    grad_t = v._sweep_cache.get(("grad", p))
    assert (grad_t is not None) == bool(tf.use_gradient)
    n_slabs = int(max(2, round(vol_t.shape[0] * eng._slab_oversample(
        v, vol_t.shape, tf))))
    aligned = density == "axis" or (density == "auto"
                                    and not tf.use_gradient)
    assert (n_slabs == vol_t.shape[0]) == aligned
    wu, wv = sweep_frame.w_grid(gp, plan["Hi"], plan["Wi"], dev)
    sgn = 1 if plan["sgn_p"] > 0 else -1
    fields = sweep_bricks.grid_fields(u, wu, wv, sgn, p, max(vol_t.shape),
                                      n_slabs)
    for ert in (True, False):
        inp = sweep_bricks.brick_inputs(
            vol_t, occ_t, tf, u, (wu, wv, *fields[:2], fields[3],
                                  fields[2]),
            p_axis=p, ert=ert, count_samples=True, n_slabs=n_slabs,
            sgn=sgn, tile_h=plan["tile_h"], dist_leap=skipmode >= 2,
            grad_t=grad_t)
        k = sweep_bricks.sweep_bricks_kernel(inp)
        r = sweep_bricks.sweep_bricks_reference(inp)
        assert torch.equal(k[3], r[3]) and torch.equal(k[2], r[2])
        assert float((k[0] - r[0]).abs().max()) <= 1e-5
        assert float((k[1] - r[1]).abs().max()) <= 1e-5
