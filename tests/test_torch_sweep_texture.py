"""K1's texture-TF variant: the port's plain brick sweep with ``texture_tf``
against the JAX package's ``_sweep_bricks_jit(texture_tf=True)`` in Pallas
interpret mode, on the inputs of ``tests/test_torch_sweep_bricks.py``: the
aligned intensity-TF variant (beetle at scale 0.1, skipmode 3) and the
gradient + plane-pair-lerp variant (the CLI's TF, skipmode 2, n_slabs 166
against Np 49).

Sample counts are exact. Lum, alpha and the first-hit depth agree to 1e-5
except where the two versions' tent sums, or the interpret-mode kernel's
fused multiply-adds, put an intensity or gradient on the other side of a
texel boundary: the quantised alpha then moves by one texel level. Those
pixels are at most 0.5 % of the covered ones, each within 0.06; measured
0.024 % (aligned, azimuth 30), 0.061 % and 0.061 % (gradient + lerp,
azimuths 30 and 210), each within 0.0036.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkvolume_tpu.options import Test as JTest
from vkvolume_tpu.render import sweep_bricks as jsb
from vkvolume_tpu_torch import interop
from vkvolume_tpu_torch.render import sweep_bricks as tsb
from test_torch_sweep_bricks import _port_tf, _setup
from test_torch_sweep_bricks import engine, grad_engine  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _port(s, ert, texture_tf):
    grad_t = s["grad_t"]
    return tsb.sweep_bricks(
        interop.maps_from_numpy(np.asarray(s["vol_t"])),
        interop.maps_from_numpy(np.asarray(s["occ_t"])), _port_tf(s),
        interop.uniforms_from_numpy(vars(s["u"])), s["pvm"],
        tuple(torch.tensor(a) for a in s["grid"]), p_axis=s["p"],
        ert=ert, count_samples=True, n_slabs=s["n_slabs"], sgn=s["sgn"],
        tile_h=s["plan"]["tile_h"], dist_leap=True,
        grad_t=(None if grad_t is None
                else interop.maps_from_numpy(np.asarray(grad_t))),
        texture_tf=texture_tf)


def _jax(s, ert):
    plan = s["plan"]
    return jsb._sweep_bricks_jit(
        s["vol_t"], s["occ_t"], s["tf"], None, s["u"], jnp.asarray(s["pvm"]),
        s["grad_t"], tuple(jnp.asarray(a) for a in s["grid"]), p_axis=s["p"],
        R=plan["R_brick"], ert=ert, test=JTest.NONE, count_samples=True,
        n_slabs=s["n_slabs"], sgn=s["sgn"], tile_h=plan["tile_h"],
        span_blks=plan["span_blks"], rect_w=plan["rect_w"],
        interpret=True, dist_leap=True, tent_prec="highest",
        texture_tf=True)


@pytest.mark.parametrize("fixture,azimuth,ert", [
    ("engine", 30.0, True), ("grad_engine", 30.0, True),
    ("grad_engine", 210.0, False)])
def test_texture_brick_sweep_matches_pallas_interpret(request, fixture,
                                                      azimuth, ert):
    s = _setup(request.getfixturevalue(fixture), azimuth)
    aligned = s["n_slabs"] == s["vol_t"].shape[0]
    assert aligned == (fixture == "engine")
    assert bool(s["tf"].use_gradient) == (fixture == "grad_engine")
    out, ref = _port(s, ert, True), _jax(s, ert)
    np.testing.assert_array_equal(out.num_volume_samples.numpy(),
                                  np.asarray(ref.num_volume_samples))
    got_c, want_c = out.color.numpy(), np.asarray(ref.color)
    got_d, want_d = out.depth.numpy(), np.asarray(ref.depth)
    assert want_c[..., 3].max() > 0.3                   # real content
    cov = s["grid"][5]
    diff = np.maximum(np.abs(got_c - want_c).max(axis=-1),
                      np.abs(got_d - want_d))
    flipped = diff > 1e-5
    share = flipped[cov].mean()
    assert not flipped[~cov].any()
    assert share <= 5e-3, share
    assert diff.max() <= 0.06, diff.max()
    # The texture variant really ran: it differs from the closed form
    # (held to the JAX kernel's by tests/test_torch_sweep_bricks.py).
    closed = _port(s, ert, False)
    assert np.abs(closed.color.numpy() - got_c).max() > 1e-5
