"""The baked TF texture: the port's ``bake_texture`` and ``sample_texture``
against the JAX package's, and the quantisation K1's texture variant
computes in place of the lookup (``texel_alpha``, ``truncate_alpha``)
against the JAX kernel's lines and against the lookup of the bake.

The kernel multiplies by the float32 reciprocal of 255 where the bake
divides by 255, so at some texels the two sit on opposite sides of a u8
level: the kernel's alpha is then one level (1/255) above the texture's.
That is a trait of the reference (the JAX brick kernel against the JAX XLA
sweep), not of the port; the test pins those texels' count per TF. At every
other texel the two differ by at most one float32 ulp (the kernel's level
times 1/255 against the level divided by 255).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkvolume_tpu.tf import bake_texture as j_bake
from vkvolume_tpu.tf import sample_texture as j_sample
from vkvolume_tpu_torch.tf import bake_texture, sample_texture, tf_params
from vkvolume_tpu_torch.tf.transfer_function import (texel_alpha,
                                                     truncate_alpha)

# tests/test_tf.py's TF grid, and the CLI's default TF; the texels where the
# kernel's quantised closed form is one u8 level above the bake.
GRID = [((0.1, 1.0, 0.0, 0.0), 0), ((0.086, 1.0, 0.1, 0.3), 0),
        ((0.4, 0.8, 0.0, 0.0), 3072), ((0.2, 0.8, 0.06, 0.12), 1800),
        ((0.1, 1.0, 0.0, 0.2), 0)]


def _tf(imin, imax, gmin, gmax):
    return dict(intensity_min=imin, intensity_max=imax, gradient_min=gmin,
                gradient_max=gmax)


def _near_boundaries() -> np.ndarray:
    """Every texel boundary k/256 (k = 0..256), its float32 neighbours on
    both sides, and values beyond [0, 1]."""
    k = np.arange(257, dtype=np.float32) / np.float32(256.0)
    return np.concatenate([k, np.nextafter(k, np.float32(-1.0)),
                           np.nextafter(k, np.float32(2.0)),
                           np.float32([-0.5, 1.5])]).astype(np.float32)


@pytest.mark.parametrize("tf,_", GRID)
def test_bake_texture_is_bit_exact(tf, _):
    got = bake_texture(**_tf(*tf))
    want = j_bake(**_tf(*tf))
    assert got.dtype == np.uint8 and got.shape == (256, 256, 4)
    np.testing.assert_array_equal(got, want)


def test_sample_texture_matches_jax_at_texel_boundaries():
    tex = j_bake(**_tf(0.086, 1.0, 0.1, 0.3))
    x = _near_boundaries()
    ii, gg = np.meshgrid(x, x)
    want = np.asarray(j_sample(jnp.asarray(tex), jnp.asarray(ii),
                               jnp.asarray(gg)))
    got = sample_texture(torch.tensor(tex), torch.tensor(ii),
                         torch.tensor(gg)).numpy()
    np.testing.assert_array_equal(got, want)
    # 0 and 1: the first texel and, clamped to the edge, the last.
    t = torch.tensor(j_bake(**_tf(0.0, 1.0, 0.0, 0.0)))
    a = sample_texture(t, torch.tensor([0.0, 0.5, 1.0]),
                       torch.zeros(3))[..., 3]
    np.testing.assert_array_equal(a.numpy(), np.float32([0.0, 128 / 255.0,
                                                         1.0]))


def _jax_kernel_alpha(intensity, gradient, imin, iinv, gmin, ginv,
                      use_gradient):
    """The JAX brick kernel's texture-TF lines
    (vkvolume_tpu/render/sweep_bricks.py:456-484), op by op."""
    f = jnp.float32
    ii = jnp.clip(jnp.floor(intensity * 256.0), 0.0, 255.0)
    a_tf = jnp.clip((ii * f(1.0 / 255.0) - imin) * iinv, 0.0, 1.0)
    if use_gradient:
        gi = jnp.clip(jnp.floor(gradient * 256.0), 0.0, 255.0)
        a_g = jnp.clip((gi * f(1.0 / 255.0) - gmin) * ginv, 0.0, 1.0)
        a_tf = a_tf * a_g
    return jnp.floor(jnp.clip(a_tf * 255.0, 0.0, 255.0)) * f(1.0 / 255.0)


def _port_alpha(tf, intensity, gradient):
    a = texel_alpha(intensity, tf.intensity_min, tf.intensity_range_inv)
    if tf.use_gradient:
        a = a * texel_alpha(gradient, tf.gradient_min,
                            tf.gradient_range_inv)
    return truncate_alpha(a)


@pytest.mark.parametrize("tf,_", GRID)
def test_kernel_quantisation_matches_jax_kernel(tf, _):
    """Bit-exact, exhaustively near every texel boundary of both axes.
    Each operation rounds on its own (the CUDA kernel is built with
    -fmad=false). XLA's CPU compiler, compiling the same lines in a jit,
    fuses some multiply-adds; that moves the result by at most one u8
    level (1/255), at a few per cent of these points at most."""
    t = tf_params(**_tf(*tf))
    x = _near_boundaries()
    ii, gg = np.meshgrid(x, x)
    args = (t.intensity_min, t.intensity_range_inv, t.gradient_min,
            t.gradient_range_inv, t.use_gradient)
    want = np.asarray(_jax_kernel_alpha(jnp.asarray(ii), jnp.asarray(gg),
                                        *(np.float32(a) for a in args[:4]),
                                        args[4]))
    got = _port_alpha(t, torch.tensor(ii), torch.tensor(gg)).numpy()
    np.testing.assert_array_equal(got, want)
    fused = np.asarray(jax.jit(_jax_kernel_alpha, static_argnums=6)(
        jnp.asarray(ii), jnp.asarray(gg),
        *(np.float32(a) for a in args[:4]), args[4]))
    d = np.abs(fused - got)
    assert d.max() <= np.float32(1.0 / 255.0) * 1.0001
    assert (d > 0).mean() < 0.02


@pytest.mark.parametrize("tf,level_flips", GRID)
def test_kernel_quantisation_against_baked_lookup(tf, level_flips):
    """The quantised closed form against ``sample_texture(bake_texture())``
    at every texel centre: equal up to one ulp, except the pinned texels
    where the reciprocal of 255 and the division by 255 truncate to
    adjacent u8 levels (the kernel's one level higher)."""
    t = tf_params(**_tf(*tf))
    x = torch.tensor((np.arange(256) + 0.5) / 256.0, dtype=torch.float32)
    gg, ii = torch.meshgrid(x, x, indexing="ij")
    got = _port_alpha(t, ii, gg)
    look = sample_texture(torch.tensor(bake_texture(**_tf(*tf))), ii,
                          gg)[..., 3]
    levels = (torch.round(got * 255.0) - torch.round(look * 255.0)).to(
        torch.int64)
    assert int(levels.min()) >= 0 and int(levels.max()) <= 1
    assert int((levels != 0).sum()) == level_flips
    same = levels == 0
    ulp = float(np.spacing(np.float32(1.0)))
    assert float((got - look)[same].abs().max()) <= ulp / 2
    assert float(got.max()) > 0.5                        # real range
