"""Transfer function: the closed-form 2D (intensity × gradient) grayscale TF
and the baked 256×256 RGBA8 texture path.

Port of ``vkvolume_tpu/tf/transfer_function.py`` (shaders/transfer_function.glsl
:35-46). ``TFParams`` holds plain Python floats, each the float32 value the
JAX package derives (``tf_params``), so a TF slider edit costs no device
transfer and no sync: kernels take the floats as launch arguments and torch
ops take them as scalars. ``bake_texture`` is the host bake of the texture
(src/volume_component.cpp:246-261), ``sample_texture`` its NEAREST lookup,
and ``texel_alpha`` / ``truncate_alpha`` the closed form at the quantised
texel that the brick sweep (K1) evaluates in place of the lookup.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _f32(x: float) -> float:
    """Round a Python float to the nearest float32, kept as a Python float
    (exact in any float32 torch op)."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class TFParams:
    sampling_factor: float
    voxel_alpha_factor: float
    grad_magnitude_modifier: float
    intensity_min: float
    intensity_range_inv: float
    gradient_min: float
    gradient_range_inv: float
    use_gradient: bool = True


def tf_params(
    *,
    intensity_min: float = 0.0,
    intensity_max: float = 1.0,
    gradient_min: float = 0.0,
    gradient_max: float = 1.0,
    sampling_factor: float = 1.0,
    voxel_alpha_factor: float = 1.0,
    grad_magnitude_modifier: float = 1.0,
) -> TFParams:
    """TFParams from slider options, with the JAX package's float32
    derivation (``Volume::get_transfer_function_uniform``,
    src/volume_component.cpp:226-240)."""
    g_range = gradient_max - gradient_min
    return TFParams(
        sampling_factor=_f32(sampling_factor),
        voxel_alpha_factor=_f32(voxel_alpha_factor),
        grad_magnitude_modifier=_f32(grad_magnitude_modifier),
        intensity_min=_f32(intensity_min),
        intensity_range_inv=_f32(1.0 / (intensity_max - intensity_min)),
        gradient_min=_f32(gradient_min),
        # 1/(gmax-gmin) is inf when equal; it is never used then
        # (use_gradient gates the gradient term), so keep it finite.
        gradient_range_inv=_f32(1.0 / g_range if g_range != 0.0 else 1.0),
        use_gradient=gradient_max != gradient_min,
    )


def get_alpha(tf: TFParams, intensity: torch.Tensor,
              gradient: torch.Tensor | None) -> torch.Tensor:
    """Closed-form alpha (shaders/transfer_function.glsl:40-43)."""
    alpha_i = ((intensity - tf.intensity_min)
               * tf.intensity_range_inv).clamp(0.0, 1.0)
    if not tf.use_gradient:
        return alpha_i
    alpha_g = ((gradient - tf.gradient_min)
               * tf.gradient_range_inv).clamp(0.0, 1.0)
    return alpha_i * alpha_g


def get_color(tf: TFParams, intensity: torch.Tensor,
              gradient: torch.Tensor | None) -> torch.Tensor:
    """The closed-form colour ``vec4(alpha)``: ``get_alpha`` in all four
    channels, (..., 4)."""
    a = get_alpha(tf, intensity, gradient)
    return torch.stack((a, a, a, a), -1)


def bake_texture(
    *,
    intensity_min: float,
    intensity_max: float,
    gradient_min: float,
    gradient_max: float,
) -> np.ndarray:
    """CPU bake of the 256×256 RGBA8 TF texture
    (``Volume::update_transfer_function_texture``,
    src/volume_component.cpp:246-261).

    Layout: tex[g, i] (gradient row-major, the reference's
    ``idx = g*256 + i`` fill order); all 4 channels hold the same alpha.
    """
    i = np.arange(256, dtype=np.float32)
    g = np.arange(256, dtype=np.float32)
    i_inv = np.float32(1.0 / (intensity_max - intensity_min))
    use_gradient = gradient_max != gradient_min
    alpha_i = np.clip((i / 255.0 - intensity_min) * i_inv, 0.0, 1.0)
    if use_gradient:
        g_inv = np.float32(1.0 / (gradient_max - gradient_min))
        alpha_g = np.clip((g / 255.0 - gradient_min) * g_inv, 0.0, 1.0)
    else:
        alpha_g = np.ones(256, dtype=np.float32)
    # static_cast<uint8_t> truncates (src/volume_component.cpp:259).
    alpha = np.clip(alpha_g[:, None] * alpha_i[None, :] * 255.0, 0.0,
                    255.0).astype(np.uint8)
    return np.repeat(alpha[..., None], 4, axis=-1)


def sample_texture(tex: torch.Tensor, intensity: torch.Tensor,
                   gradient: torch.Tensor) -> torch.Tensor:
    """Texture-path TF lookup (shaders/transfer_function.glsl:36-38):
    ``texture(transfer_function, vec2(intensity, gradient))`` with a
    NEAREST sampler and CLAMP_TO_EDGE, texel = clamp(floor(u * 256), 0,
    255). ``tex``: the (256, 256, 4) u8 texture on the samples' device.
    Returns float rgba in [0, 1], shape ``intensity.shape + (4,)``."""
    size = tex.shape[0]

    def texel(u):
        return torch.floor(u * float(size)).clamp(0, size - 1).to(
            torch.int64)

    return tex[texel(gradient), texel(intensity)].to(torch.float32) / 255.0


_INV255 = float(np.float32(1.0 / 255.0))


def texel_alpha(x: torch.Tensor, lo: float, inv: float) -> torch.Tensor:
    """One axis of the baked texture's alpha at the texel NEAREST takes
    for ``x``, as the brick sweep computes it in place of the lookup
    (``vkvolume_tpu/render/sweep_bricks.py:456-477``): the closed form
    at the quantised texel, clip((clip(floor(x·256), 0, 255)·(1/255) -
    lo)·inv, 0, 1), with the float32 reciprocal of 255."""
    t = torch.floor(x * 256.0).clamp(0.0, 255.0)
    return ((t * _INV255 - lo) * inv).clamp(0.0, 1.0)


def truncate_alpha(a: torch.Tensor) -> torch.Tensor:
    """The bake's u8 truncation of an alpha (``static_cast<uint8_t>``,
    src/volume_component.cpp:259): floor(clip(a·255, 0, 255))·(1/255)."""
    return torch.floor((a * 255.0).clamp(0.0, 255.0)) * _INV255
