"""Transfer function: the closed-form 2D (intensity × gradient) grayscale TF.

Port of ``vkvolume_tpu/tf/transfer_function.py`` (shaders/transfer_function.glsl
:40-43). ``TFParams`` holds plain Python floats, each the float32 value the
JAX package derives (``tf_params``), so a TF slider edit costs no device
transfer and no sync: kernels take the floats as launch arguments and torch
ops take them as scalars. The baked-texture TF (``bake_texture`` /
``sample_texture``) is not ported yet.
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
