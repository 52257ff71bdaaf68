from . import sampling
from .marcher import march
from .ray_setup import (FrameUniforms, RaySetup, RenderOutput, make_rays,
                        make_uniforms, transpose_for_axis)

__all__ = [
    "FrameUniforms",
    "RaySetup",
    "RenderOutput",
    "make_rays",
    "make_uniforms",
    "march",
    "sampling",
    "transpose_for_axis",
]
