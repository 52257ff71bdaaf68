from .ray_setup import (FrameUniforms, RaySetup, RenderOutput, make_rays,
                        make_uniforms, transpose_for_axis)

__all__ = [
    "FrameUniforms",
    "RaySetup",
    "RenderOutput",
    "make_rays",
    "make_uniforms",
    "transpose_for_axis",
]
