from .camera import (Camera, fit_distance, orbit_camera, pad_viewport,
                     perspective_camera)

__all__ = ["Camera", "fit_distance", "orbit_camera", "pad_viewport",
           "perspective_camera"]
