from .engine import Engine, UpdateStats
from ..options import RenderOptions, SkippingType, Test, VolumeOptions
from .volume import Volume, from_array

__all__ = [
    "Engine",
    "UpdateStats",
    "RenderOptions",
    "SkippingType",
    "Test",
    "VolumeOptions",
    "Volume",
    "from_array",
]
