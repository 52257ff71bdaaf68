from .transfer_function import (TFParams, bake_texture, get_alpha, get_color,
                                sample_texture, tf_params)

__all__ = ["TFParams", "bake_texture", "get_alpha", "get_color",
           "sample_texture", "tf_params"]
