from .transfer_function import TFParams, get_alpha, tf_params

__all__ = ["TFParams", "get_alpha", "tf_params"]
