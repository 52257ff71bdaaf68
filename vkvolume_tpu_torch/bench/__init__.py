from .datasets import DATASETS, BenchDataset, synthesize
from .harness import benchmark_camera, make_engine

__all__ = [
    "DATASETS",
    "BenchDataset",
    "synthesize",
    "benchmark_camera",
    "make_engine",
]
