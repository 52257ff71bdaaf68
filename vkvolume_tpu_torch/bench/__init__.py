from .datasets import DATASETS, BenchDataset, synthesize
from .harness import (CSV_COLUMNS, BenchResult, benchmark_camera,
                      make_engine, run_config, run_sweep, stage_breakdown)

__all__ = [
    "DATASETS",
    "BenchDataset",
    "synthesize",
    "CSV_COLUMNS",
    "BenchResult",
    "benchmark_camera",
    "make_engine",
    "run_config",
    "run_sweep",
    "stage_breakdown",
]
