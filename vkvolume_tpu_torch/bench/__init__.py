from .datasets import DATASETS, BenchDataset, synthesize, write_reference_format
from .harness import (CSV_COLUMNS, BenchResult, benchmark_camera,
                      make_engine, run_config, run_sweep, stage_breakdown)

__all__ = [
    "DATASETS",
    "BenchDataset",
    "synthesize",
    "write_reference_format",
    "CSV_COLUMNS",
    "BenchResult",
    "benchmark_camera",
    "make_engine",
    "run_config",
    "run_sweep",
    "stage_breakdown",
]
