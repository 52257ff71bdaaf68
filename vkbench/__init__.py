"""The benchmark of vkvolume_tpu_torch: see README.md and BENCHMARK.json."""
