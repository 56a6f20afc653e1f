"""The benchmark of fvens_tpu_torch (see BENCHMARK.json and PERF.md)."""
