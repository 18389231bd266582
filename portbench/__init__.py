"""Benchmark of stlpose_tpu_torch on one NVIDIA H100: see BENCHMARK.json and run.py."""
