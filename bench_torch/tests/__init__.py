"""Tests of the benchmark itself (run: ``python -m pytest bench_torch/tests``)."""
