"""Frozen copies (see ``bench_torch/yardstick/COPIES.json``)."""
