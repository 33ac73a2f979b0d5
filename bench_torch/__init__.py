"""The benchmark of the PyTorch/CUDA port (``raweditor_tpu_torch``).

``python -m bench_torch.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line; ``python -m bench_torch.rehearse`` runs every cell at a
tiny frame on the CPU. See ``bench_torch/README.md``."""
