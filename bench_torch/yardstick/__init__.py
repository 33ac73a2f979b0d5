"""The benchmark's frozen yardstick: the plain PyTorch reference, the
file writers, the picture generator, the roofline arithmetic and the
profiler's busy union.

Most modules here are copies of the port's files as they stood at commit
e13d09fb7b94 with ``raweditor_tpu_torch.`` rewritten to
``bench_torch.yardstick.`` and nothing else; ``COPIES.json`` names each
copy's source ``file:line`` and the SHA-256 of the source text, and
``bench_torch/tests/test_copies.py`` holds them equal. A later change to
the program does not move them. Nothing here imports the program or JAX.
"""
