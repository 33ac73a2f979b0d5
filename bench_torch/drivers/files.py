"""The cell's RAW files, made from the seed by the frozen writers.

A configuration file (``bench_torch/configs/<name>.json``) states the
camera: frame size, sample depth, CFA, levels, colour matrix, white
balance and container. ``write_files`` takes the writer module of that
container (``bench_torch/containers/<container>.py``, by name through
``core.container_of``), renders its seeded base image at the
configuration's size and writes ``n`` files from it, each rolled by
(97 i, 211 i) pixels as ``chip_smoke.py:731-747`` rolls its catalog, on
threads. It returns each file's path with the frame the decoder must read
back from it, as the container module describes it."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from bench_torch import core

ROLL = (97, 211)  # pixels a file is rolled by, per index (rows, columns)


def shape(cfg: dict, rehearsal: dict):
    """(height, width): the configuration's, or under a rehearsal, the
    rehearsal's frame for it; a rehearsal that has none for it is
    refused, so that it never writes a full-size frame."""
    if "frame" not in rehearsal:
        return (cfg["height"], cfg["width"])
    if cfg["name"] not in rehearsal["frame"]:
        raise KeyError(f"the rehearsal has no frame for configuration "
                       f"{cfg['name']!r}")
    return tuple(rehearsal["frame"][cfg["name"]])


def write_files(cfg: dict, folder, n: int, rng, rehearsal: dict, device,
                threads: int = 8):
    """Write ``n`` files of the configuration into ``folder``, packing on
    ``device``; returns [(path, frame)] in file order."""
    from bench_torch.yardstick import native

    container = core.container_of(cfg)
    h, w = shape(cfg, rehearsal)
    base = container.base(rng, h, w, cfg)
    os.makedirs(folder, exist_ok=True)
    images = [np.roll(base, (ROLL[0] * i, ROLL[1] * i), axis=(0, 1))
              for i in range(n)]
    paths = [os.path.join(folder, container.NAME.format(i + 1))
             for i in range(n)]
    try:
        with ThreadPoolExecutor(max(1, min(threads, n))) as pool:
            list(pool.map(container.write, paths, images, [cfg] * n,
                          [device] * n))
    finally:
        native.forget()  # the streams a writer packed ahead
    return [(p, container.frame(m, cfg)) for p, m in zip(paths, images)]
