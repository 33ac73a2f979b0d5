"""A bare uncompressed RAF of a 2-D CFA mosaic (header, white-balance and
size records, big-endian 16-bit samples), through the frozen copy of the
port's writer (``yardstick/raw/raf.py``). It carries no levels and no
matrix: the decoder reads black 0, white the mosaic's largest sample and
the identity matrix (the configuration's ``assumed.levels``)."""

from __future__ import annotations

import numpy as np

from bench_torch.yardstick.scene import scene

NAME = "DSCF{:04d}.RAF"


def base(rng, h: int, w: int, cfg: dict) -> np.ndarray:
    """The (h, w) mosaic: ``scene()`` at the configuration's bits."""
    return scene(rng, h, w, (1 << int(cfg["bits"])) - 1)


def write(path: str, mosaic, cfg: dict, device) -> None:
    from bench_torch.yardstick.raw import raf

    with open(path, "wb") as f:
        f.write(raf.write_raf(mosaic, model=cfg["camera"]["model"],
                              wb_grbg=tuple(cfg["wb_grbg"])))


def frame(mosaic, cfg: dict):
    """The file's mosaic with the white balance it carries, black 0, the
    largest sample as white, the identity matrix and the CFA pattern."""
    from bench_torch.yardstick.reference import Frame

    return Frame(mosaic, _wb_of_grbg(cfg["wb_grbg"]),
                 np.eye(3, dtype=np.float32), float(mosaic.max()), 0.0,
                 pattern=cfg["cfa"])


def _wb_of_grbg(grbg) -> np.ndarray:
    """RGB gains of a RAF's G R B G record, green-normalised as the
    decoder normalises them."""
    g, r, b, _ = (float(v) for v in grbg)
    return np.array([r / g, 1.0, b / g], np.float32)
