"""A LinearRaw DNG (photometric 34892: three 16-bit samples a pixel,
already demosaiced) in one uncompressed strip, through the frozen copy of
the port's writer (``yardstick/raw/synth.write_synthetic_linear_dng``),
with the configuration's levels and as-shot neutral. The writer writes no
colour matrix, so the decoder reads the identity (the configuration's
``xyz_to_cam_x10000``), and its own make and model (``camera``)."""

from __future__ import annotations

import numpy as np

from bench_torch.yardstick.scene import scene

NAME = "DSC_{:04d}.dng"


def base(rng, h: int, w: int, cfg: dict) -> np.ndarray:
    """The (h, w, 3) u16 image: one ``scene()`` at the configuration's
    bits a channel, drawn in turn from ``rng``."""
    top = (1 << int(cfg["bits"])) - 1
    return np.stack([scene(rng, h, w, top) for _ in range(3)], axis=-1)


def write(path: str, image, cfg: dict, device) -> None:
    from bench_torch.yardstick.raw import synth

    synth.write_synthetic_linear_dng(
        path, image, bpp=int(cfg["bits"]), compression=cfg["compression"],
        wb_neutral=tuple(cfg["wb_neutral"]),
        black_level=int(cfg["black_level"]),
        white_level=int(cfg["white_level"]), uncorrelated_preview=True)


def frame(image, cfg: dict):
    """The file's (H, W, 3) samples with the levels, matrix and as-shot
    neutral it carries; no CFA."""
    from bench_torch.yardstick.reference import Frame

    return Frame(image, 1.0 / np.asarray(cfg["wb_neutral"], np.float32),
                 np.array(cfg["xyz_to_cam_x10000"], np.float32) / 10000.0,
                 cfg["white_level"], cfg["black_level"])
