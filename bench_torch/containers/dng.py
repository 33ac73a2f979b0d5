"""A DNG of a 2-D CFA mosaic, through the frozen copy of the port's
writer (``yardstick/raw/synth.py``), with the configuration's levels,
matrix, as-shot neutral, CFA and, if it states them, tiles. Lossless-JPEG
tiles are entropy-coded for the writer in one pass on the device first
(``yardstick/native.prepare_tiles``): the writer's own per-tile NumPy
packing takes some 2 s a 24 MP file."""

from __future__ import annotations

import numpy as np

from bench_torch.yardstick.scene import scene

NAME = "DSC_{:04d}.dng"
# A 16x16 grey JFIF (4:2:0, quality 90) for the embedded preview, which
# no check reads; the writer would otherwise render one with PIL.
PREVIEW_JPEG = bytes.fromhex(
    "ffd8ffe000104a46494600010100000100010000ffdb0043000302020302020303030304"
    "030304050805050404050a070706080c0a0c0c0b0a0b0b0d0e12100d0e110e0b0b101610"
    "1113141515150c0f171816141812141514ffdb00430103040405040509050509140d0b0d"
    "141414141414141414141414141414141414141414141414141414141414141414141414"
    "1414141414141414141414141414ffc00011080010001003012200021101031101ffc400"
    "1f0000010501010101010100000000000000000102030405060708090a0bffc400b51000"
    "02010303020403050504040000017d010203000411051221314106135161072271143281"
    "91a1082342b1c11552d1f02433627282090a161718191a25262728292a3435363738393a"
    "434445464748494a535455565758595a636465666768696a737475767778797a83848586"
    "8788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9faffc400"
    "1f0100030101010101010101010000000000000102030405060708090a0bffc400b51100"
    "020102040403040705040400010277000102031104052131061241510761711322328108"
    "144291a1b1c109233352f0156272d10a162434e125f11718191a262728292a3536373839"
    "3a434445464748494a535455565758595a636465666768696a737475767778797a828384"
    "85868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4"
    "c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9faffda00"
    "0c03010002110311003f0028a28a00ffd9")


def matrix(cfg: dict) -> np.ndarray:
    """The configuration's XYZ-to-camera matrix (dcraw's ``adobe_coeff``
    integers over 10000, in f32 as ``chip_smoke.py:259-263`` makes it)."""
    return np.array(cfg["xyz_to_cam_x10000"], np.float32) / 10000.0


def base(rng, h: int, w: int, cfg: dict) -> np.ndarray:
    """The (h, w) mosaic: ``scene()`` at the configuration's bits."""
    return scene(rng, h, w, (1 << int(cfg["bits"])) - 1)


def write(path: str, mosaic, cfg: dict, device) -> None:
    from bench_torch.yardstick import native
    from bench_torch.yardstick.raw import ljpeg, synth

    tile = cfg.get("tile_size")
    if tile is not None and cfg["compression"] == "ljpeg":
        # The tables ``ljpeg.encode_lossless`` hands the packer.
        code_tab = np.zeros(17, np.uint64)
        clen_tab = np.zeros(17, np.int32)
        codes = ljpeg._canonical_codes([0] + ljpeg._ENC_BITS[1:],
                                       ljpeg._ENC_VALUES)
        for s, (code, length) in codes.items():
            code_tab[s], clen_tab[s] = code, length
        native.prepare_tiles(mosaic, tuple(tile), int(cfg["bits"]),
                             code_tab, clen_tab, 15, device)
    synth.write_synthetic_raw(
        path, mosaic, bpp=int(cfg["bits"]), compression=cfg["compression"],
        wb_neutral=tuple(cfg["wb_neutral"]), xyz_to_cam=matrix(cfg),
        black_level=int(cfg["black_level"]),
        white_level=int(cfg["white_level"]), make=cfg["camera"]["make"],
        model=cfg["camera"]["model"], preview_jpeg=PREVIEW_JPEG,
        cfa=cfg["cfa"], tile_size=None if tile is None else tuple(tile))


def frame(mosaic, cfg: dict):
    """The file's mosaic with the levels, matrix and as-shot neutral it
    carries, and its Bayer phase."""
    from bench_torch.yardstick.reference import Frame

    return Frame(mosaic, 1.0 / np.asarray(cfg["wb_neutral"], np.float32),
                 matrix(cfg), cfg["white_level"], cfg["black_level"],
                 phase=_bayer_phase(cfg["cfa"]))


def _bayer_phase(cfa: str):
    """(row, column) of the red site in a 2x2 Bayer pattern."""
    i = cfa.index("R")
    return (i // 2, i % 2)
