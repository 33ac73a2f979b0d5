"""Decoded RAW frame container: the fields of the JAX package's
``RawImage``, in its order.

``raw/decode.decode_raw`` builds it from a file (by keyword, so it must
accept every field the decoders pass); a caller may also hand the engine
an already-decoded frame, or carry a JAX frame across with
``RawImage.from_fields``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RawImage:
    """A decoded RAW frame on the host."""

    mosaic: np.ndarray  # (H, W) u16 Bayer mosaic; (H, W, 3) for LinearRaw
    wb_multipliers: np.ndarray  # (4,) f32 [R, G, B, G2], green-normalised
    xyz_to_cam: np.ndarray  # (3, 3) f32 row-major camera matrix
    black_level: float = 0.0
    # Optional per-CFA-site black levels (2, 2) f32 (DNG BlackLevel with
    # BlackLevelRepeatDim 2x2); black_level holds their mean.
    black_per_site: np.ndarray = None
    white_level: float = 4096.0
    cfa_pattern: str = "RGGB"  # effective storage-space CFA phase
    orientation: int = 1  # TIFF tag 274
    # True when wb_multipliers is a neutral placeholder because the
    # file's real white balance could not be parsed.
    wb_is_default: bool = False
    camera_make: str = ""
    camera_model: str = ""
    source_path: str = ""

    @classmethod
    def from_fields(cls, fields: dict) -> "RawImage":
        """A frame from a dict of its fields (numpy arrays and scalars),
        such as ``dataclasses.asdict`` of the JAX package's ``RawImage``.
        Arrays take the container's dtypes; an unknown field raises
        ``TypeError``, so nothing is dropped on the way."""
        known = {f.name for f in dataclasses.fields(cls)}
        extra = sorted(set(fields) - known)
        if extra:
            raise TypeError(f"unknown RawImage fields {extra}")
        d = dict(fields)
        d["mosaic"] = np.asarray(d["mosaic"], np.uint16)
        d["wb_multipliers"] = np.asarray(d["wb_multipliers"], np.float32)
        d["xyz_to_cam"] = np.asarray(d["xyz_to_cam"], np.float32)
        if d.get("black_per_site") is not None:
            d["black_per_site"] = np.asarray(d["black_per_site"],
                                             np.float32).reshape(2, 2)
        for k in ("black_level", "white_level"):
            if k in d:
                d[k] = float(d[k])
        return cls(**d)

    def fold_site_blacks(self) -> np.ndarray:
        """Mosaic with the per-CFA-site black deviations folded out (the
        scalar ``black_level`` mean remains to subtract downstream), in
        f32 as the JAX package computes it. Returns the mosaic unchanged
        when there is nothing to fold."""
        if (self.black_per_site is None or self.is_linear
                or np.ptp(self.black_per_site) == 0):
            return self.mosaic
        site = self.black_per_site.astype(np.float32)
        h, w = self.mosaic.shape
        delta = np.tile(site - site.mean(), (h // 2 + 1, w // 2 + 1))[:h, :w]
        return np.clip(self.mosaic.astype(np.float32) - delta, 0,
                       65535).astype(np.uint16)

    @property
    def is_linear(self) -> bool:
        """True for LinearRaw sources (already demosaiced RGB)."""
        return self.mosaic.ndim == 3

    @property
    def width(self) -> int:
        return int(self.mosaic.shape[1])

    @property
    def height(self) -> int:
        return int(self.mosaic.shape[0])

    def wb_rgb(self) -> np.ndarray:
        """(3,) RGB white-balance gains as the develop chain consumes
        them."""
        return np.asarray(self.wb_multipliers[:3], dtype=np.float32)

    @staticmethod
    def normalize_wb(coeffs) -> np.ndarray:
        """Green-normalise camera WB coefficients with the reference
        editor's fallbacks: 3-coefficient cameras reuse G for G2; a
        non-finite or non-positive G2 falls back to G; the green
        reference is floored at 0.001."""
        c = [float(x) for x in coeffs]
        if len(c) >= 4:
            r, g, b, g2 = c[0], c[1], c[2], c[3]
        elif len(c) == 3:
            r, g, b = c
            g2 = g
        else:
            r = g = b = g2 = 1.0
        g_ref = max(g, 0.001)
        if not np.isfinite(g2) or g2 <= 0.0:
            g2 = g
        return np.array([r / g_ref, g / g_ref, b / g_ref, g2 / g_ref],
                        dtype=np.float32)
