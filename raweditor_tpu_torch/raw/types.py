"""Decoded RAW frame container: the fields of the JAX package's
``RawImage`` that the develop engine reads.

The port does not decode RAW files yet; a caller hands the engine an
already-decoded frame (a u16 Bayer mosaic plus its colour metadata).
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
    white_level: float = 4096.0
    cfa_pattern: str = "RGGB"  # effective storage-space CFA phase
    orientation: int = 1  # TIFF tag 274

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
