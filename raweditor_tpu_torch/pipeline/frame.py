"""A frame's CFA kind and its develop route, decided once for the develop
engine (``pipeline/engine.py``) and the batch exporter
(``pipeline/export.py``).

``classify(raw, mode)`` turns a decoded frame into its ``FrameKind`` (a
Bayer phase, the 6x6 X-Trans grid, or a LinearRaw frame) and the white
and black levels the develop normalises by, with the JAX engine's rules.
``kernel_route`` says whether a develop takes the fused kernel or the
plain lane."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from raweditor_tpu_torch.color import KERNEL_GAMMA_BY_TRANSFER
from raweditor_tpu_torch.ops.cfa_generic import generic_cfa_method, is_xtrans
from raweditor_tpu_torch.ops.demosaic import phase_of
from raweditor_tpu_torch.params import EditParams
from raweditor_tpu_torch.raw.types import RawImage


@dataclasses.dataclass(frozen=True)
class FrameKind:
    """A frame's CFA kind: the Bayer phase (``(0, 0)`` for the others),
    the X-Trans pattern or None, and whether it is a LinearRaw frame
    (DNG photometric 34892, already demosaiced). Hashable: the exporter
    buckets frames by it."""

    cfa_phase: Tuple[int, int] = (0, 0)
    xtrans_pattern: Optional[str] = None
    linear: bool = False

    def demosaic(self, method: str) -> str:
        """The tier ``method`` maps to on this frame: an X-Trans frame's
        generic-CFA tier (``generic_cfa_method``), else ``method``."""
        return (method if self.xtrans_pattern is None
                else generic_cfa_method(method))


def classify(raw: RawImage, mode: str) -> Tuple[FrameKind, float, float]:
    """``(kind, white_level, black_level)`` of ``raw`` in ``mode``.

    Parity mode takes the reference's hardcoded 4096 and RGGB stencil
    (gpu/shaders.rs:110-125) and ignores an X-Trans pattern; a LinearRaw
    frame still skips the demosaic. Accurate mode takes the frame's
    levels and pattern; one that is neither a Bayer phase nor a 36-letter
    grid raises the JAX engine's ``ValueError`` (``ops/demosaic.phase_of``)."""
    if mode == "parity":
        return FrameKind(linear=raw.is_linear), 4096.0, 0.0
    if raw.is_linear:
        kind = FrameKind(linear=True)
    elif is_xtrans(raw.cfa_pattern):
        kind = FrameKind(xtrans_pattern=raw.cfa_pattern)
    else:
        kind = FrameKind(cfa_phase=phase_of(raw.cfa_pattern))
    return kind, float(raw.white_level), float(raw.black_level)


def kernel_route(use_kernel: bool, kind: FrameKind, transfer: str,
                 params: EditParams) -> bool:
    """Whether a develop runs a fused kernel: ``use_kernel``, a mosaic
    (not a LinearRaw frame), no point curve and a transfer the kernels
    compute. A LinearRaw frame, a point curve and the Adobe RGB transfer
    take the plain lane (which computes them) even with ``use_kernel``;
    the develop kernels never do."""
    return (use_kernel and not kind.linear and not params.point_curve
            and transfer in KERNEL_GAMMA_BY_TRANSFER)
