"""Batched develop of same-shape mosaics.

``pack_params`` folds a list of per-image edits into the (N, 24) scalar
table of the fused kernel (``ops/fused_develop.fused_batch_develop_rgba``);
``batch_develop_rgba`` is the plain parity lane over a batch, with
``_maybe_ycbcr`` turning its words into JPEG planes.
"""

from __future__ import annotations

import numpy as np
import torch

from raweditor_tpu_torch.ops.develop import develop_rgba
from raweditor_tpu_torch.ops.fused_develop import fold_scalars


def _levels(n: int, white_levels, black_levels):
    whites = (np.full(n, 4096.0, np.float32) if white_levels is None
              else np.asarray(white_levels, np.float32).reshape(n))
    blacks = (np.zeros(n, np.float32) if black_levels is None
              else np.asarray(black_levels, np.float32).reshape(n))
    return whites, blacks


def pack_params(params_list, wbs, cam_matrices, white_levels=None,
                black_levels=None, matrix_transpose: bool = True):
    """(N, 24) f32 CPU table of folded scalars, one row per image;
    ``wbs`` (N, 3), ``cam_matrices`` (N, 3, 3), levels (N,) or None for
    the parity defaults (4096, 0)."""
    n = len(params_list)
    wbs = np.asarray(wbs, np.float32).reshape(n, 3)
    cms = np.asarray(cam_matrices, np.float32).reshape(n, 3, 3)
    whites, blacks = _levels(n, white_levels, black_levels)
    return torch.stack([
        fold_scalars(p, wbs[i], cms[i], whites[i], blacks[i],
                     matrix_transpose)
        for i, p in enumerate(params_list)])


def _maybe_ycbcr(words: torch.Tensor, output: str):
    """Words unchanged for "rgba_words", else JPEG planes."""
    if output == "rgba_words":
        return words
    from raweditor_tpu_torch.ops.jpeg import (rgba_words_to_ycbcr420,
                                              rgba_words_to_ycbcr444)

    if output == "ycbcr420":
        return rgba_words_to_ycbcr420(words)
    if output == "ycbcr444":
        return rgba_words_to_ycbcr444(words)
    raise ValueError(f"unknown output {output!r}")


def batch_develop_rgba(mosaics: torch.Tensor, params_list, wbs,
                       cam_matrices, white_levels=None, black_levels=None,
                       matrix_transpose: bool = True, cfa_phase=(0, 0),
                       transfer: str = "gamma22",
                       demosaic_method: str = "nearest",
                       output: str = "rgba_words"):
    """The parity lane over a batch: (N, H, W) u16 to (N, H, W) u32, or
    JPEG planes (see ``_maybe_ycbcr``)."""
    n = mosaics.shape[0]
    wbs = np.asarray(wbs, np.float32).reshape(n, 3)
    cms = np.asarray(cam_matrices, np.float32).reshape(n, 3, 3)
    whites, blacks = _levels(n, white_levels, black_levels)
    words = torch.stack([
        develop_rgba(mosaics[i], p, wbs[i], cms[i],
                     white_level=float(whites[i]),
                     black_level=float(blacks[i]),
                     demosaic_method=demosaic_method,
                     matrix_transpose=matrix_transpose, transfer=transfer,
                     cfa_phase=cfa_phase)
        for i, p in enumerate(params_list)])
    return _maybe_ycbcr(words, output)
