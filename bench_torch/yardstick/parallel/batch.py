"""Batched develop of same-shape mosaics.

``pack_params`` folds a list of per-image edits into the (N, 24) scalar
table of the fused kernel (``ops/fused_develop.fused_batch_develop_rgba``);
``pack_extras`` builds the (N, 38) amount table and the static flags of
the finish-extras kernel (``ops/fused_extras.fused_finish_extras_rgba``).
The kernel route of a batch with extras is
``fused_batch_develop_rgba(..., output="rgba")`` then
``fused_finish_extras_rgba(..., output="ycbcr420")``, as the JAX
exporter's ``_extras_post_batch`` runs it. ``batch_develop_rgba`` is the
plain lane over a batch (per-image extras in the chain, per-image point
curves), with ``_maybe_ycbcr`` turning its words into JPEG planes;
``batch_develop`` is the same lane to (N, H, W, 3) u8;
``batch_develop_xtrans_rgba`` is the RGBA lane over X-Trans (generic-CFA)
mosaics; ``batch_develop_u16`` is the 16-bit lane over Bayer or X-Trans
mosaics, the exporter's ``bits=16`` flush (the JAX exporter vmaps
``develop_u16`` and ``develop_xtrans(bits=16)``);
``batch_develop_linear_rgba`` is the RGBA lane over already-demosaiced
LinearRaw frames (N, H, W, 3) u16.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_torch.yardstick.ops.develop import (develop, develop_linear,
                                             develop_rgba, develop_u16,
                                             develop_xtrans)
from bench_torch.yardstick.ops.fused_develop import fold_scalars
from bench_torch.yardstick.ops.fused_extras import pack_extras

__all__ = ["batch_develop", "batch_develop_linear_rgba",
           "batch_develop_rgba", "batch_develop_u16",
           "batch_develop_xtrans_rgba", "pack_extras", "pack_params"]


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
    from bench_torch.yardstick.ops.jpeg import (rgba_words_to_ycbcr420,
                                              rgba_words_to_ycbcr444)

    if output == "ycbcr420":
        return rgba_words_to_ycbcr420(words)
    if output == "ycbcr444":
        return rgba_words_to_ycbcr444(words)
    raise ValueError(f"unknown output {output!r}")


def _per_image(fn, mosaics, params_list, wbs, cam_matrices, white_levels,
               black_levels, **kw):
    """``fn`` over each image of the batch with its own edit, WB,
    matrix and levels, stacked."""
    n = mosaics.shape[0]
    wbs = np.asarray(wbs, np.float32).reshape(n, 3)
    cms = np.asarray(cam_matrices, np.float32).reshape(n, 3, 3)
    whites, blacks = _levels(n, white_levels, black_levels)
    return torch.stack([
        fn(mosaics[i], p, wbs[i], cms[i], white_level=float(whites[i]),
           black_level=float(blacks[i]), **kw)
        for i, p in enumerate(params_list)])


def batch_develop(mosaics: torch.Tensor, params_list, wbs, cam_matrices,
                  white_levels=None, black_levels=None,
                  matrix_transpose: bool = True, cfa_phase=(0, 0),
                  transfer: str = "gamma22",
                  demosaic_method: str = "nearest", extras=False):
    """The plain lane over a batch to u8: (N, H, W) u16 to
    (N, H, W, 3) u8; the arguments as in ``batch_develop_rgba``."""
    return _per_image(develop, mosaics, params_list, wbs, cam_matrices,
                      white_levels, black_levels,
                      demosaic_method=demosaic_method,
                      matrix_transpose=matrix_transpose, transfer=transfer,
                      cfa_phase=cfa_phase, extras=extras)


def batch_develop_rgba(mosaics: torch.Tensor, params_list, wbs,
                       cam_matrices, white_levels=None, black_levels=None,
                       matrix_transpose: bool = True, cfa_phase=(0, 0),
                       transfer: str = "gamma22",
                       demosaic_method: str = "nearest",
                       output: str = "rgba_words", extras=False):
    """The plain lane over a batch: (N, H, W) u16 to (N, H, W) u32, or
    JPEG planes (see ``_maybe_ycbcr``). ``extras`` is the batch's static
    finish-extras mode (the JAX ``extras`` argument): every image runs
    the same stages with its own amounts; each image's point curve
    applies."""
    words = _per_image(develop_rgba, mosaics, params_list, wbs, cam_matrices,
                       white_levels, black_levels,
                       demosaic_method=demosaic_method,
                       matrix_transpose=matrix_transpose, transfer=transfer,
                       cfa_phase=cfa_phase, extras=extras)
    return _maybe_ycbcr(words, output)


def batch_develop_xtrans_rgba(mosaics: torch.Tensor, params_list, wbs,
                              cam_matrices, white_levels=None,
                              black_levels=None, pattern: str = None,
                              matrix_transpose: bool = False,
                              transfer: str = "gamma22",
                              demosaic_method: str = "nearest",
                              output: str = "rgba_words", extras=False):
    """The plain lane over a batch of X-Trans (generic-CFA) mosaics:
    (N, H, W) u16 to (N, H, W) u32, or JPEG planes; ``output`` and
    ``extras`` as in ``batch_develop_rgba``."""
    words = _per_image(develop_xtrans, mosaics, params_list, wbs,
                       cam_matrices, white_levels, black_levels,
                       pattern=pattern, matrix_transpose=matrix_transpose,
                       transfer=transfer, rgba=True,
                       demosaic_method=demosaic_method, extras=extras)
    return _maybe_ycbcr(words, output)


def batch_develop_linear_rgba(frames: torch.Tensor, params_list, wbs,
                              cam_matrices, white_levels=None,
                              black_levels=None,
                              matrix_transpose: bool = False,
                              transfer: str = "gamma22",
                              output: str = "rgba_words", extras=False):
    """The plain lane over a batch of LinearRaw frames: (N, H, W, 3) u16
    to (N, H, W) u32, or JPEG planes; ``output`` and ``extras`` as in
    ``batch_develop_rgba``."""
    words = _per_image(develop_linear, frames, params_list, wbs,
                       cam_matrices, white_levels, black_levels,
                       matrix_transpose=matrix_transpose, transfer=transfer,
                       rgba=True, extras=extras)
    return _maybe_ycbcr(words, output)


def batch_develop_u16(mosaics: torch.Tensor, params_list, wbs, cam_matrices,
                      white_levels=None, black_levels=None,
                      matrix_transpose: bool = True, cfa_phase=(0, 0),
                      pattern: str = None, transfer: str = "gamma22",
                      demosaic_method: str = "nearest", extras=False,
                      linear: bool = False):
    """The 16-bit plain lane over a batch: (N, H, W) u16 to
    (N, H, W, 3) u16, each image with its own edit, WB, matrix and
    levels. A ``pattern`` develops X-Trans (generic-CFA) mosaics with
    ``develop_xtrans(bits=16)`` and its ``demosaic_method`` ("nearest",
    "smooth", "grad"), else Bayer ones at ``cfa_phase`` with
    ``develop_u16``; with ``linear`` they are LinearRaw frames
    (N, H, W, 3) u16 and develop with ``develop_linear(bits=16)``.
    ``extras`` is the batch's static finish-extras mode, run in the chain
    (the words post-pass is 8-bit)."""
    if linear:
        return _per_image(develop_linear, mosaics, params_list, wbs,
                          cam_matrices, white_levels, black_levels,
                          matrix_transpose=matrix_transpose,
                          transfer=transfer, bits=16, extras=extras)
    if pattern is not None:
        return _per_image(develop_xtrans, mosaics, params_list, wbs,
                          cam_matrices, white_levels, black_levels,
                          pattern=pattern, matrix_transpose=matrix_transpose,
                          transfer=transfer, bits=16,
                          demosaic_method=demosaic_method, extras=extras)
    return _per_image(develop_u16, mosaics, params_list, wbs, cam_matrices,
                      white_levels, black_levels,
                      demosaic_method=demosaic_method,
                      matrix_transpose=matrix_transpose, transfer=transfer,
                      cfa_phase=cfa_phase, extras=extras)
