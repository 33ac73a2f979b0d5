"""Colour science: camera RGB to linear sRGB, and the transfer curves.

The matrix builders are numpy (host, once per image). The transfer
curves run on torch tensors in f32 with the same operation order as the
JAX package's, so the parity lane can match it bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

# IEC 61966-2-1:1999 XYZ(D65) to linear sRGB.
XYZ_TO_SRGB = np.array(
    [
        [3.2406, -1.5372, -0.4986],
        [-0.9689, 1.8758, 0.0415],
        [0.0557, -0.2040, 1.0570],
    ],
    dtype=np.float32,
)
SRGB_TO_XYZ = np.linalg.inv(XYZ_TO_SRGB.astype(np.float64)).astype(np.float32)

_IDENTITY = np.eye(3, dtype=np.float32)


def is_identity_matrix(matrix, epsilon: float = 0.001) -> bool:
    m = np.asarray(matrix, dtype=np.float32).reshape(3, 3)
    return bool(np.all(np.abs(m - _IDENTITY) < epsilon))


def _cam_matrix_body(m: np.ndarray, rgb_to_xyz: np.ndarray,
                     fallback: np.ndarray) -> np.ndarray:
    """dcraw-style cam to linear-RGB: normalise the rows of
    ``xyz_to_cam @ rgb_to_xyz`` to sum to 1, invert, and fall back on
    identity, degenerate or wild metadata."""
    if is_identity_matrix(m):
        return fallback.copy()
    # RAW metadata often stores the matrix scaled by 10000.
    if np.any(np.abs(m) > 10.0):
        m = m / 10000.0
    cam_from_rgb = m @ np.asarray(rgb_to_xyz, np.float64)
    row_sums = cam_from_rgb.sum(axis=1, keepdims=True)
    if np.any(np.abs(row_sums) < 1e-8):
        return fallback.copy()
    cam_from_rgb = cam_from_rgb / row_sums
    try:
        out = np.linalg.inv(cam_from_rgb).astype(np.float32)
    except np.linalg.LinAlgError:
        return fallback.copy()
    if not np.all(np.isfinite(out)) or np.any(np.abs(out) > 10.0):
        return fallback.copy()
    return out


def cam_to_srgb_matrix(xyz_to_cam, mode: str = "parity") -> np.ndarray:
    """(3, 3) f32 camera-RGB to linear-sRGB matrix. ``"parity"`` is the
    identity of the reference editor; ``"accurate"`` the real
    conversion."""
    m = np.asarray(xyz_to_cam, dtype=np.float64).reshape(3, 3)
    if mode == "parity":
        return _IDENTITY.copy()
    if mode != "accurate":
        raise ValueError(f"unknown mode: {mode!r}")
    return _cam_matrix_body(m, SRGB_TO_XYZ.astype(np.float64), _IDENTITY)


# Degree-6 fit of s^(20/11) on [0, 1] with s = c^(1/4): poly(s) is c^(1/2.2)
# to u8 accuracy. Highest power first. Equal to the JAX package's table.
GAMMA22_POLY = (
    np.float32(2.2354132056e-01), np.float32(-7.9758619051e-01),
    np.float32(1.1776782855e+00), np.float32(-1.0106607578e+00),
    np.float32(1.3829966404e+00), np.float32(2.4274709515e-02),
    np.float32(-1.7121618430e-04),
)
# The sRGB pow branch 1.055*c^(1/2.4) - 0.055 as a degree-6 polynomial in
# s = c^(1/4); u8 accuracy only. Equal to the JAX package's table.
SRGB_POLY = (
    np.float32(6.3174404204e-02), np.float32(-2.9830396175e-01),
    np.float32(6.2492650747e-01), np.float32(-8.2647812366e-01),
    np.float32(1.3542464972e+00), np.float32(1.4221395552e-01),
    np.float32(-5.9776868671e-02),
)

# f32 exponents and the sRGB linear-segment cut, as Python floats.
INV_22 = float(np.float32(1.0 / 2.2))
INV_24 = float(np.float32(1.0 / 2.4))
SRGB_CUT = float(np.float32(0.0031308))


def horner(s, coeffs):
    """``coeffs`` (highest power first) evaluated at ``s``, one
    multiply and one add per step."""
    acc = s * float(coeffs[0]) + float(coeffs[1])
    for k in coeffs[2:]:
        acc = acc * s + float(k)
    return acc


def gamma22_encode(x: torch.Tensor) -> torch.Tensor:
    """Plain 1/2.2 power law, negatives clamped to 0 before the pow."""
    return torch.pow(torch.clamp_min(x, 0.0), INV_22)


def gamma22_poly_encode(x: torch.Tensor) -> torch.Tensor:
    """``poly(sqrt(sqrt(clip(x, 0, 1))))``: within 1 LSB of
    :func:`gamma22_encode` after u8 quantisation."""
    s = torch.sqrt(torch.sqrt(torch.clamp(x, 0.0, 1.0)))
    return horner(s, GAMMA22_POLY)


def srgb_encode(x: torch.Tensor) -> torch.Tensor:
    """IEC 61966-2-1 forward transfer (linear to sRGB)."""
    x = torch.clamp(x, 0.0, 1.0)
    lo = x * float(np.float32(12.92))
    hi = torch.pow(x, INV_24) * float(np.float32(1.055)) - float(
        np.float32(0.055))
    return torch.where(x <= SRGB_CUT, lo, hi)


def srgb_poly_encode(x: torch.Tensor) -> torch.Tensor:
    """Exact linear segment plus ``poly(sqrt(sqrt(x)))`` for the pow
    branch; within 1 LSB of :func:`srgb_encode` after u8 quantisation."""
    x = torch.clamp(x, 0.0, 1.0)
    s = torch.sqrt(torch.sqrt(x))
    return torch.where(x <= SRGB_CUT, x * float(np.float32(12.92)),
                       horner(s, SRGB_POLY))


# Transfer name to the fused kernel's gamma lane ("pow" is exact 1/2.2).
KERNEL_GAMMA_BY_TRANSFER = {
    "gamma22": "pow",
    "gamma22_poly": "poly",
    "srgb": "srgb",
    "srgb_poly": "srgb_poly",
}


def kernel_gamma_for(transfer: str) -> str:
    try:
        return KERNEL_GAMMA_BY_TRANSFER[transfer]
    except KeyError:
        raise ValueError(f"unknown transfer {transfer!r}") from None


def encoder_for(transfer: str):
    """The encode callable for a transfer name."""
    if transfer == "gamma_adobe":
        raise NotImplementedError("not ported yet: the Adobe RGB transfer")
    try:
        return {
            "gamma22": gamma22_encode,
            "gamma22_poly": gamma22_poly_encode,
            "srgb": srgb_encode,
            "srgb_poly": srgb_poly_encode,
        }[transfer]
    except KeyError:
        raise ValueError(f"unknown transfer {transfer!r}") from None
