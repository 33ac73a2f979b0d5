"""Colour science: camera RGB to a linear output space, and the
transfer curves.

The matrix builders are numpy (host, once per image). The output spaces
are sRGB and, in accurate mode, the wide gamuts Display P3 and Adobe RGB
(1998) (``cam_to_output_matrix``); ``icc.py`` builds their profiles from
the same chromaticities. The transfer curves run on torch tensors in f32
with the same operation order as the JAX package's, so the parity lane
can match it bit for bit; ``srgb_decode`` also takes a numpy array, as
``icc.py`` builds its curve table with it.
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


def srgb_decode(x):
    """IEC 61966-2-1 inverse transfer (sRGB to linear). A torch tensor
    stays f32; a numpy array (``icc.py``'s 1024-entry table, float64) is
    computed as the JAX package's numpy branch computes it, with f32
    constants."""
    if isinstance(x, torch.Tensor):
        x = torch.clamp(x, 0.0, 1.0)
        lo = x / float(np.float32(12.92))
        hi = torch.pow((x + float(np.float32(0.055)))
                       / float(np.float32(1.055)), float(np.float32(2.4)))
        return torch.where(x <= float(np.float32(0.04045)), lo, hi)
    x = np.clip(x, 0.0, 1.0)
    lo = x / np.float32(12.92)
    hi = np.power((x + np.float32(0.055)) / np.float32(1.055),
                  np.float32(2.4))
    return np.where(x <= np.float32(0.04045), lo, hi)


# Transfer name to the fused kernel's gamma lane ("pow" is exact 1/2.2).
# The Adobe RGB transfer has no lane: it takes the plain develop.
KERNEL_GAMMA_BY_TRANSFER = {
    "gamma22": "pow",
    "gamma22_poly": "poly",
    "srgb": "srgb",
    "srgb_poly": "srgb_poly",
}
# The polynomial transfers are fit to u8 accuracy (about 6 LSB of u16):
# 16-bit output demotes them to the exact curve.
TRANSFER16_BY_TRANSFER = {
    "gamma22_poly": "gamma22",
    "srgb_poly": "srgb",
}


def kernel_gamma_for(transfer: str):
    """The develop kernels' gamma lane of a transfer, or None for a
    transfer they do not compute (``gamma_adobe``); an unknown name
    raises ``ValueError``."""
    encoder_for(transfer)
    return KERNEL_GAMMA_BY_TRANSFER.get(transfer)


def transfer16_for(transfer: str) -> str:
    return TRANSFER16_BY_TRANSFER.get(transfer, transfer)


def encoder_for(transfer: str):
    """The encode callable for a transfer name."""
    try:
        return {
            "gamma22": gamma22_encode,
            "gamma22_poly": gamma22_poly_encode,
            "srgb": srgb_encode,
            "srgb_poly": srgb_poly_encode,
            "gamma_adobe": adobe_gamma_encode,
        }[transfer]
    except KeyError:
        raise ValueError(f"unknown transfer {transfer!r}") from None


# ---------------------------------------------------------------------------
# Wide-gamut output spaces (accurate mode): the dcraw-style derivation with
# the target's RGB-to-XYZ matrix in place of sRGB's.
# ---------------------------------------------------------------------------


def _rgb_to_xyz_from_chromaticities(primaries_xy, white_xy):
    """RGB-to-XYZ (rows X, Y, Z) from primary and white chromaticities:
    the primary columns scaled so that RGB (1, 1, 1) lands on the white
    point with Y = 1."""
    def xyz(x, y):
        return np.array([x / y, 1.0, (1.0 - x - y) / y], np.float64)

    prim = np.stack([xyz(x, y) for x, y in primaries_xy], axis=1)
    white = xyz(*white_xy)
    scale = np.linalg.solve(prim, white)
    return prim * scale[None, :]


_D65_XY = (0.3127, 0.3290)
# Display P3 (SMPTE EG 432-1 primaries, D65, sRGB transfer).
DISPLAY_P3_TO_XYZ = _rgb_to_xyz_from_chromaticities(
    ((0.680, 0.320), (0.265, 0.690), (0.150, 0.060)), _D65_XY)
# Adobe RGB (1998): 2.19921875 (= 563/256) gamma.
ADOBE_RGB_TO_XYZ = _rgb_to_xyz_from_chromaticities(
    ((0.640, 0.330), (0.210, 0.710), (0.150, 0.060)), _D65_XY)

COLOR_SPACES = ("srgb", "display-p3", "adobe-rgb")
# The transfer each wide space mandates ("srgb" keeps the caller's).
TRANSFER_BY_SPACE = {"display-p3": "srgb", "adobe-rgb": "gamma_adobe"}

_RGB_TO_XYZ_BY_SPACE = {
    "display-p3": DISPLAY_P3_TO_XYZ,
    "adobe-rgb": ADOBE_RGB_TO_XYZ,
}

ADOBE_GAMMA = 563.0 / 256.0  # Adobe RGB (1998), exactly 2.19921875
INV_ADOBE = float(np.float32(1.0 / ADOBE_GAMMA))


def adobe_gamma_encode(x):
    """Adobe RGB (1998) forward transfer x^(256/563), negatives clamped
    to 0 before the pow; a numpy array is computed as the JAX package's
    numpy branch computes it."""
    if isinstance(x, torch.Tensor):
        return torch.pow(torch.clamp_min(x, 0.0), INV_ADOBE)
    return np.power(np.maximum(x, 0.0), np.float32(1.0 / ADOBE_GAMMA))


def cam_to_output_matrix(xyz_to_cam, mode: str = "parity",
                         color_space: str = "srgb") -> np.ndarray:
    """(3, 3) f32 camera-RGB to linear-output matrix for any supported
    space: ``cam_to_srgb_matrix`` with the target's RGB-to-XYZ swapped
    in. Parity is sRGB only (``ValueError`` otherwise). Identity or
    broken metadata means the pixels are effectively sRGB, so the
    fallback is the sRGB-to-target bridge, not the identity."""
    if color_space in (None, "srgb"):
        return cam_to_srgb_matrix(xyz_to_cam, mode=mode)
    if color_space not in _RGB_TO_XYZ_BY_SPACE:
        raise ValueError(
            f"unknown color space {color_space!r}; expected one of "
            f"{COLOR_SPACES}")
    if mode != "accurate":
        raise ValueError(
            "wide-gamut output requires mode='accurate' (parity is "
            "defined as the reference's sRGB bytes)")
    m = np.asarray(xyz_to_cam, dtype=np.float64).reshape(3, 3)
    bridge = (np.linalg.inv(_RGB_TO_XYZ_BY_SPACE[color_space])
              @ SRGB_TO_XYZ.astype(np.float64)).astype(np.float32)
    return _cam_matrix_body(m, _RGB_TO_XYZ_BY_SPACE[color_space], bridge)
