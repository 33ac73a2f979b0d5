"""The fused develop kernels: Bayer demosaic, folded edit stack,
transfer and quantisation in one pass over the u16 mosaic, with packed
RGBA words or JPEG YCbCr 4:2:0 planes as output.

Port of the TPU kernel ``raweditor_tpu/ops/pallas_develop.py``
(``pallas_develop_rgba`` / ``pallas_batch_develop_rgba`` on a Bayer
mosaic). ``demosaic`` picks the stencil, as the TPU kernel's argument of
that name does:

- ``"nearest"`` (the parity stencil), ``"bilinear"`` and ``"malvar"``
  run ``csrc/develop.cu`` (one thread per 2x2 quad; the TPU kernel's
  ``_develop_block`` and ``_demosaic_smooth_taps``);
- ``"grad"`` runs ``csrc/develop_grad.cu`` (one block per tile, the
  stages staged in shared memory; ``_demosaic_grad_window``).

Both are CUDA C++ for sm_90a, built by ``ops/_build.py``. Beside them:

- ``fold_scalars``: the edit stack folded into 24 f32 constants per
  image (``_fold_scalars``): WB, temperature/tint and exposure into the
  3x3 matrix, black level into one scale plus an offset vector, contrast
  and levels into one affine. Folding reassociates the float math, so
  this lane differs from the parity chain (``ops/develop.py``) by up to
  1 LSB;
- ``develop_rgba_folded_plain``: the kernels' math in plain PyTorch ops.
  It demosaics ``raw * scale`` before the black offset is added, in the
  kernels' factored sums, so it rounds differently from the XLA-lane
  demosaics of ``ops/demosaic.py`` by up to 1 ulp before quantisation.
  The wrappers run it for CPU tensors; the card comparisons hold the
  kernels against it;
- ``LAUNCHES``: how many times each kernel was launched, one key per
  output and demosaic (``develop_rgba``, ``develop_ycbcr420`` for
  nearest; ``develop_rgba_malvar``, ``develop_ycbcr420_grad``, ...).

For a CUDA tensor the wrappers launch the kernel or raise; nothing falls
back to the plain version there.
"""

from __future__ import annotations

import numpy as np
import torch

from raweditor_tpu_torch.color import (GAMMA22_POLY, INV_22, INV_24,
                                       SRGB_CUT, SRGB_POLY, horner)
from raweditor_tpu_torch.ops.demosaic import (demosaic_nearest,
                                              parity_masks)
from raweditor_tpu_torch.ops.develop import LUMA, pack_rgba, u16_to_f32
from raweditor_tpu_torch.ops.jpeg import quantize_u8, rgb_to_ycbcr
from raweditor_tpu_torch.params import EditParams

N_SCALARS = 24
GAMMAS = {"pow": 0, "poly": 1, "srgb": 2, "srgb_poly": 3}
OUTPUTS = {"rgba": 0, "ycbcr420": 1}
# The stencil ids of csrc/develop.cu; "grad" has its own kernel.
DEMOSAICS = {"nearest": 0, "bilinear": 1, "malvar": 2, "grad": 3}


def launch_key(output: str, demosaic: str) -> str:
    """The ``LAUNCHES`` key of one kernel variant."""
    base = "develop_" + output
    return base if demosaic == "nearest" else f"{base}_{demosaic}"


# Launch counts: each wrapper adds one where it launches its kernel.
LAUNCHES = {launch_key(o, d): 0 for o in OUTPUTS for d in DEMOSAICS}


def _poly255(coeffs):
    """The polynomial scaled by 255 with the quantiser's +0.5 folded into
    the constant term, as f32 (the kernel holds the same literals)."""
    scaled = [float(c) * 255.0 for c in coeffs[:-1]]
    scaled.append(float(coeffs[-1]) * 255.0 + 0.5)
    return tuple(np.float32(k) for k in scaled)


GAMMA_POLY255 = _poly255(GAMMA22_POLY)
SRGB_POLY255 = _poly255(SRGB_POLY)
SRGB_LIN255 = float(np.float32(12.92 * 255.0))


def fold_scalars(params: EditParams, wb, cam_matrix, white_level=4096.0,
                 black_level=0.0, matrix_transpose: bool = True):
    """The (24,) f32 folded-scalar vector of one image, on the CPU, in
    the operation order of the TPU kernel's ``_fold_scalars``."""
    f32 = torch.float32

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    p = {n: t(float(getattr(params, n))) for n in (
        "exposure", "contrast", "highlights", "shadows", "whites",
        "blacks", "vibrance", "saturation", "temperature", "tint")}
    m = t(cam_matrix).reshape(3, 3)
    if matrix_transpose:
        m = m.T
    gains = t(wb).reshape(3) * torch.stack([
        1.0 + p["temperature"] * 0.3,
        1.0 + p["tint"] * 0.3,
        1.0 - p["temperature"] * 0.3,
    ])
    m = m * gains[None, :] * torch.exp2(p["exposure"])
    black = t(black_level)
    s = 1.0 / (t(white_level) - black)
    b = -black * s
    c0 = m @ torch.full((3,), float(b), dtype=f32)
    cf = 1.0 + p["contrast"] / 100.0
    inv = 1.0 / (p["whites"] - p["blacks"] + 1e-4)
    a = cf * inv
    bb = ((0.5 - 0.5 * cf) - p["blacks"]) * inv
    return torch.cat([
        m.reshape(-1),                          # 0..8 folded matrix
        c0,                                     # 9..11 black offset
        torch.stack([
            s,                                  # 12 norm scale
            a, bb,                              # 13, 14 contrast+levels
            p["highlights"], p["shadows"],      # 15, 16
            1.0 + p["saturation"] / 100.0,      # 17
            p["vibrance"],                      # 18
            -b,                                 # 19 black*s
            1.0 + p["shadows"],                 # 20 shadows tone affine
        ]),
        torch.zeros(N_SCALARS - 21, dtype=f32),
    ]).contiguous()


def scalars_from_numpy(arr) -> torch.Tensor:
    """An (N, 24) f32 numpy table (e.g. the JAX ``_fold_scalars`` of N
    images) as a contiguous CPU tensor."""
    a = np.ascontiguousarray(arr, dtype=np.float32)
    if a.ndim != 2 or a.shape[1] != N_SCALARS:
        raise ValueError(f"expected (N, {N_SCALARS}) scalars, got {a.shape}")
    return torch.from_numpy(a.copy())


def _quantize(c, gamma: str):
    """Transfer, clamp at 255.5 in the x255 domain, floor (f32)."""
    c = torch.clamp_min(c, 0.0)
    if gamma == "poly":
        v = horner(torch.sqrt(torch.sqrt(torch.clamp_max(c, 1.0))),
                   GAMMA_POLY255)
    elif gamma == "srgb":
        c = torch.clamp_max(c, 1.0)
        hi = torch.pow(c, INV_24) * float(np.float32(1.055)) - float(
            np.float32(0.055))
        v = torch.where(c <= SRGB_CUT, c * float(np.float32(12.92)),
                        hi) * 255.0 + 0.5
    elif gamma == "srgb_poly":
        c = torch.clamp_max(c, 1.0)
        acc = horner(torch.sqrt(torch.sqrt(c)), SRGB_POLY255)
        v = torch.where(c <= SRGB_CUT, c * SRGB_LIN255 + 0.5, acc)
    else:
        v = torch.pow(c, INV_22) * 255.0 + 0.5
    return torch.floor(torch.clamp_max(v, 255.5))


def _shift(a: torch.Tensor, dim: int, d: int) -> torch.Tensor:
    """The value ``d`` places along ``dim``, clamped at the true edge."""
    n = a.shape[dim]
    idx = torch.clamp(torch.arange(n, device=a.device) + d, 0, n - 1)
    return a.index_select(dim, idx)


def _up(a):
    return _shift(a, -2, -1)


def _dn(a):
    return _shift(a, -2, 1)


def _lf(a):
    return _shift(a, -1, -1)


def _rt(a):
    return _shift(a, -1, 1)


def _smooth_taps_plain(v, phase, method: str, floor):
    """Bilinear or Malvar-He-Cutler on ``raw * scale`` in the kernel's
    factored sums (``_demosaic_smooth_taps``); Malvar is floored at
    ``floor``, the folded black level sc[19]."""
    h, w = v.shape[-2:]
    u, d, l, r = _up(v), _dn(v), _lf(v), _rt(v)
    hsum = l + r
    vsum = u + d
    diag4 = (_lf(u) + _rt(u)) + (_lf(d) + _rt(d))
    ye, xe = parity_masks(h, w, phase, v.device)
    if method == "bilinear":
        hm = hsum * 0.5
        vm = vsum * 0.5
        pm = (hsum + vsum) * 0.25
        dm = diag4 * 0.25
        return (torch.where(ye, torch.where(xe, v, hm),
                            torch.where(xe, vm, dm)),
                torch.where(ye == xe, pm, v),
                torch.where(ye, torch.where(xe, dm, vm),
                            torch.where(xe, hm, v)))
    h2 = _shift(v, -1, -2) + _shift(v, -1, 2)
    v2 = _shift(v, -2, -2) + _shift(v, -2, 2)
    s2 = h2 + v2
    gc = v * 0.5 + (hsum + vsum) * 0.25 - s2 * 0.125
    kr = v * 0.625 + hsum * 0.5 - (h2 + diag4) * 0.125 + v2 * 0.0625
    kc = v * 0.625 + vsum * 0.5 - (v2 + diag4) * 0.125 + h2 * 0.0625
    kd = v * 0.75 + diag4 * 0.25 - s2 * 0.1875
    r = torch.where(ye, torch.where(xe, v, kr), torch.where(xe, kc, kd))
    g = torch.where(ye == xe, gc, v)
    b = torch.where(ye, torch.where(xe, kd, kc), torch.where(xe, kr, v))
    return tuple(torch.maximum(c, floor) for c in (r, g, b))


def _tent3(x):
    """Normalised 3x3 tent: column pass, then row pass, then /16."""
    xv = (_up(x) + x * 2.0) + _dn(x)
    return ((_lf(xv) + xv * 2.0) + _rt(xv)) * 0.0625


def _grad_plain(v, phase):
    """The gradient-weighted Bayer demosaic on ``raw * scale`` in the
    kernel's operation order (``_demosaic_grad_window``): every stage
    clamps its neighbour reads at the true image edge."""
    h, w = v.shape[-2:]
    ye, xe = parity_masks(h, w, phase, v.device)
    at_g = ye != xe
    at_r = ye & xe
    at_b = ~ye & ~xe
    u, d, l, r = _up(v), _dn(v), _lf(v), _rt(v)
    eps = float(np.float32(1e-4))
    wh = 1.0 / (torch.abs(r - l) + eps)
    wv = 1.0 / (torch.abs(d - u) + eps)
    g = torch.where(at_g, v, (wh * ((l + r) * 0.5) + wv * ((u + d) * 0.5))
                    / (wh + wv))
    diff = v - g
    du, dd = _up(diff), _dn(diff)
    hpair = (_lf(diff) + _rt(diff)) * 0.5
    vpair = (du + dd) * 0.5
    diag = ((_lf(du) + _lf(dd)) + (_rt(du) + _rt(dd))) * 0.25
    rpl = torch.where(ye, torch.where(xe, v, g + hpair),
                      torch.where(xe, g + vpair, g + diag))
    bpl = torch.where(ye, torch.where(xe, g + diag, g + vpair),
                      torch.where(xe, g + hpair, v))
    gpl = g
    for _ in range(2):
        cb = _tent3(rpl - gpl)
        cr = _tent3(bpl - gpl)
        gpl = torch.where(at_g, v, torch.where(at_r, v - cb, v - cr))
        rpl = torch.where(at_r, v, gpl + cb)
        bpl = torch.where(at_b, v, gpl + cr)
    return rpl, gpl, bpl


def develop_rgba_folded_plain(mosaics: torch.Tensor, scal: torch.Tensor,
                              cfa_phase=(0, 0), gamma: str = "pow",
                              output: str = "rgba",
                              demosaic: str = "nearest"):
    """The kernels' math in plain PyTorch ops, on any device.

    mosaics (N, H, W) u16, scal (N, 24) f32. Returns (N, H, W) u32 RGBA
    words, or for ``output="ycbcr420"`` (Y (N, H, W) u8, CbCr
    (N, H/2, W) u8 with Cb at even and Cr at odd columns)."""
    sc = scal.to(torch.float32)[:, :, None, None]
    v = u16_to_f32(mosaics) * sc[:, 12]
    if demosaic == "nearest":
        r, g, b = demosaic_nearest(v, cfa_phase)
    elif demosaic == "grad":
        r, g, b = _grad_plain(v, cfa_phase)
    else:
        r, g, b = _smooth_taps_plain(v, cfa_phase, demosaic, sc[:, 19])
    r, g, b = (sc[:, 0] * r + sc[:, 1] * g + sc[:, 2] * b + sc[:, 9],
               sc[:, 3] * r + sc[:, 4] * g + sc[:, 5] * b + sc[:, 10],
               sc[:, 6] * r + sc[:, 7] * g + sc[:, 8] * b + sc[:, 11])
    lum = LUMA[0] * r + LUMA[1] * g + LUMA[2] * b
    tone = (1.0 + lum * sc[:, 15]) * (sc[:, 20] - lum * sc[:, 16]) * sc[:, 13]
    r, g, b = r * tone + sc[:, 14], g * tone + sc[:, 14], b * tone + sc[:, 14]
    luma = LUMA[0] * r + LUMA[1] * g + LUMA[2] * b
    spread = torch.maximum(r, torch.maximum(g, b)) - torch.minimum(
        r, torch.minimum(g, b))
    sf = sc[:, 17]
    f = sf * (1.0 + sc[:, 18] * (1.0 - spread * torch.abs(sf)))
    rq, gq, bq = (_quantize(luma + (c - luma) * f, gamma) for c in (r, g, b))
    if output == "rgba":
        return pack_rgba(rq, gq, bq)
    return emit_ycbcr420(rq, gq, bq)


def emit_ycbcr420(rq, gq, bq):
    """The kernels' JPEG 4:2:0 emission (``store_quad<true>`` in
    ``csrc/develop_common.cuh``) from quantised f32 (N, H, W) planes:
    Y (N, H, W) u8 and NV12-interleaved CbCr (N, H/2, W) u8, the chroma
    box summed over the row pair, then the column pair."""
    y, cb, cr = rgb_to_ycbcr(rq, gq, bq)

    def box(p):
        return ((p[..., 0::2, 0::2] + p[..., 1::2, 0::2])
                + (p[..., 0::2, 1::2] + p[..., 1::2, 1::2])) * 0.25

    n, h, w = rq.shape
    cbcr = torch.stack([quantize_u8(box(cb)), quantize_u8(box(cr))],
                       dim=-1).reshape(n, h // 2, w)
    return quantize_u8(y), cbcr


def _check_inputs(mosaics, scal, cfa_phase, gamma, output, demosaic):
    if not isinstance(mosaics, torch.Tensor) or mosaics.dtype != torch.uint16:
        raise TypeError("mosaics must be a torch.uint16 tensor")
    if mosaics.dim() != 3 or 0 in mosaics.shape:
        raise ValueError(f"mosaics must be (N, H, W), got {tuple(mosaics.shape)}")
    n, h, w = mosaics.shape
    if not isinstance(scal, torch.Tensor) or scal.dtype != torch.float32:
        raise TypeError("scalars must be a torch.float32 tensor")
    if tuple(scal.shape) != (n, N_SCALARS):
        raise ValueError(
            f"scalars must be ({n}, {N_SCALARS}), got {tuple(scal.shape)}")
    if scal.device != mosaics.device:
        raise ValueError("mosaics and scalars must be on one device")
    if not (mosaics.is_contiguous() and scal.is_contiguous()):
        raise ValueError("mosaics and scalars must be contiguous")
    if gamma not in GAMMAS:
        raise ValueError(f"unknown gamma {gamma!r}")
    if output not in OUTPUTS:
        raise ValueError(f"unknown output {output!r}")
    if demosaic not in DEMOSAICS:
        raise ValueError(f"unknown demosaic {demosaic!r}")
    if output == "ycbcr420" and (h % 2 or w % 2):
        raise ValueError("ycbcr420 output requires even H and W")
    if tuple(cfa_phase) not in ((0, 0), (0, 1), (1, 0), (1, 1)):
        raise ValueError(f"bad Bayer phase {cfa_phase!r}")


def fused_batch_develop_rgba(mosaics: torch.Tensor, scal: torch.Tensor,
                             cfa_phase=(0, 0), gamma: str = "pow",
                             output: str = "rgba",
                             demosaic: str = "nearest"):
    """Batched fused develop with per-image folded scalars.

    mosaics (N, H, W) u16 and scal (N, 24) f32, contiguous, on one
    device. ``gamma`` is the transfer lane ("pow", "poly", "srgb",
    "srgb_poly"); ``demosaic`` the Bayer stencil ("nearest", "bilinear",
    "malvar", "grad"). Returns (N, H, W) u32 RGBA words, or for
    ``output="ycbcr420"`` (even H and W) the Y (N, H, W) u8 and
    NV12-interleaved CbCr (N, H/2, W) u8 planes. CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    _check_inputs(mosaics, scal, cfa_phase, gamma, output, demosaic)
    dev = mosaics.device
    if dev.type == "cpu":
        return develop_rgba_folded_plain(mosaics, scal, cfa_phase, gamma,
                                         output, demosaic)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from raweditor_tpu_torch.ops import _build

    lib = _build.load()
    n, h, w = mosaics.shape
    with torch.cuda.device(dev):
        if output == "rgba":
            out0 = torch.empty((n, h, w), dtype=torch.uint32, device=dev)
            out1 = None
        else:
            out0 = torch.empty((n, h, w), dtype=torch.uint8, device=dev)
            out1 = torch.empty((n, h // 2, w), dtype=torch.uint8, device=dev)
        args = (mosaics.data_ptr(), scal.data_ptr(), out0.data_ptr(),
                None if out1 is None else out1.data_ptr(), n, h, w,
                int(cfa_phase[0]), int(cfa_phase[1]), GAMMAS[gamma],
                OUTPUTS[output])
        stream = torch.cuda.current_stream(dev).cuda_stream
        if demosaic == "grad":
            code = lib.rtt_develop_grad_launch(*args, stream)
        else:
            code = lib.rtt_develop_launch(*args, DEMOSAICS[demosaic], stream)
    _build.check(lib, code, f"develop kernel ({output}, {gamma}, {demosaic})")
    LAUNCHES[launch_key(output, demosaic)] += 1
    return out0 if output == "rgba" else (out0, out1)


def fused_develop_rgba(mosaic: torch.Tensor, scal: torch.Tensor,
                       cfa_phase=(0, 0), gamma: str = "pow",
                       demosaic: str = "nearest"):
    """Single-image fused develop: (H, W) u16 and (24,) f32 scalars to
    (H, W) u32 RGBA words."""
    if mosaic.dim() != 2:
        raise ValueError(f"mosaic must be (H, W), got {tuple(mosaic.shape)}")
    return fused_batch_develop_rgba(mosaic[None], scal.reshape(1, N_SCALARS),
                                    cfa_phase, gamma, demosaic=demosaic)[0]
