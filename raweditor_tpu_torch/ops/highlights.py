"""Clipped-highlight reconstruction in the mosaic domain, before the
demosaic, in plain PyTorch (the JAX package runs it in XLA, with no
Pallas kernel).

When a sensor channel clips at the white level, its value is estimated
from the unclipped channels: a clipped site of channel c with normalised
value v becomes ``max(v, mean over unclipped channels u of v_u * wb_u /
wb_c)``, the value a neutral highlight would have after white balance.
The channel neighbourhoods come from the nearest demosaic. The estimate
is raise-only, blended in by ``amount / 100``, and written back into the
u16 mosaic at the same levels (capped at 65535), so every develop route
takes the reconstructed mosaic unchanged. Unclipped sites, and every
site at amount 0, keep their original u16 values, so a batch that mixes
amounts needs no split.

Every step keeps the JAX package's f32 operation order, and ``round`` is
half to even in both, so the output equals the JAX function's bit for
bit. The batch forms take per-image amounts, WB gains and levels.
"""

from __future__ import annotations

import numpy as np
import torch

from raweditor_tpu_torch.ops.develop import u16_to_f32

#: Sites at or above this fraction of the white level count as clipped.
CLIP_FRACTION = 0.96

_F32 = torch.float32


def _site_channel_masks(h, w, cfa_phase, xtrans_pattern, device=None):
    """Boolean (H, W) masks (is_r, is_g, is_b) of each site's own channel
    for the Bayer phase, or for the X-Trans grid when a pattern is
    given."""
    if xtrans_pattern is not None:
        from raweditor_tpu_torch.ops.cfa_generic import channel_grid

        grid = torch.as_tensor(channel_grid(xtrans_pattern), device=device)
        yy = torch.arange(h, device=device) % 6
        xx = torch.arange(w, device=device) % 6
        idx = grid.index_select(0, yy).index_select(1, xx)
        return idx == 0, idx == 1, idx == 2
    py, px = cfa_phase
    ye = ((torch.arange(h, device=device)[:, None] + py) % 2) == 0
    xe = ((torch.arange(w, device=device)[None, :] + px) % 2) == 0
    is_r = ye & xe
    is_b = (~ye) & (~xe)
    return is_r, ~(is_r | is_b), is_b


def _scalars(values, shape, device):
    """f32 tensor of per-image scalars, shaped to broadcast over
    (..., H, W)."""
    t = torch.as_tensor(np.asarray(values, np.float32), device=device)
    return t.reshape(tuple(shape) + (1, 1))


def _hundredth(amount: torch.Tensor) -> torch.Tensor:
    """``amount / 100`` as a true f32 division: the divisor is a tensor
    on the amount's device (a CUDA tensor divided by a host scalar is
    multiplied by its reciprocal instead)."""
    return amount / torch.full((), 100.0, dtype=_F32, device=amount.device)


def _as_i16(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def _per_image(wb, amount, white, black, lead, dev):
    """The (r, g, b) WB gains, the amount, the black level and the level
    scale ``max(white - black, 1)`` as f32 tensors that broadcast over
    (*lead, H, W); a fourth WB gain is ignored."""
    wbv = torch.as_tensor(np.asarray(wb, np.float32).reshape(
        tuple(lead) + (-1,))[..., :3], device=dev)
    wbv = [wbv[..., c].reshape(tuple(lead) + (1, 1)) for c in range(3)]
    white, black, amount = (_scalars(v, lead, dev)
                            for v in (white, black, amount))
    return wbv, amount, black, torch.clamp_min(white - black, 1.0)


def _reconstruct(mosaic, wb, amount, white, black, cfa_phase,
                 xtrans_pattern, clip):
    """The mosaic form over (..., H, W) u16; ``wb`` (..., 3) and the
    other scalars (...) per image."""
    dev = mosaic.device
    h, w = mosaic.shape[-2:]
    wbv, amount, black, scale = _per_image(
        wb, amount, white, black, mosaic.shape[:-2], dev)
    norm = (u16_to_f32(mosaic) - black) / scale

    if xtrans_pattern is not None:
        from raweditor_tpu_torch.ops.cfa_generic import demosaic_xtrans

        planes = list(demosaic_xtrans(norm, xtrans_pattern))
    else:
        from raweditor_tpu_torch.ops.demosaic import demosaic_nearest

        planes = list(demosaic_nearest(norm, cfa_phase))

    clip = float(np.float32(clip))
    clipped = [p >= clip for p in planes]
    ests, cnts = [], []
    for c in range(3):
        num = torch.zeros_like(planes[c])
        cnt = torch.zeros_like(planes[c])
        for u in range(3):
            if u == c:
                continue
            unc = ~clipped[u]
            num = num + torch.where(unc, planes[u] * wbv[u], 0.0)
            cnt = cnt + unc.to(_F32)
        ests.append(num / (torch.clamp_min(cnt, 1.0) * wbv[c]))
        cnts.append(cnt)

    is_r, _, is_b = _site_channel_masks(h, w, cfa_phase, xtrans_pattern,
                                        dev)
    est = torch.where(is_r, ests[0], torch.where(is_b, ests[2], ests[1]))
    cnt = torch.where(is_r, cnts[0], torch.where(is_b, cnts[2], cnts[1]))

    site_clip = norm >= clip
    active = site_clip & (cnt > 0)
    recon = torch.where(active, torch.maximum(norm, est), norm)
    out_norm = norm + _hundredth(amount) * (recon - norm)
    out = torch.clamp(torch.round(out_norm * scale + black), 0.0, 65535.0)
    changed = active & (amount > 0)
    # Through int32 to the u16 bit pattern in an int16 view (torch has
    # no u16 where on every backend).
    out16 = out.to(torch.int32).to(torch.int16)
    res = torch.where(changed, out16, _as_i16(mosaic))
    return res.view(torch.uint16) if mosaic.dtype == torch.uint16 else res


def _reconstruct_linear(frame, wb, amount, white, black, clip):
    """The co-sited form over (..., H, W, 3) u16."""
    wbv, amount, black, scale = _per_image(
        wb, amount, white, black, frame.shape[:-3], frame.device)
    norm = (u16_to_f32(frame) - black[..., None]) / scale[..., None]
    clip = float(np.float32(clip))
    clipped = norm >= clip
    src = _as_i16(frame)
    outs = []
    for c in range(3):
        num = torch.zeros_like(norm[..., 0])
        cnt = torch.zeros_like(norm[..., 0])
        for u in range(3):
            if u == c:
                continue
            unc = ~clipped[..., u]
            num = num + torch.where(unc, norm[..., u] * wbv[u], 0.0)
            cnt = cnt + unc.to(_F32)
        est = num / (torch.clamp_min(cnt, 1.0) * wbv[c])
        active = clipped[..., c] & (cnt > 0)
        recon = torch.where(active, torch.maximum(norm[..., c], est),
                            norm[..., c])
        out_n = norm[..., c] + _hundredth(amount) * (recon - norm[..., c])
        out = torch.clamp(torch.round(out_n * scale + black), 0.0, 65535.0)
        changed = active & (amount > 0)
        outs.append(torch.where(changed, out.to(torch.int32).to(torch.int16),
                                src[..., c]))
    res = torch.stack(outs, dim=-1)
    return res.view(torch.uint16) if frame.dtype == torch.uint16 else res


def reconstruct_mosaic_highlights(mosaic, wb, amount, white_level=4096.0,
                                  black_level=0.0, cfa_phase=(0, 0),
                                  xtrans_pattern=None, clip=CLIP_FRACTION):
    """(H, W) u16 mosaic to the u16 mosaic with sensor-clipped sites
    reconstructed; unclipped sites pass through bit-exactly. ``wb`` is
    the (3,) or (4,) green-normalised WB (a fourth gain is ignored);
    ``amount`` 0-100 blends the estimate in."""
    return _reconstruct(mosaic, wb, amount, white_level, black_level,
                        tuple(cfa_phase), xtrans_pattern, clip)


def reconstruct_linear_highlights(frame, wb, amount, white_level=4096.0,
                                  black_level=0.0, clip=CLIP_FRACTION):
    """The (H, W, 3) u16 LinearRaw variant: the same estimate per pixel,
    no demosaic (the channels are co-sited)."""
    return _reconstruct_linear(frame, wb, amount, white_level, black_level,
                               clip)


def batch_reconstruct_mosaic(mosaics, wbs, amounts, whites, blacks,
                             cfa_phase=(0, 0), xtrans_pattern=None,
                             clip=CLIP_FRACTION):
    """(N, H, W) form for the exporter with per-image ``wbs`` (N, 3),
    ``amounts``, ``whites`` and ``blacks`` (N,). Zero-amount images pass
    through bit-exactly."""
    return _reconstruct(mosaics, wbs, amounts, whites, blacks,
                        tuple(cfa_phase), xtrans_pattern, clip)


def batch_reconstruct_linear(frames, wbs, amounts, whites, blacks,
                             clip=CLIP_FRACTION):
    """(N, H, W, 3) LinearRaw form."""
    return _reconstruct_linear(frames, wbs, amounts, whites, blacks, clip)
