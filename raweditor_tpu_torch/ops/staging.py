"""Bit-packed host-to-device staging of mosaics.

The batch exporter (``pipeline/export.py``) stages each decoded mosaic
to the card from its decode workers. A 12-bit mosaic travels bit-packed
at 1.5 bytes a pixel (``pack12_rows``), a 14-bit one at 1.75
(``pack14_rows``); the flush fills the (B, H, W) u16 batch the develop
kernel reads from the staged buffers with ``unpack_into_batch``.

The packers are the JAX package's (``raweditor_tpu/ops/staging.py``),
through ``_rawkit`` when it is there, else numpy, with the same bytes.
``unpack_into_batch`` fills every slot of a preallocated batch from its
source (u12 or u14 packed bytes, or u16 samples copied as they are) in
one launch of a hand-written CUDA kernel for sm_90a
(``csrc/staging.cu``, built by ``ops/_build.py``). Beside it:

- ``unpack_into_batch_plain``: the kernel's function in plain PyTorch,
  ``unpack12_rows`` and ``unpack14_rows`` a slot. The wrapper runs it for
  CPU tensors; the card tests hold the kernel against it. The JAX unpack
  is an XLA elementwise pass with no Pallas kernel behind it, so the
  kernel replaces none; the unpackers' byte arithmetic runs in int32 and
  is cast to uint16 at the end, since torch on the CPU has no shifts for
  unsigned types;
- ``LAUNCHES``: the kernel's launches, ``unpack_slots``.

For a CUDA tensor the wrapper launches the kernel or raises; nothing
falls back to the plain version there.
"""

from __future__ import annotations

import numpy as np
import torch


def _check_packable(m: np.ndarray, bits: int, align: int,
                    peak=None) -> None:
    """Enforce the documented pack preconditions — out-of-range samples
    would otherwise wrap silently on the u8 assignment and reconstruct
    as different pixels on the device. ``peak`` lets a
    caller that already scanned the mosaic (the exporter picks the pack
    format from it) skip the second full-memory pass — it matters on
    single-core hosts where the decode thread shares the core."""
    if m.ndim != 2 or m.shape[1] % align:
        raise ValueError(
            f"pack{bits}_rows needs a 2-D mosaic with width % {align}"
            f" == 0, got {m.shape}")
    if peak is None:
        peak = m.max() if m.size else 0
    if int(peak) >= (1 << bits):
        raise ValueError(
            f"pack{bits}_rows: sample >= 2^{bits} would wrap")


def _native_pack(m: np.ndarray, attr: str):
    """C++ pack (GIL-released; ~15x the numpy path on 24 MP — decode
    workers keep streaming instead of serializing on a 200 ms
    GIL-held numpy pass). None if the extension is unavailable."""
    from raweditor_tpu_torch.native import get_rawkit

    rk = get_rawkit()
    if rk is None or not hasattr(rk, attr):
        return None
    h, w = m.shape
    m = np.ascontiguousarray(m, dtype=np.uint16)
    packed = getattr(rk, attr)(m, h, w)
    return np.frombuffer(packed, np.uint8).reshape(h, -1)


def pack12_rows(mosaic, peak=None):
    """Host-side: (H, W) u16 with samples < 4096 and even W → a
    (H, W//2*3) u8 buffer, two samples per three bytes. Cuts the
    host→device staging of 12-bit mosaics (the dominant sensor depth)
    by 25%; :func:`unpack12_rows` inverts it on device. ``peak``:
    optional precomputed ``mosaic.max()`` (skips the range re-scan)."""
    m = np.asarray(mosaic)
    _check_packable(m, 12, 2, peak)
    native = _native_pack(m, "pack12_rows")
    if native is not None:
        return native
    h, w = m.shape
    e = m[:, 0::2].astype(np.uint32)
    o = m[:, 1::2].astype(np.uint32)
    out = np.empty((h, w // 2, 3), np.uint8)
    out[..., 0] = e >> 4
    out[..., 1] = ((e & 0xF) << 4) | (o >> 8)
    out[..., 2] = o & 0xFF
    return out.reshape(h, -1)


def pack14_rows(mosaic, peak=None):
    """Host-side: (H, W) u16 with samples < 16384 and W % 4 == 0 →
    (H, W//4*7) u8, four samples per seven bytes (12.5% saved). Byte
    math only — the device inverse needs no 64-bit ops. ``peak`` as in
    :func:`pack12_rows`."""
    m = np.asarray(mosaic)
    _check_packable(m, 14, 4, peak)
    native = _native_pack(m, "pack14_rows")
    if native is not None:
        return native
    h, w = m.shape
    s = m.reshape(h, w // 4, 4).astype(np.uint32)
    out = np.empty((h, w // 4, 7), np.uint8)
    out[..., 0] = s[..., 0] >> 6
    out[..., 1] = ((s[..., 0] & 0x3F) << 2) | (s[..., 1] >> 12)
    out[..., 2] = (s[..., 1] >> 4) & 0xFF
    out[..., 3] = ((s[..., 1] & 0xF) << 4) | (s[..., 2] >> 10)
    out[..., 4] = (s[..., 2] >> 2) & 0xFF
    out[..., 5] = ((s[..., 2] & 0x3) << 6) | (s[..., 3] >> 8)
    out[..., 6] = s[..., 3] & 0xFF
    return out.reshape(h, -1)


def _groups(packed: torch.Tensor, size: int) -> torch.Tensor:
    """(..., H, G*size) u8 as (..., H, G, size) int32."""
    if not isinstance(packed, torch.Tensor) or packed.dtype != torch.uint8:
        raise TypeError("packed rows must be a torch.uint8 tensor")
    if packed.dim() < 2 or packed.shape[-1] % size:
        raise ValueError(f"packed rows of {size}-byte groups expected, got "
                         f"{tuple(packed.shape)}")
    return packed.reshape(packed.shape[:-1]
                          + (packed.shape[-1] // size, size)).to(torch.int32)


def _samples(parts, shape) -> torch.Tensor:
    """Stacked int32 samples, interleaved back into rows of u16."""
    return torch.stack(parts, dim=-1).reshape(shape[:-1] + (-1,)).to(
        torch.uint16)


def unpack12_rows(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack12_rows` for (..., H, W//2*3) u8 on any
    device → (..., H, W) u16."""
    t = _groups(packed, 3)
    e = (t[..., 0] << 4) | (t[..., 1] >> 4)
    o = ((t[..., 1] & 0xF) << 8) | t[..., 2]
    return _samples([e, o], packed.shape)


def unpack14_rows(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack14_rows` for (..., H, W//4*7) u8 on any
    device → (..., H, W) u16."""
    t = _groups(packed, 7)
    s0 = (t[..., 0] << 6) | (t[..., 1] >> 2)
    s1 = ((t[..., 1] & 0x3) << 12) | (t[..., 2] << 4) | (t[..., 3] >> 4)
    s2 = ((t[..., 3] & 0xF) << 10) | (t[..., 4] << 2) | (t[..., 5] >> 6)
    s3 = ((t[..., 5] & 0x3F) << 8) | t[..., 6]
    return _samples([s0, s1, s2, s3], packed.shape)


#: The sources a slot takes, as the kernel's format codes: packed u12 or
#: u14 bytes, or u16 samples.
FORMATS = {"u12": 0, "u14": 1, "u16": 2}
#: Slots one launch takes (``kMaxSlots`` in ``csrc/staging.cu``); a larger
#: batch launches once for every 64 slots.
MAX_SLOTS = 64
# Launch counts: the wrapper adds one where it launches its kernel.
LAUNCHES = {"unpack_slots": 0}
_UNPACK = {"u12": unpack12_rows, "u14": unpack14_rows}
_GROUPS = {"u12": (2, 3), "u14": (4, 7)}  # samples, bytes of a group


def _check_slots(out, sources, fmts):
    """The (slot, source, format) of every slot to fill; raises on what
    the kernel does not take."""
    if not isinstance(out, torch.Tensor) or out.dtype != torch.uint16:
        raise TypeError("the batch must be a torch.uint16 tensor")
    if out.dim() < 3 or 0 in out.shape or not out.is_contiguous():
        raise ValueError("the batch must be a contiguous (B, H, W) or "
                         f"(B, H, W, C) tensor, got {tuple(out.shape)}")
    if len(sources) != out.shape[0] or len(fmts) != out.shape[0]:
        raise ValueError(f"{out.shape[0]} slots, {len(sources)} sources "
                         f"and {len(fmts)} formats")
    frame = tuple(out.shape[1:])
    slots = []
    for i, (src, fmt) in enumerate(zip(sources, fmts)):
        if src is None:
            continue
        if fmt not in FORMATS:
            raise ValueError(f"slot {i}: unknown format {fmt!r}")
        if not isinstance(src, torch.Tensor):
            raise TypeError(f"slot {i}: the source must be a tensor")
        if src.device != out.device:
            raise ValueError(f"slot {i}: the source is on {src.device}, the "
                             f"batch on {out.device}")
        if not src.is_contiguous():
            raise ValueError(f"slot {i}: the source must be contiguous")
        if fmt == "u16":
            if src.dtype != torch.uint16:
                raise TypeError(f"slot {i}: u16 samples must be torch.uint16")
            if tuple(src.shape) != frame:
                raise ValueError(f"slot {i}: samples of {tuple(src.shape)} "
                                 f"for a slot of {frame}")
        else:
            if src.dtype != torch.uint8:
                raise TypeError(f"slot {i}: packed rows must be torch.uint8")
            per, size = _GROUPS[fmt]
            if len(frame) != 2 or frame[1] % per:
                raise ValueError(f"slot {i}: {fmt} needs a 2-D slot whose "
                                 f"width is a multiple of {per}, got {frame}")
            want = (frame[0], frame[1] // per * size)
            if tuple(src.shape) != want:
                raise ValueError(f"slot {i}: {fmt} rows of "
                                 f"{tuple(src.shape)} for a slot of {frame} "
                                 f"(want {want})")
        slots.append((i, src, fmt))
    return slots


def _fill_plain(out, slots):
    for i, src, fmt in slots:
        out[i].copy_(src if fmt == "u16" else _UNPACK[fmt](src))
    return out


def unpack_into_batch_plain(out: torch.Tensor, sources, fmts) -> torch.Tensor:
    """The kernel's function in plain PyTorch ops, on any device: slot i of
    ``out`` becomes ``unpack12_rows(sources[i])``, ``unpack14_rows(...)``
    or a copy of the u16 samples; a slot whose source is None is left as
    it is. Returns ``out``."""
    return _fill_plain(out, _check_slots(out, sources, fmts))


def unpack_into_batch(out: torch.Tensor, sources, fmts) -> torch.Tensor:
    """Fill the slots of a batch from their staged sources.

    out: the contiguous (B, H, W) u16 batch, or (B, H, W, C) for frames
    of samples only. ``sources[i]`` is slot i's source on the batch's
    device, contiguous: (H, W/2*3) u8 for ``fmts[i]`` "u12", (H, W/4*7)
    u8 for "u14", the frame's u16 samples for "u16"; or None for a slot
    the caller fills itself. Sources may alias other slots of ``out``.
    CPU tensors run the plain version; CUDA tensors launch the kernel
    (once for every 64 slots to fill) or raise. Returns ``out``."""
    slots = _check_slots(out, sources, fmts)
    if out.device.type == "cpu":
        return _fill_plain(out, slots)
    if out.device.type != "cuda":
        raise ValueError(f"unsupported device {out.device}")
    for k in range(0, len(slots), MAX_SLOTS):
        _launch(out, slots[k:k + MAX_SLOTS])
    return out


def slot_args(out, slots):
    """The kernel's C arguments but the stream, for ``slots`` (the
    ``(slot, source, format)`` that ``_check_slots`` gives) of ``out``:
    the host arrays of the sources' pointers, the slots' pointers and the
    format codes, the slot count and the samples of a slot."""
    import ctypes

    n = len(slots)
    return ((ctypes.c_void_p * n)(*(s.data_ptr() for _, s, _ in slots)),
            (ctypes.c_void_p * n)(*(out[i].data_ptr() for i, _, _ in slots)),
            (ctypes.c_int * n)(*(FORMATS[f] for _, _, f in slots)),
            n, out[0].numel())


def _launch(out, slots):
    from raweditor_tpu_torch.ops import _build

    lib = _build.load()
    with torch.cuda.device(out.device):
        code = lib.rtt_unpack_slots_launch(
            *slot_args(out, slots),
            torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(lib, code, "staging unpack kernel")
    LAUNCHES["unpack_slots"] += 1
