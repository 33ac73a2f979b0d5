"""The yardstick's stand-in for the program's ``_rawkit`` extension.

The copied writers under ``raw/`` ask ``get_rawkit()`` for a native
helper and take their NumPy path when it lacks one. The benchmark loads
no native code of the program or of the JAX package: this module offers
only ``huffman_pack``, the lossless-JPEG entropy packer the DNG writer
needs at 24 MP. ``prepare_tiles`` packs every tile of a file in one pass
on the device ahead of the writer, which then finds each tile's stream
by the key of its residuals; ``pack`` is the same arithmetic in NumPy
for anything not prepared. Both give the bytes of the copied NumPy path
(``raw/bitpack.huffman_encode`` without a native helper), which
``tests/test_copies.py`` holds; every other helper is absent, so the
writers take their own NumPy paths."""

from __future__ import annotations

import hashlib
import threading

import numpy as np

# Streams packed ahead by ``prepare_tiles``, by the key of their residuals.
_READY = {}
_LOCK = threading.Lock()


def _key(diffs, code_tab, clen_tab, max_raw_cat: int):
    h = hashlib.blake2b(digest_size=20)
    for a in (diffs, code_tab, clen_tab):
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode() + a.tobytes())
    return h.digest(), int(max_raw_cat)


def huffman_pack(diffs, itemsize: int, code_tab, clen_tab,
                 max_raw_cat: int) -> bytes:
    """The stream ``prepare_tiles`` packed for these residuals and tables,
    or ``pack``'s."""
    with _LOCK:
        ready = _READY.get(_key(diffs, code_tab, clen_tab, max_raw_cat))
    if ready is not None:
        return ready
    return pack(diffs, code_tab, clen_tab, max_raw_cat)


def prepare_tiles(mosaic, tile_size, precision: int, code_tab, clen_tab,
                  max_raw_cat: int, device) -> None:
    """Pack, in one pass on ``device``, the predictor-1 residual stream of
    every tile of ``mosaic`` as the DNG writer cuts it (row-major, each
    (height, width) = ``tile_size[::-1]``, zero-padded at the edges), and
    keep each under its key, so that the writer's per-tile calls find
    them. The same fields, offsets and word sums as ``pack``, per tile;
    ``tests/test_copies.py`` holds the result equal to the writer's."""
    import torch

    tw, th = tile_size
    h, w = mosaic.shape
    rows, cols = -(-h // th), -(-w // tw)
    m = torch.zeros((rows * th, cols * tw), dtype=torch.int32, device=device)
    m[:h, :w] = torch.from_numpy(np.ascontiguousarray(mosaic)).to(
        device).int()
    p = m.reshape(rows, th, cols, tw).permute(0, 2, 1, 3).reshape(-1, th, tw)
    d = torch.empty_like(p)
    d[:, :, 1:] = p[:, :, 1:] - p[:, :, :-1]
    d[:, 1:, 0] = p[:, 1:, 0] - p[:, :-1, 0]
    d[:, 0, 0] = p[:, 0, 0] - (1 << (precision - 1))
    # The int16 ring the scan encodes.
    d = ((d + 32768) % 65536 - 32768).reshape(d.shape[0], -1)
    host = d.to(torch.int16).cpu().numpy()
    codes = torch.from_numpy(np.asarray(code_tab, np.uint64).astype(
        np.int64)).to(device)
    clens = torch.from_numpy(np.asarray(clen_tab, np.int64)).to(device)
    d = d.long()
    cats = torch.searchsorted(
        torch.tensor([1 << k for k in range(17)], device=device),
        d.abs(), right=True)
    if int(cats.max()) >= len(clens) or bool((clens[cats] <= 0).any()):
        raise ValueError("residual category not in tree")
    raw_len = torch.where(cats > max_raw_cat, 0, cats)
    raw = torch.where(d >= 0, d, d + (1 << cats) - 1) & ((1 << raw_len) - 1)
    length = clens[cats] + raw_len
    value = (codes[cats] << raw_len) | raw
    end = torch.cumsum(length, 1)
    start = end - length
    total = end[:, -1]
    n_words = (total + 31) // 32 + 1
    base = torch.cumsum(n_words, 0) - n_words
    word = base[:, None] + (start >> 5)
    over = (start & 31) + length - 32  # bits that spill into word + 1
    spill = over.clamp(min=0)
    hi = (value << (-over).clamp(min=0)) >> spill
    lo = (value & ((1 << spill) - 1)) << (32 - spill)
    words = torch.zeros(int(n_words.sum()), dtype=torch.int64,
                        device=device)
    words.index_add_(0, word.reshape(-1), hi.reshape(-1))
    words.index_add_(0, word.reshape(-1) + 1, lo.reshape(-1))
    stream = words.cpu().numpy().astype(">u4").tobytes()
    ready = {}
    for t, (b, n) in enumerate(zip(base.tolist(), total.tolist())):
        ready[_key(host[t], code_tab, clen_tab, max_raw_cat)] = \
            stream[4 * b:4 * b + (n + 7) // 8]
    with _LOCK:
        _READY.update(ready)


def forget() -> None:
    """Drop the streams ``prepare_tiles`` kept."""
    with _LOCK:
        _READY.clear()


def pack(diffs, code_tab, clen_tab, max_raw_cat: int) -> bytes:
    """Per residual, its category's Huffman code then ``cat`` raw
    magnitude bits (none above ``max_raw_cat``), packed MSB-first and
    zero-padded to a byte; the contract of ``_rawkit.huffman_pack``.
    Each residual's code and raw bits form one field of at most 31 bits.
    Shifted to its bit offset inside a 64-bit window, a field lands in
    two 32-bit words; the fields never overlap, so a word is the sum of
    its parts, and ``bincount`` (exact in f64 below 2**53) adds them."""
    d = np.asarray(diffs).astype(np.int64).reshape(-1)
    code_tab = np.asarray(code_tab, np.uint64)
    clen_tab = np.asarray(clen_tab, np.int64)
    if d.size == 0:
        return b""
    cats = np.frexp(np.abs(d).astype(np.float64))[1].astype(np.int64)
    if cats.max() >= len(clen_tab) or (clen_tab[cats] <= 0).any():
        raise ValueError("residual category not in tree")
    raw_len = np.where(cats > max_raw_cat, 0, cats)
    raw = np.where(d >= 0, d, d + (np.int64(1) << cats) - 1)
    raw &= (np.int64(1) << raw_len) - 1
    length = clen_tab[cats] + raw_len
    if length.max() > 32:
        raise ValueError("a code and its raw bits exceed 32 bits")
    value = (code_tab[cats].astype(np.int64) << raw_len) | raw
    end = np.cumsum(length)
    start = end - length
    total = int(end[-1])
    word = start >> 5
    shift = (64 - (start & 31) - length).astype(np.uint64)
    placed = value.astype(np.uint64) << shift
    n_words = (total + 31) // 32 + 1
    hi = np.bincount(word, (placed >> np.uint64(32)).astype(np.float64),
                     n_words)
    lo = np.bincount(word + 1, (placed & np.uint64(0xFFFFFFFF))
                     .astype(np.float64), n_words)
    words = (hi + lo).astype(np.uint64).astype(">u4")
    return words.tobytes()[:(total + 7) // 8]


class _Kit:
    """The helpers the benchmark provides, under ``_rawkit``'s names."""
    huffman_pack = staticmethod(huffman_pack)


_KIT = _Kit()


def get_rawkit():
    """The stand-in: ``huffman_pack`` and nothing else."""
    return _KIT


def require_rawkit():
    return _KIT
