"""The port's RAW decode (copies of the JAX package's ``raw/`` modules)
against the JAX package on the CPU.

For every format the writers make, the port's writer and the JAX
writer give the same bytes, and both packages' ``decode_raw`` give equal
``RawImage`` fields from that file: the mosaic exactly, every float
exactly, ``black_per_site`` both None or equal. Each case runs the
port's native codec (``_rawkit``) and its pure-Python codec
(``RAWEDITOR_TPU_NO_NATIVE=1``). Broken input raises the same exception
in both packages, the port's own ``RawDecodeError`` where JAX raises
its.
"""

import dataclasses
import importlib
import struct

import numpy as np
import pytest

import raweditor_tpu.native as jax_native
import raweditor_tpu_torch.native as native
from raweditor_tpu.raw.decode import RawDecodeError as JaxDecodeError
from raweditor_tpu.raw.decode import decode_raw as jax_decode_raw
from raweditor_tpu_torch.raw.decode import RawDecodeError, decode_raw

H, W = 48, 64


class _Pkg:
    """One package's writer modules, by attribute."""

    def __init__(self, pkg):
        for name in ("synth", "raf", "ciff", "bmff", "kodak_radc",
                     "panasonic"):
            setattr(self, name, importlib.import_module(f"{pkg}.raw.{name}"))


PORT, JAX = _Pkg("raweditor_tpu_torch"), _Pkg("raweditor_tpu")


def _mosaic(seed, h=H, w=W, top=4096):
    return np.random.default_rng(seed).integers(0, top, (h, w),
                                                dtype=np.uint16)


def _arw2_mosaic(seed):
    """Per-32-column spans with an 11-bit range under 128, so every block
    of the ARW2 codec is lossless."""
    rng = np.random.default_rng(seed)
    m11 = np.empty((H, W), np.int32)
    for p in range(W // 32):
        m11[:, p * 32:(p + 1) * 32] = rng.integers(0, 1900) + rng.integers(
            0, 127, size=(H, 32))
    return (m11 << 1).astype(np.uint16)


def _scene(seed, bits=14):
    """A smooth field plus noise (the CRX codec's test scene)."""
    rng = np.random.default_rng(seed)
    base = (np.sin(np.linspace(0, 3, W))[None]
            * np.cos(np.linspace(0, 2, H))[:, None])
    m = ((base * 0.4 + 0.5) * ((1 << bits) - 1)).astype(np.int64)
    m += rng.integers(-200, 200, size=(H, W))
    return np.clip(m, 0, (1 << bits) - 1).astype(np.uint16)


D3300 = np.array([[6988, -1384, -714], [-5631, 13410, 2447],
                  [-1485, 2204, 7318]], np.float32) / 10000.0


def _synth(**kw):
    def write(p, seed):
        return p.synth.write_synthetic_raw(None, _mosaic(seed), **kw), "dng"
    return write


# name: writer(package, seed) -> (file bytes, extension)
FORMATS = {
    **{c: _synth(compression=c) for c in ("none", "ljpeg", "ljpeg4",
                                           "pentax", "nikon")},
    "accurate_dng": _synth(compression="ljpeg", xyz_to_cam=D3300,
                           black_level=150, white_level=4095,
                           wb_neutral=(0.5, 1.0, 0.625), cfa="GBRG",
                           orientation=6, make="NIKON CORPORATION",
                           model="NIKON D3300"),
    "site_blacks": _synth(black_level=(146, 153, 151, 150)),
    "arw2": lambda p, s: (p.synth.write_synthetic_raw(
        None, _arw2_mosaic(s), compression="arw2", make="SONY"), "arw"),
    "kodak65000": lambda p, s: (p.synth.write_synthetic_raw(
        None, _mosaic(s, 20, 280), compression="kodak65000",
        make="EASTMAN KODAK", model="DCS Pro"), "dcr"),
    "srw1": lambda p, s: (p.synth.write_synthetic_raw(
        None, _mosaic(s), compression="srw1", make="SAMSUNG", srw_wb=True,
        srw_black=(64, 64, 64, 64)), "srw"),
    "srw3": lambda p, s: (p.synth.write_synthetic_raw(
        None, _mosaic(s), compression="srw3", make="SAMSUNG"), "srw"),
    "radc": lambda p, s: (p.synth.write_synthetic_raw(
        None, p.kodak_radc.radc_representable(_mosaic(
            s, 8, 16, p.kodak_radc.WHITE + 1)), bpp=14, compression="radc",
        make="KODAK", model="DC50 Synth"), "kdc"),
    "tiles_ljpeg": _synth(compression="ljpeg", tile_size=(32, 16)),
    "tiles_none": _synth(compression="none", tile_size=(32, 16)),
    "float_samples": _synth(float_samples=True),
    "cr2_slices": lambda p, s: (p.synth.write_synthetic_raw(
        None, _mosaic(s), compression="ljpeg", cr2_slices=(2, 24, 16),
        make="Canon"), "cr2"),
    "orf_olympus": lambda p, s: (p.synth.write_synthetic_orf(
        None, _mosaic(s), wb_rb=(2.0, 1.5)), "orf"),
    "orf_none16": lambda p, s: (p.synth.write_synthetic_orf(
        None, _mosaic(s), compression="none16"), "orf"),
    "rw2": lambda p, s: (p.synth.write_synthetic_rw2(
        None, p.panasonic.rw2_representable(_mosaic(s, w=56))), "rw2"),
    "raf": lambda p, s: (p.raf.write_raf(
        _mosaic(s), model="X-T2", wb_grbg=(256, 512, 384, 256)), "raf"),
    "crw": lambda p, s: (p.ciff.write_crw(
        None, _mosaic(s, 16, 32), wb=(2.0, 1.0, 1.5, 1.0), make="Canon",
        model="EOS Synth", table=1), "crw"),
    "cr3": lambda p, s: (p.bmff.write_synthetic_cr3(
        None, mosaic=_scene(s), model="EOS R5 Synth"), "cr3"),
    "linear_dng": lambda p, s: (p.synth.write_synthetic_linear_dng(
        None, np.random.default_rng(s).integers(0, 65536, (16, 24, 3),
                                                dtype=np.uint16)), "dng"),
}


@pytest.fixture
def codec(request, monkeypatch):
    """The port's codec path for one test: "native" or "python". The
    JAX package decodes with its default (native) path; both loaders'
    cached answers are cleared and restored."""
    for mod in (native, jax_native):
        monkeypatch.setattr(mod, "_tried", False)
        monkeypatch.setattr(mod, "_cached", None)
    monkeypatch.delenv("RAWEDITOR_TPU_NO_NATIVE", raising=False)
    assert jax_native.get_rawkit() is not None

    def use(path):
        if path == "python":
            monkeypatch.setenv("RAWEDITOR_TPU_NO_NATIVE", "1")
        assert (native.get_rawkit() is None) == (path == "python")
    use(request.param)
    return request.param


def assert_same_frame(got, want):
    """Every field equal: arrays bit for bit with their dtypes, floats
    exactly, strings and flags equal."""
    names = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == names
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
            assert a is not None and b is not None, name
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), name
        else:
            assert type(a) is type(b) and a == b, (name, a, b)


@pytest.mark.parametrize("codec", ["native", "python"], indirect=True)
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_decode_equals_jax(fmt, codec, tmp_path):
    seed = 1000 + list(FORMATS).index(fmt)
    data, ext = FORMATS[fmt](PORT, seed)
    assert data == FORMATS[fmt](JAX, seed)[0]  # the writers agree too
    path = tmp_path / f"frame.{ext}"
    path.write_bytes(data)
    want = jax_decode_raw(path)
    got = decode_raw(path)
    assert_same_frame(got, want)
    assert got.source_path == str(path)


def test_decoded_fields_are_what_was_written(tmp_path):
    """The accurate DNG carries what was written: mosaic, matrix, WB from
    the as-shot neutral, levels, CFA phase, orientation, make and model."""
    data, _ = FORMATS["accurate_dng"](PORT, 7)
    raw = decode_raw(data)
    np.testing.assert_array_equal(raw.mosaic, _mosaic(7))
    np.testing.assert_array_equal(raw.xyz_to_cam, D3300)
    np.testing.assert_array_equal(raw.wb_multipliers,
                                  np.array([2.0, 1.0, 1.6, 1.0], np.float32))
    assert (raw.black_level, raw.white_level) == (150.0, 4095.0)
    assert (raw.cfa_pattern, raw.orientation) == ("GBRG", 6)
    assert (raw.camera_make, raw.camera_model) == ("NIKON CORPORATION",
                                                   "NIKON D3300")


def test_raf_decodes_to_the_xtrans_grid(tmp_path):
    from raweditor_tpu_torch.ops.cfa_generic import XTRANS_PATTERN, is_xtrans

    data, _ = FORMATS["raf"](PORT, 3)
    raw = decode_raw(data)
    assert raw.cfa_pattern == XTRANS_PATTERN and is_xtrans(raw.cfa_pattern)
    np.testing.assert_array_equal(raw.wb_multipliers,
                                  np.array([2.0, 1.0, 1.5, 1.0], np.float32))
    assert (raw.camera_make, raw.camera_model) == ("FUJIFILM", "X-T2")
    assert raw.white_level == float(_mosaic(3).max())


def _truncated_ifd():
    data = bytearray(b"II*\x00")
    data += struct.pack("<I", 20)  # first IFD at 20
    data += b"\x00" * 12
    data += struct.pack("<H", 0)  # no entries
    data += struct.pack("<I", 21)  # next IFD one byte before the end
    data += b"\x00"
    return bytes(data)


def _cut(fmt, keep):
    def make():
        data, _ = FORMATS[fmt](PORT, 11)
        return data[:keep(len(data))]
    return make


# name: a maker of the bytes (or path) to decode
BROKEN = {
    "not_a_tiff": lambda: b"not a tiff at all",
    "no_cfa": lambda: b"II*\x00\x08\x00\x00\x00\x00\x00\x00\x00\x00\x00",
    "truncated_ifd": _truncated_ifd,
    "truncated_kodak": _cut("kodak65000", lambda n: n - 400),
    "truncated_radc": _cut("radc", lambda n: n - 30),
    "truncated_ljpeg": _cut("ljpeg", lambda n: n // 2),
    "truncated_raf": _cut("raf", lambda n: n - 1000),
    "corrupt_crw": lambda: FORMATS["crw"](PORT, 11)[0][:-40],
    "corrupt_cr3": lambda: FORMATS["cr3"](PORT, 11)[0][:4000],
}


@pytest.mark.parametrize("case", list(BROKEN))
def test_broken_input_raises_like_jax(case):
    data = BROKEN[case]()
    with pytest.raises(JaxDecodeError) as want:
        jax_decode_raw(data)
    with pytest.raises(RawDecodeError) as got:
        decode_raw(data)
    assert type(got.value).__name__ == type(want.value).__name__
    assert type(got.value).__module__.startswith("raweditor_tpu_torch.")


def test_missing_file_raises_like_jax(tmp_path):
    path = tmp_path / "nowhere.nef"
    with pytest.raises(FileNotFoundError):
        jax_decode_raw(path)
    with pytest.raises(FileNotFoundError):
        decode_raw(path)
