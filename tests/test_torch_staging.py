"""The port's bit-packed staging (``ops/staging.py``) against the JAX
package's: the host packers byte for byte (through ``_rawkit`` and
through numpy), the torch unpackers against the JAX unpackers and the
source mosaic, and the exporter's staged bytes against the JAX
exporter's ``upload_bytes``."""

import numpy as np
import pytest
import torch

from raweditor_tpu.ops import staging as jst
from raweditor_tpu.params import EditParams as JaxParams
from raweditor_tpu.pipeline import export as jex
from raweditor_tpu_torch import EditParams
from raweditor_tpu_torch.ops import staging as st
from raweditor_tpu_torch.pipeline import export as pex
from raweditor_tpu_torch.raw.synth import write_synthetic_raw

PACKERS = {12: (st.pack12_rows, st.unpack12_rows, jst.pack12_rows,
                jst.unpack12_rows, 2),
           14: (st.pack14_rows, st.unpack14_rows, jst.pack14_rows,
                jst.unpack14_rows, 4)}


def _cases(rng, bits):
    """Random, extreme, strided and Fortran-ordered mosaics."""
    top = 1 << bits
    return [rng.integers(0, top, size=(11, 24), dtype=np.uint16),
            np.zeros((4, 8), np.uint16), np.full((4, 8), top - 1, np.uint16),
            np.asfortranarray(rng.integers(0, top, size=(6, 8),
                                           dtype=np.uint16)),
            rng.integers(0, top, size=(32, 64), dtype=np.uint16)[::2, 4:60]]


@pytest.mark.parametrize("codec", ["native", "numpy"])
@pytest.mark.parametrize("bits", [12, 14])
def test_pack_bytes_equal_jax(bits, codec, rng, monkeypatch):
    """Both packers give the JAX packer's bytes, natively and in numpy
    (``get_rawkit`` returning None in both packages)."""
    pack, _, jpack, _, _ = PACKERS[bits]
    if codec == "numpy":
        monkeypatch.setattr("raweditor_tpu_torch.native.get_rawkit",
                            lambda: None)
        monkeypatch.setattr("raweditor_tpu.native.get_rawkit", lambda: None)
    for m in _cases(rng, bits):
        got = pack(m)
        assert got.dtype == np.uint8
        assert got.nbytes == m.size * 2 * (3 if bits == 12 else 7) // (
            4 if bits == 12 else 8)
        np.testing.assert_array_equal(got, jpack(m))
        # The exporter passes the peak it scanned.
        np.testing.assert_array_equal(pack(m, m.max()), got)


@pytest.mark.parametrize("bits", [12, 14])
def test_unpack_inverts_pack_and_equals_jax(bits, rng):
    """The torch unpack returns the source mosaic and the JAX unpack's
    values, one frame or a batch of them."""
    pack, unpack, _, junpack, _ = PACKERS[bits]
    for m in _cases(rng, bits):
        p = pack(m)
        got = unpack(torch.from_numpy(p.copy()))
        assert got.dtype == torch.uint16 and tuple(got.shape) == m.shape
        np.testing.assert_array_equal(got.numpy(), m)
        np.testing.assert_array_equal(got.numpy(), np.asarray(junpack(p)))
        batch = unpack(torch.from_numpy(np.stack([p, p[::-1]])))
        np.testing.assert_array_equal(batch.numpy(), np.stack([m, m[::-1]]))


@pytest.mark.parametrize("bits", [12, 14])
def test_out_of_contract_inputs_raise(bits, rng):
    """Samples at 2^bits or above, misaligned widths and 1-D input raise
    in the packer, as in the JAX one; packed rows whose length is not a
    whole number of groups, or not u8, raise in the unpacker."""
    pack, unpack, jpack, _, align = PACKERS[bits]
    wild = np.full((4, 8), 1 << bits, np.uint16)
    narrow = rng.integers(0, 1 << bits, size=(4, align + 1), dtype=np.uint16)
    flat = rng.integers(0, 1 << bits, size=(8,), dtype=np.uint16)
    for bad in (wild, narrow, flat):
        with pytest.raises(ValueError):
            pack(bad)
        with pytest.raises(ValueError):
            jpack(bad)
    group = 3 if bits == 12 else 7
    with pytest.raises(ValueError):
        unpack(torch.zeros((4, group * 2 + 1), dtype=torch.uint8))
    with pytest.raises(TypeError):
        unpack(torch.zeros((4, group * 2), dtype=torch.int16))


def test_export_stages_u12_and_u14_as_jax(tmp_path, rng):
    """A run with 12-bit and 14-bit files (and a 14-bit file too narrow
    to pack, staged as u16) uploads the JAX exporter's byte count and
    writes the same pixels."""
    from PIL import Image

    mosaics = [rng.integers(0, 4096, size=(16, 24), dtype=np.uint16),
               rng.integers(0, 4096, size=(16, 24), dtype=np.uint16),
               rng.integers(4096, 16384, size=(16, 24), dtype=np.uint16),
               rng.integers(4096, 16384, size=(16, 22), dtype=np.uint16)]
    port_jobs, ref_jobs = [], []
    for i, m in enumerate(mosaics):
        p = tmp_path / f"s{i}.dng"
        write_synthetic_raw(p, m, bpp=12 if m.max() < 4096 else 14,
                            preview_jpeg=b"")
        port_jobs.append(pex.ExportJob(str(p), str(tmp_path / f"p{i}.png"),
                                       EditParams(exposure=0.2)))
        ref_jobs.append(jex.ExportJob(str(p), str(tmp_path / f"j{i}.png"),
                                      JaxParams(exposure=0.2)))
    rep = pex.run_batch_export(port_jobs, batch_size=2, device="cpu")
    ref = jex.run_batch_export(ref_jobs, batch_size=2)
    assert rep.succeeded == ref.succeeded == 4
    assert rep.upload_bytes == ref.upload_bytes == (
        2 * 16 * 24 * 2 * 3 // 4 + 16 * 24 * 2 * 7 // 8 + 16 * 22 * 2)
    for a, b in zip(port_jobs, ref_jobs):
        np.testing.assert_array_equal(np.asarray(Image.open(a.out_path)),
                                      np.asarray(Image.open(b.out_path)))
    assert pex._stage_used == 0


def test_over_budget_mosaics_upload_at_flush(tmp_path, rng, monkeypatch):
    """With no staging budget every mosaic uploads at flush time, raw, as
    in the JAX exporter: the same pixels, no staged bytes."""
    from PIL import Image

    p = tmp_path / "s.dng"
    write_synthetic_raw(p, rng.integers(0, 4096, size=(16, 24),
                                        dtype=np.uint16), preview_jpeg=b"")
    outs = []
    for budget in (0, pex._STAGE_BUDGET):
        monkeypatch.setattr(pex, "_STAGE_BUDGET", budget)
        out = tmp_path / f"b{budget}.png"
        rep = pex.run_batch_export(
            [pex.ExportJob(str(p), str(out))], batch_size=1, device="cpu")
        assert rep.succeeded == 1
        assert rep.upload_bytes == (0 if budget == 0 else 16 * 24 * 2 * 3 // 4)
        outs.append(np.asarray(Image.open(out)))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_staging_budget_under_contention(tmp_path, rng, monkeypatch):
    """Sixteen decode workers (more than the cores) race for a budget that
    holds three packed mosaics, with a short switch interval: every image
    still comes out equal to an unstaged run, and the budget returns to
    zero (a lost update of the shared counter would leave it off)."""
    import sys

    from PIL import Image

    jobs, plain_jobs = [], []
    for i in range(12):
        p = tmp_path / f"c{i}.dng"
        write_synthetic_raw(p, rng.integers(0, 4096, size=(16, 24),
                                            dtype=np.uint16),
                            preview_jpeg=b"")
        jobs.append(pex.ExportJob(str(p), str(tmp_path / f"s{i}.png")))
        plain_jobs.append(pex.ExportJob(str(p), str(tmp_path / f"u{i}.png")))
    packed = 16 * 24 * 2 * 3 // 4
    monkeypatch.setattr(pex, "_STAGE_BUDGET", 0)
    assert pex.run_batch_export(plain_jobs, batch_size=3,
                                device="cpu").succeeded == 12
    monkeypatch.setattr(pex, "_STAGE_BUDGET", 3 * packed)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        rep = pex.run_batch_export(jobs, batch_size=3, decode_threads=16,
                                   device="cpu")
    finally:
        sys.setswitchinterval(old)
    assert rep.succeeded == 12 and not rep.failed
    assert pex._stage_used == 0
    assert packed <= rep.upload_bytes <= 12 * packed
    for a, b in zip(jobs, plain_jobs):
        np.testing.assert_array_equal(np.asarray(Image.open(a.out_path)),
                                      np.asarray(Image.open(b.out_path)))
