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


@pytest.fixture
def budgets(monkeypatch):
    """The staging budget of every ``run_batch_export`` call the test
    makes, in call order."""
    made = []

    class Recorded(pex._StageBudget):
        def __init__(self, limit):
            super().__init__(limit)
            made.append(self)

    monkeypatch.setattr(pex, "_StageBudget", Recorded)
    return made


def test_export_stages_u12_and_u14_as_jax(tmp_path, rng, budgets):
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
    assert len(budgets) == 1 and budgets[0].used == 0


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


def test_staging_budget_under_contention(tmp_path, rng, monkeypatch,
                                        budgets):
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
    assert len(budgets) == 2 and budgets[1].limit == 3 * packed
    assert budgets[1].used == 0
    assert packed <= rep.upload_bytes <= 12 * packed
    for a, b in zip(jobs, plain_jobs):
        np.testing.assert_array_equal(np.asarray(Image.open(a.out_path)),
                                      np.asarray(Image.open(b.out_path)))


# -- the batch fill (unpack_into_batch): its plain version on the CPU ----------

def _packed(rng, fmt, h, w):
    """(mosaic, its packed rows as a tensor) of a seeded frame."""
    bits, pack = (12, st.pack12_rows) if fmt == "u12" else (14,
                                                            st.pack14_rows)
    m = rng.integers(0, 1 << bits, size=(h, w), dtype=np.uint16)
    return m, torch.from_numpy(pack(m).copy())


def _raw(rng, shape):
    m = rng.integers(0, 1 << 16, size=shape, dtype=np.uint16)
    return m, torch.from_numpy(m.copy())


# name: the slots' formats (None: a late upload the caller writes into
# its slot, or the replay of one, which reads that slot as u16 samples),
# the distinct items (the rest repeat the first: the fill takes repeated
# sources) and the frame.
FILLS = {
    "u12": (["u12"] * 3, 3, (6, 10)),
    "u14": (["u14"] * 2, 2, (5, 12)),
    "u16": (["u16"] * 2, 2, (4, 6)),
    "mixed": (["u12", "u14", "u16", None], 4, (4, 8)),
    "pad-packed": (["u12"] * 4, 2, (3, 8)),
    "pad-raw": (["u16"] * 3, 1, (3, 8)),
    "pad-late": ([None, "u12", None, None], 2, (2, 4)),
    "frame-3d": (["u16"] * 3, 2, (4, 6, 3)),
}


@pytest.mark.parametrize("case", sorted(FILLS))
def test_batch_fill_equals_the_stack_of_unpacks(case, rng):
    """Each slot holds what the flush's ``torch.stack`` of ``unpack12_rows``
    / ``unpack14_rows`` (or the u16 frame) held, repeated slots replaying
    the first item; a slot without a source keeps what the caller wrote,
    and a u16 source may be a slot of the batch itself."""
    fmts, distinct, frame = FILLS[case]
    items = [(fmt,) + (_packed(rng, fmt, *frame) if fmt in ("u12", "u14")
                       else _raw(rng, frame))
             for fmt in fmts[:distinct]]
    items += [items[0]] * (len(fmts) - distinct)
    out = torch.zeros((len(fmts),) + frame, dtype=torch.uint16)
    sources, kinds = [], []
    for i, (fmt, m, src) in enumerate(items):
        if fmt is not None:
            sources.append(src)
            kinds.append(fmt)
        elif i < distinct:  # the late upload, before the launch
            out[i].copy_(src)
            sources.append(None)
            kinds.append(None)
        else:  # a replay of the uploaded first item: its slot
            sources.append(out[0])
            kinds.append("u16")
    before = st.LAUNCHES["unpack_slots"]
    assert st.unpack_into_batch(out, sources, kinds) is out
    assert st.LAUNCHES["unpack_slots"] == before  # the plain version
    np.testing.assert_array_equal(
        out.numpy(), np.stack([m for _, m, _ in items]))


def _bad(name):
    """(batch, sources, formats) the fill must refuse, and the error."""
    u8 = torch.zeros((4, 9), dtype=torch.uint8)
    out = torch.zeros((2, 4, 6), dtype=torch.uint16)
    return {
        "batch-dtype": (out.to(torch.int32), [u8, u8], ["u12"] * 2,
                        TypeError),
        "batch-2d": (out[0], [u8] * 4, ["u12"] * 4, ValueError),
        "batch-strided": (out.transpose(1, 2), [u8, u8], ["u12"] * 2,
                          ValueError),
        "source-dtype": (out, [u8.to(torch.int16), u8], ["u12"] * 2,
                         TypeError),
        "u16-dtype": (out, [torch.zeros((4, 6), dtype=torch.int16), None],
                      ["u16", None], TypeError),
        "odd-width": (torch.zeros((2, 4, 7), dtype=torch.uint16),
                      [u8, u8], ["u12"] * 2, ValueError),
        "misaligned-width": (out, [torch.zeros((4, 10), dtype=torch.uint8),
                                   None], ["u14", None], ValueError),
        "packed-shape": (out, [torch.zeros((4, 12), dtype=torch.uint8),
                               None], ["u12", None], ValueError),
        "u16-shape": (out, [torch.zeros((4, 8), dtype=torch.uint16), None],
                      ["u16", None], ValueError),
        "packed-3d-frame": (torch.zeros((2, 4, 6, 3), dtype=torch.uint16),
                            [u8, None], ["u12", None], ValueError),
        "unknown-format": (out, [u8, u8], ["u10", "u12"], ValueError),
        "count": (out, [u8], ["u12"], ValueError),
        "source-strided": (out, [torch.zeros((4, 18), dtype=torch.uint8)
                                 [:, ::2], None], ["u12", None], ValueError),
        "not-a-tensor": (out, [u8.numpy(), None], ["u12", None], TypeError),
        "device": (out, [torch.zeros((4, 9), dtype=torch.uint8,
                                     device="meta"), None], ["u12", None],
                   ValueError),
    }[name]


@pytest.mark.parametrize("name", ["batch-dtype", "batch-2d", "batch-strided",
                                  "source-dtype", "u16-dtype", "odd-width",
                                  "misaligned-width", "packed-shape",
                                  "u16-shape", "packed-3d-frame",
                                  "unknown-format", "count",
                                  "source-strided", "not-a-tensor",
                                  "device"])
def test_batch_fill_refuses_what_the_kernel_does_not_take(name):
    """Wrong dtypes, an odd or misaligned width, shapes that do not match
    the slot, an unknown format, a strided tensor, a source elsewhere
    than the batch: raised before any slot is written."""
    out, sources, fmts, err = _bad(name)
    before = out.clone() if out.device.type == "cpu" else None
    with pytest.raises(err):
        st.unpack_into_batch(out, sources, fmts)
    if before is not None:
        assert torch.equal(out, before)


def test_flush_fills_late_uploads_and_their_replays(tmp_path, rng,
                                                    monkeypatch):
    """A batch whose first item missed the staging budget (a 16-bit
    mosaic) beside a staged u12 one, flushed two slots long under a
    batch size of three: the first uploads into its slot, the second
    unpacks, no slot replays either; the files equal an unstaged run's
    and the staging counters count one slot unpacked and one uploaded."""
    from PIL import Image

    mosaics = [rng.integers(16384, 65536, size=(16, 24), dtype=np.uint16),
               rng.integers(0, 4096, size=(16, 24), dtype=np.uint16)]
    outs = {}
    for budget in (0, 16 * 24 * 2 * 3 // 4):  # room for the u12 one only
        monkeypatch.setattr(pex, "_STAGE_BUDGET", budget)
        jobs = []
        for i, m in enumerate(mosaics):
            p = tmp_path / f"l{i}.dng"
            write_synthetic_raw(p, m, bpp=12 if i else 16, preview_jpeg=b"")
            jobs.append(pex.ExportJob(str(p), str(tmp_path / f"l{budget}_{i}"
                                                  ".png")))
        rep = pex.run_batch_export(jobs, batch_size=3, decode_threads=1,
                                   device="cpu")
        assert rep.succeeded == 2 and not rep.failed
        counters = rep.stages["counters"]
        if budget:
            assert rep.upload_bytes == 16 * 24 * 2 + 16 * 24 * 2 * 3 // 4
            assert (counters["staging.slots_unpacked"],
                    counters["staging.slots_copied"],
                    counters["staging.slots_uploaded"]) == (1, 0, 1)
        else:  # nothing staged: one upload of the stacked batch
            assert rep.upload_bytes == 0
            assert (counters["staging.slots_unpacked"],
                    counters["staging.slots_copied"],
                    counters["staging.slots_uploaded"]) == (0, 0, 0)
        outs[budget] = [np.asarray(Image.open(j.out_path)) for j in jobs]
    for a, b in zip(*outs.values()):
        np.testing.assert_array_equal(a, b)


def test_slot_limit_is_the_kernels():
    """The wrapper splits a batch into launches of at most the slots the
    kernel's parameter table holds, and the formats are its codes."""
    import re

    from raweditor_tpu_torch.ops import _build

    text = (_build.CSRC / "staging.cu").read_text()
    assert int(re.search(r"constexpr int kMaxSlots = (\d+);", text)
               .group(1)) == st.MAX_SLOTS
    assert st.FORMATS == {"u12": 0, "u14": 1, "u16": 2}
    assert "fmt 0, u12" in text and "fmt 1, u14" in text and "fmt 2, u16" in text
