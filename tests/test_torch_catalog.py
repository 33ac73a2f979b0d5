"""The port's catalog (``catalog/``) and XMP sidecars (``xmp.py``),
copies of the JAX package's, driven side by side with the JAX ones.

Both libraries import the same folder (with the files the port's
writers make) into catalogs of their own under ``tmp_path`` and must
give the same counts, the same stored edit JSON, history, undo, ratings
and collections; XMP packets are the same text and round-trip.
"""

import numpy as np
import pytest

from raweditor_tpu.catalog import Library as JaxLibrary
from raweditor_tpu.params import EditParams as JaxParams
from raweditor_tpu.xmp import params_to_xmp as jax_params_to_xmp
from raweditor_tpu_torch import EditParams, Library
from raweditor_tpu_torch.raw import raf, synth
from raweditor_tpu_torch.xmp import (params_to_xmp, read_sidecar,
                                     write_sidecar, xmp_to_params)

EDITS = [dict(exposure=0.8, contrast=12.0),
         dict(exposure=-0.4, sharpen=55.0, grade_shadow_sat=40.0,
              sat_blue=-30.0),
         dict(exposure=0.1, point_curve=((0.0, 0.02), (0.5, 0.6),
                                         (1.0, 0.97)))]


@pytest.fixture
def folder(tmp_path):
    """A folder of RAW files (a DNG, a RAF, a NEF in a subfolder) and one
    file the import filter skips."""
    root = tmp_path / "photos"
    (root / "day2").mkdir(parents=True)
    rng = np.random.default_rng(5)
    m = rng.integers(0, 4096, size=(24, 36), dtype=np.uint16)
    synth.write_synthetic_raw(root / "a.dng", m, preview_jpeg=b"")
    synth.write_synthetic_raw(root / "day2" / "b.NEF", m,
                              compression="nikon", preview_jpeg=b"")
    (root / "c.raf").write_bytes(raf.write_raf(m))
    (root / "notes.txt").write_text("not a raw")
    return root


def _drive(lib, params_cls, folder):
    """Everything the catalog records, as plain values."""
    out = {"first": lib.import_folder(folder),
           "second": lib.import_folder(folder)}
    images = lib.get_all_images()
    out["files"] = sorted(img.filename for img in images)
    ids = {img.filename: img.id for img in images}
    a = ids["a.dng"]
    for edit in EDITS:
        lib.save_edit_params(a, params_cls(**edit), append=True)
    out["json"] = [row[0] for row in lib.conn.execute(
        "SELECT settings_json FROM edits WHERE image_id = ? ORDER BY id",
        (a,))]
    out["history"] = [p.to_json() for p in lib.edit_history(a)]
    out["undo"] = lib.undo_edit(a).to_json()
    out["loaded"] = lib.load_edit_params(a).to_json()
    b = ids["b.NEF"]
    lib.save_edit_params(b, params_cls(**EDITS[0]))
    lib.save_edit_params(b, params_cls(**EDITS[1]))  # upsert: one row
    out["upsert"] = lib.conn.execute(
        "SELECT COUNT(*) FROM edits WHERE image_id = ?", (b,)).fetchone()[0]
    out["has_edits"] = [lib.has_edits(i) for i in sorted(ids.values())]
    lib.set_rating(a, 4, flag="pick")
    lib.set_rating(b, 2)
    out["ratings"] = [lib.get_rating(i) for i in sorted(ids.values())]
    out["min3"] = [img.filename for img in lib.filter_images(min_rating=3)]
    out["added"] = lib.add_to_collection("keepers", [a, b])
    out["removed"] = lib.remove_from_collection("keepers", [b])
    out["collections"] = lib.list_collections()
    out["in_keepers"] = [img.filename for img in
                         lib.filter_images(collection="keepers")]
    return out


def test_library_matches_jax(folder, tmp_path):
    with Library(tmp_path / "port.db") as lib:
        got = _drive(lib, EditParams, folder)
    with JaxLibrary(tmp_path / "jax.db") as lib:
        want = _drive(lib, JaxParams, folder)
    assert got == want
    assert got["first"] == {"imported": 3, "skipped": 0}
    assert got["second"] == {"imported": 0, "skipped": 3}
    assert got["files"] == ["a.dng", "b.NEF", "c.raf"]
    assert got["loaded"] == EditParams(**EDITS[1]).to_json()


def test_edits_survive_reopening_and_develop_alike(folder, tmp_path):
    """Params saved by the port load back equal from a new connection,
    and the JAX catalog reads the same params from the port's file."""
    from raweditor_tpu_torch import DevelopEngine, decode_raw

    p = EditParams(**EDITS[1])
    with Library(tmp_path / "cat.db") as lib:
        lib.import_folder(folder)
        image = next(i for i in lib.get_all_images()
                     if i.filename == "a.dng")
        lib.save_edit_params(image.id, p)
    with Library(tmp_path / "cat.db") as lib:
        loaded = lib.load_edit_params(image.id)
    with JaxLibrary(tmp_path / "cat.db") as lib:
        assert lib.load_edit_params(image.id).to_json() == p.to_json()
    assert loaded == p
    eng = DevelopEngine(decode_raw(image.path), device="cpu")
    assert bool((eng.full_rgba_device(loaded)
                 == eng.full_rgba_device(p)).all())


@pytest.mark.parametrize("edit", range(len(EDITS)))
@pytest.mark.parametrize("rating, flag, label", [(None, "none", None),
                                                 (4, "pick", "keeper"),
                                                 (3, "reject", None)])
def test_xmp_matches_jax_and_round_trips(edit, rating, flag, label,
                                         tmp_path):
    p = EditParams(**EDITS[edit])
    text = params_to_xmp(p, rating=rating, flag=flag, label=label)
    assert text == jax_params_to_xmp(JaxParams(**EDITS[edit]), rating=rating,
                                     flag=flag, label=label)
    q, got_rating, got_flag, got_label = xmp_to_params(text)
    assert q == p
    assert (got_rating, got_flag, got_label) == (
        None if flag == "reject" else rating, flag, label)
    raw_path = tmp_path / "frame.dng"
    sidecar = write_sidecar(raw_path, p, rating=rating, flag=flag,
                            label=label)
    assert read_sidecar(sidecar)[0] == p
