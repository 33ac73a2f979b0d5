"""The benchmark harness's lookups by name, in the tier-1 gate: the cases
of ``bench_torch/tests/test_lookups.py`` (a configuration, its container
and reference modules and a traffic mix, each added as new files alone,
are found, written, rehearsed and checked, and a missing one is refused
by name), run here over the repo's configurations as they stand, with
``linear_dng`` among them: its reference gives the export check alone,
so it makes ``linear_dng.export`` and no ``linear_dng.edit``; and
``r5_dng``, whose reference gives the shaped check alone, so it makes
``r5_dng.export_web`` and no other cell, and no other configuration makes
an ``.export_web`` cell."""

import numpy as np
import pytest
import torch

from bench_torch import core, rehearse
from bench_torch.containers import dng, linear_dng
from bench_torch.drivers import files
from bench_torch.tests import test_lookups as lookups
from bench_torch.tests.test_lookups import added  # noqa: F401 - fixture
from bench_torch.yardstick import web_reference
from bench_torch.yardstick.raw import synth
from bench_torch.yardstick.scene import scene

ADDED, MIX = lookups.ADDED, lookups.MIX
REPO_CELLS = ["d3300_dng.edit", "d3300_dng.export", "linear_dng.export",
              "r5_dng.export_web", "xt2_raf.edit", "xt2_raf.export"]
UNSERVED = r"gives no \['preview', 'preview_planes', 'histogram', 'bin_shift'\]"

test_the_rehearsal_writes_and_checks_the_added_configuration = \
    lookups.test_the_rehearsal_writes_and_checks_the_added_configuration
test_the_rehearsal_runs_the_added_mix_on_a_repo_configuration = \
    lookups.test_the_rehearsal_runs_the_added_mix_on_a_repo_configuration
test_a_missing_lookup_fails_naming_it = \
    lookups.test_a_missing_lookup_fails_naming_it
test_write_files_gives_the_frozen_writers_files = \
    lookups.test_write_files_gives_the_frozen_writers_files


def test_the_repo_rehearses_its_five_cells():
    assert core.folder_cells() == REPO_CELLS


def test_linear_dng_makes_an_export_cell_and_no_edit_cell():
    bench, cell, cfg, mix = core.find_cell("linear_dng.export")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "linear_dng", "export", 1)
    assert cfg["name"] == "linear_dng" and mix["driver"] == "catalog_export"
    assert core.container_of(cfg) is linear_dng
    assert [c["reduced"] for c in bench["configs"]
            if c["name"] == "linear_dng"] == [cfg["reduced"]]
    with pytest.raises(LookupError, match="'linear_dng': its reference "
                       "bench_torch/yardstick/linear_reference.py "
                       + UNSERVED):
        core.any_cell("linear_dng.edit")


def test_r5_dng_makes_an_export_web_cell_and_no_other():
    bench, cell, cfg, mix = core.find_cell("r5_dng.export_web")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "r5_dng", "export_web", 1)
    assert cfg["name"] == "r5_dng" and mix["driver"] == "catalog_export_web"
    assert mix["export"] == {"ext": "jpg", "long_edge": 2048}
    assert core.container_of(cfg) is dng and cfg["container"] == "dng"
    assert core.reference_of(cfg) is web_reference
    assert (cfg["height"], cfg["width"], cfg["bits"], cfg["cfa"]) == (
        5464, 8192, 14, "RGGB")
    assert cfg["reduced"] == ["xyz_to_cam_x10000"]
    assert [c["reduced"] for c in bench["configs"]
            if c["name"] == "r5_dng"] == [cfg["reduced"]]
    for traffic in ("export", "edit"):
        with pytest.raises(LookupError, match="'r5_dng': its reference "
                           "bench_torch/yardstick/web_reference.py gives "
                           "no"):
            core.any_cell(f"r5_dng.{traffic}")
    for config in ("d3300_dng", "linear_dng", "xt2_raf"):
        with pytest.raises(LookupError,
                           match=r"gives no \['shaped_planes'\]"):
            core.any_cell(f"{config}.export_web")
    assert [c for c in core.folder_cells() if c.endswith(".export_web")] \
        == ["r5_dng.export_web"]


def test_cells_follow_what_the_references_give(added):  # noqa: F811
    """The added mix runs on every configuration whose reference serves
    the export driver, the repo's with their files untouched; the added
    configuration and ``linear_dng``, whose references give no slider
    check, run under the export mixes alone, and ``r5_dng``, whose
    reference gives the shaped check alone, under the web mix alone."""
    tmp_path, _ = added
    assert core.folder_cells() == [
        "d3300_dng.edit", "d3300_dng.export", f"d3300_dng.{MIX}",
        "linear_dng.export", f"linear_dng.{MIX}", "r5_dng.export_web",
        f"{ADDED}.export", f"{ADDED}.{MIX}",
        "xt2_raf.edit", "xt2_raf.export", f"xt2_raf.{MIX}"]
    for path in (core.PKG / "configs").glob("*.json"):
        assert (tmp_path / "configs" / path.name).read_bytes() == \
            path.read_bytes()
    with pytest.raises(LookupError, match=f"{ADDED!r}: its reference "
                       f"reference_strip.py {UNSERVED}"):
        core.any_cell(f"{ADDED}.edit")


def test_write_files_gives_the_linear_writers_files(tmp_path):
    """At the rehearsal frame and a fixed seed: three ``scene()`` draws
    at 16 bits stacked as the channels, rolled by (97 i, 211 i), written
    as the frozen LinearRaw writer writes them alone, with the frame the
    decoder must read back."""
    cfg = lookups._config("linear_dng")
    out = files.write_files(cfg, tmp_path, 3, np.random.default_rng(11),
                            rehearse.rehearsal_of(cfg), torch.device("cpu"))
    h, w = cfg["rehearsal"]["frame"]
    rng = np.random.default_rng(11)
    base = np.stack([scene(rng, h, w, 65535) for _ in range(3)], axis=-1)
    for i, (path, frame) in enumerate(out):
        image = np.roll(base, (97 * i, 211 * i), axis=(0, 1))
        assert frame.mosaic.shape == (h, w, 3)
        assert np.array_equal(frame.mosaic, image)
        want = synth.write_synthetic_linear_dng(
            None, image, bpp=16, compression="none",
            wb_neutral=(0.5, 1.0, 0.625), black_level=0, white_level=65535,
            uncorrelated_preview=True)
        assert path.endswith(f"DSC_{i + 1:04d}.dng")
        with open(path, "rb") as f:
            assert f.read() == want
        np.testing.assert_array_equal(frame.wb, np.float32([2.0, 1.0, 1.6]))
        np.testing.assert_array_equal(frame.xyz_to_cam,
                                      np.eye(3, dtype=np.float32))
        assert (frame.white, frame.black, frame.pattern) == (65535.0, 0.0,
                                                             None)
