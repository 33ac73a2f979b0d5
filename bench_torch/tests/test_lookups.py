"""A configuration and a traffic mix are each added as new files alone:
the harness finds a configuration's container writer, reference and
rehearsal frame by name from its own file, and forms a cell of a
configuration and a mix wherever the configuration's reference gives
what the mix's driver checks with. Here a configuration, a container
module, a reference module and a mix live in a temporary directory,
reached by redirecting the lookups (``core.CONFIGS``, ``core.TRAFFIC``,
the ``bench_torch.containers`` package's path, ``sys.path`` for the
configuration's ``reference``); nothing is written into ``bench_torch/``.
Then the files ``write_files`` writes for the benchmark's own
configurations are held, byte for byte, to the frozen writers called
directly."""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import bench_torch.containers
from bench_torch import core, rehearse
from bench_torch.containers import dng
from bench_torch.drivers import files
from bench_torch.yardstick.raw import raf, synth
from bench_torch.yardstick.scene import scene

SEED = 2**31 + 29
ADDED = "tiny_strip"
MIX = "export_halves"  # a mix added beside the repo's
FRAME = (56, 88)  # the added configuration's own, like no other's

CONTAINER = '''"""An uncompressed one-strip Bayer DNG, each write noted."""
from bench_torch.containers import dng

NAME = "STRIP_{:04d}.dng"
base, frame = dng.base, dng.frame


def write(path, mosaic, cfg, device):
    dng.write(path, mosaic, cfg, device)
    with open(__file__ + ".log", "a") as f:
        f.write(f"{mosaic.shape}\\n")
'''
# The export check's entry point alone: no slider session is checked.
REFERENCE = '''"""The yardstick's export reference, each exported file noted."""
from bench_torch.yardstick import reference as _ref


def export_planes(*args, **kwargs):
    with open(__file__ + ".log", "a") as f:
        f.write("export_planes\\n")
    return _ref.export_planes(*args, **kwargs)
'''


def _config(name):
    return core.load_json(core.PKG / "configs" / f"{name}.json")


@pytest.fixture
def added(tmp_path, monkeypatch):
    """The repo's configurations and ``tiny_strip`` in a temporary
    ``configs/``, the repo's mixes and ``export_halves`` in a temporary
    ``traffic/``; the container ``strip`` and the reference module
    ``reference_strip`` beside them."""
    configs, traffic = tmp_path / "configs", tmp_path / "traffic"
    shutil.copytree(core.PKG / "configs", configs)
    shutil.copytree(core.PKG / "traffic", traffic)
    mix = core.load_json(traffic / "export.json")
    mix.update(extras_every=2, window_images_per_s=2.5)
    (traffic / f"{MIX}.json").write_text(json.dumps(mix))
    (tmp_path / "containers").mkdir()
    (tmp_path / "containers" / "strip.py").write_text(CONTAINER)
    (tmp_path / "reference_strip.py").write_text(REFERENCE)
    cfg = _config("d3300_dng")
    del cfg["tile_size"]
    cfg.update(name=ADDED, container="strip", compression="none",
               reference="reference_strip.py",
               rehearsal={"frame": list(FRAME)})

    def write_config(**change):
        (configs / f"{ADDED}.json").write_text(json.dumps(dict(cfg,
                                                              **change)))

    write_config()
    monkeypatch.setattr(core, "CONFIGS", configs)
    monkeypatch.setattr(core, "TRAFFIC", traffic)
    monkeypatch.syspath_prepend(str(tmp_path))
    pkg = bench_torch.containers
    monkeypatch.setattr(pkg, "__path__",
                        [*pkg.__path__, str(tmp_path / "containers")])
    try:
        yield tmp_path, write_config
    finally:
        for name in ("bench_torch.containers.strip", "reference_strip"):
            sys.modules.pop(name, None)
        if hasattr(pkg, "strip"):
            delattr(pkg, "strip")


def test_the_repo_rehearses_its_four_cells():
    assert core.folder_cells() == ["d3300_dng.edit", "d3300_dng.export",
                                   "xt2_raf.edit", "xt2_raf.export"]


def test_cells_follow_what_the_references_give(added, monkeypatch):
    """The added mix runs on every configuration, the repo's two with
    their files untouched; the added configuration, whose reference
    gives no slider check, runs under the export mixes alone."""
    tmp_path, _ = added
    assert core.folder_cells() == [
        "d3300_dng.edit", "d3300_dng.export", f"d3300_dng.{MIX}",
        f"{ADDED}.export", f"{ADDED}.{MIX}",
        "xt2_raf.edit", "xt2_raf.export", f"xt2_raf.{MIX}"]
    for path in (core.PKG / "configs").glob("*.json"):
        assert (tmp_path / "configs" / path.name).read_bytes() == \
            path.read_bytes()
    unserved = (f"{ADDED!r}: its reference reference_strip.py gives no "
                r"\['preview', 'preview_planes', 'histogram', 'bin_shift'\]")
    with pytest.raises(LookupError, match=unserved):
        core.any_cell(f"{ADDED}.edit")
    # A cell of the benchmark file whose configuration's reference does
    # not serve its mix is refused as well.
    bench = dict(core.benchmark(), configs=[
        {"name": ADDED, "file": str(tmp_path / "configs" / f"{ADDED}.json")}],
        workloads=[{"name": f"{ADDED}.edit", "config": ADDED,
                    "traffic": "edit", "chips": 1}])
    monkeypatch.setattr(core, "benchmark", lambda: bench)
    with pytest.raises(LookupError, match=unserved):
        core.find_cell(f"{ADDED}.edit")


def test_the_rehearsal_writes_and_checks_the_added_configuration(added):
    tmp_path, _ = added
    out = rehearse.rehearse_cell(f"{ADDED}.export", SEED, traced=False)
    assert out["correct"], out["checks"]
    written = (tmp_path / "containers" / "strip.py.log").read_text()
    checked = (tmp_path / "reference_strip.py.log").read_text()
    assert written.split("\n")[:-1] == [str(FRAME)] * 4
    assert checked.split("\n")[:-1] == ["export_planes"] * 4


def test_the_rehearsal_runs_the_added_mix_on_a_repo_configuration(added):
    tmp_path, _ = added
    found = core.any_cell(f"d3300_dng.{MIX}")
    assert found[3] == core.load_json(tmp_path / "traffic" / f"{MIX}.json")
    out = rehearse.rehearse_cell(f"d3300_dng.{MIX}", SEED, traced=False)
    assert out["correct"], out["checks"]


MISSING = {
    "container": ({"container": "nosuch"}, "bench_torch.containers.nosuch"),
    "reference": ({"reference": "bench_torch/yardstick/nosuch.py"},
                  "bench_torch.yardstick.nosuch"),
    "rehearsal_frame": ({"rehearsal": {}}, "rehearsal.frame"),
}


@pytest.mark.parametrize("what", sorted(MISSING))
def test_a_missing_lookup_fails_naming_it(added, what):
    _, write_config = added
    change, named = MISSING[what]
    write_config(**change)
    with pytest.raises(LookupError) as e:
        rehearse.rehearse_cell(f"{ADDED}.export", SEED, traced=False)
    assert named in str(e.value) and repr(ADDED) in str(e.value)


@pytest.mark.parametrize("name", ["d3300_dng", "xt2_raf"])
def test_write_files_gives_the_frozen_writers_files(tmp_path, name):
    """At the rehearsal frame and a fixed seed: the seeded scene rolled
    by (97 i, 211 i), written as the frozen writer writes it alone, under
    the camera's file name, with the frame the decoder must read back."""
    cfg = _config(name)
    out = files.write_files(cfg, tmp_path, 3, np.random.default_rng(11),
                            rehearse.rehearsal_of(cfg), torch.device("cpu"))
    h, w = cfg["rehearsal"]["frame"]
    base = scene(np.random.default_rng(11), h, w, (1 << cfg["bits"]) - 1)
    matrix = np.array(cfg["xyz_to_cam_x10000"], np.float32) / 10000.0
    for i, (path, frame) in enumerate(out):
        mosaic = np.roll(base, (97 * i, 211 * i), axis=(0, 1))
        assert np.array_equal(frame.mosaic, mosaic)
        if name == "d3300_dng":
            want = synth.write_synthetic_raw(
                None, mosaic, bpp=12, compression="ljpeg",
                wb_neutral=tuple(cfg["wb_neutral"]), xyz_to_cam=matrix,
                black_level=150, white_level=4095,
                make="NIKON CORPORATION", model="NIKON D3300",
                preview_jpeg=dng.PREVIEW_JPEG,
                cfa="RGGB", tile_size=(256, 256))
            assert os.path.basename(path) == f"DSC_{i + 1:04d}.dng"
            wb, white, black = [2.0, 1.0, 1.6], 4095.0, 150.0
            assert (frame.phase, frame.pattern) == ((0, 0), None)
        else:
            want = raf.write_raf(mosaic, model="X-T2",
                                 wb_grbg=(256, 512, 384, 256))
            assert os.path.basename(path) == f"DSCF{i + 1:04d}.RAF"
            wb, white, black = [2.0, 1.0, 1.5], float(mosaic.max()), 0.0
            matrix = np.eye(3, dtype=np.float32)
            assert frame.pattern == cfg["cfa"]
        with open(path, "rb") as f:
            assert f.read() == want
        np.testing.assert_array_equal(frame.wb, np.float32(wb))
        np.testing.assert_array_equal(frame.xyz_to_cam, matrix)
        assert (frame.white, frame.black) == (white, black)
