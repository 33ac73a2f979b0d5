"""The port's CLI (``python -m raweditor_tpu_torch``) against the JAX CLI:
the same arguments through both ``main`` functions, on the CPU
(``RAWEDITOR_TPU_PLATFORM=cpu``), with the outputs held equal up to each
package's own output directory; pictures are compared decoded (previews
and develops within the lanes' 1 LSB, JPEGs of them within a small mean).
Also: the argparse surfaces and ``RANGES`` are equal, the commands of
modules not ported yet exit with "not ported yet" (the cases of wide
gamut and 16-bit TIFF, ported since, answer as the JAX CLI), and the two
faults of the JAX ``validate`` are not inherited."""

import io
import json
import sys

import numpy as np
import pytest
from PIL import Image

from raweditor_tpu.cli import main as jax_main
from raweditor_tpu.cli._parser import build_parser as jax_parser
from raweditor_tpu.params import RANGES as JAX_RANGES
from raweditor_tpu_torch.cli import main
from raweditor_tpu_torch.cli._parser import build_parser
from raweditor_tpu_torch.params import RANGES, EditParams
from raweditor_tpu_torch.raw.synth import write_synthetic_orf, write_synthetic_raw

NAMES = ("jax", "port")


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setenv("RAWEDITOR_TPU_PLATFORM", "cpu")


@pytest.fixture
def photos(tmp_path, rng):
    d = tmp_path / "photos"
    d.mkdir()
    for i in range(2):
        write_synthetic_raw(
            d / f"s{i}.nef",
            rng.integers(0, 4096, size=(24, 32), dtype=np.uint16))
    for name in NAMES:
        (tmp_path / name).mkdir()
    return d


def _both(capsys, tmp_path, *argv):
    """Run ``argv`` through the JAX CLI and the port's, with ``{D}`` in
    an argument standing for each package's own directory; returns
    [(exit code, stdout with that directory written as {D})] for each."""
    capsys.readouterr()  # what the test printed before
    out = []
    for name, entry in zip(NAMES, (jax_main, main)):
        d = str(tmp_path / name)
        code = entry([str(a).replace("{D}", d) for a in argv])
        out.append((code, capsys.readouterr().out.replace(d, "{D}")))
    return out


def _same(capsys, tmp_path, *argv):
    (jcode, jout), (pcode, pout) = _both(capsys, tmp_path, *argv)
    assert (pcode, pout) == (jcode, jout), argv
    return pout


def _pixels(path):
    with Image.open(path) as im:
        return np.asarray(im).astype(int)


def _close(tmp_path, rel, max_lsb=None, mean=0.05):
    """The two packages' output files ``{D}/rel``, decoded: equal shape,
    within ``max_lsb`` everywhere (lossless outputs) or a mean absolute
    difference under ``mean`` (JPEGs). Returns the largest difference."""
    a, b = (_pixels(tmp_path / name / rel) for name in NAMES)
    assert a.shape == b.shape
    d = np.abs(a - b)
    if max_lsb is not None:
        assert d.max() <= max_lsb, rel
    assert d.mean() < mean, rel
    return int(d.max())


def test_catalog_commands_answer_as_the_jax_cli(tmp_path, capsys, photos):
    db = "{D}/cat.db"
    _same(capsys, tmp_path, "--db", db, "import", photos,
          "--cache-dir", "{D}/cache")
    for argv in (["list"], ["list", "--json"],
                 ["edit", "1", "--exposure", "1.5", "--sharpen", "20"],
                 ["edit", "1"], ["edit", "2", "--curve", "0,0 0.5,0.6 1,1"],
                 ["rate", "1", "--stars", "4", "--flag", "pick"],
                 ["list", "--min-rating", "3", "--json"],
                 ["collect", "add", "best", "1", "2"],
                 ["collect", "list"], ["list", "--collection", "best"],
                 ["sidecar", "write"], ["sidecar", "apply"],
                 ["verify"], ["tiers", "--cache-dir", "{D}/cache"],
                 ["edit", "2", "--reset"]):
        _same(capsys, tmp_path, "--db", db, *argv)
    worst = max(_close(tmp_path, f"cache/{tier}/{i}.jpg", mean=0.5)
                for tier in ("thumb", "instant", "working") for i in (1, 2))
    with capsys.disabled():
        print(f"tier JPEGs: largest decoded difference {worst}")


def test_develop_commands_answer_as_the_jax_cli(tmp_path, capsys, photos):
    src = photos / "s0.nef"
    _same(capsys, tmp_path, "info", src)
    worst = {}
    for name, argv, lossless in (
            ("plain.png", ["--exposure", "0.5", "--sharpen", "30"], True),
            ("fast.png", ["--fast", "--mode", "accurate", "--demosaic",
                          "grad"], True),
            ("fast.jpg", ["--fast", "--quality", "90"], False),
            ("prev.png", ["--preview", "--zoom", "2.0", "--pan-x", "0.1"],
             True),
            ("opt.jpg", ["--optimize-jpeg", "--jpeg-restart", "2",
                         "--chroma", "444"], False)):
        _same(capsys, tmp_path, "develop", src, "-o", f"{{D}}/{name}", *argv)
        worst[name] = _close(tmp_path, name, max_lsb=1 if lossless else None)
    with capsys.disabled():
        print(f"develop outputs: largest decoded differences {worst}")
    for argv in (["histogram", src], ["histogram", src, "--ascii"],
                 ["histogram", src, "--zoom", "2", "--exposure", "-1"],
                 ["auto", src, "--dry-run"],
                 ["auto", src, "--levels", "--contrast", "--tone"]):
        _same(capsys, tmp_path, *argv)
    for comp in ("ljpeg", "raf", "orf"):
        _same(capsys, tmp_path, "synth", f"{{D}}/x.{comp}", "--width", "48",
              "--height", "32", "--compression", comp)
        a, b = ((tmp_path / n / f"x.{comp}").read_bytes() for n in NAMES)
        assert a == b
    _same(capsys, tmp_path, "convert", "{D}/x.ljpeg", "-o", "{D}/x.dng")


def test_catalog_develop_auto_and_export(tmp_path, capsys, photos):
    db = "{D}/cat.db"
    _same(capsys, tmp_path, "--db", db, "import", photos, "--no-tiers")
    _same(capsys, tmp_path, "--db", db, "edit", "1", "--exposure", "0.7")
    _same(capsys, tmp_path, "--db", db, "develop", "1", "-o", "{D}/id.png")
    _close(tmp_path, "id.png", max_lsb=1)
    _same(capsys, tmp_path, "--db", db, "histogram", "1")
    _same(capsys, tmp_path, "--db", db, "auto", "2")
    _same(capsys, tmp_path, "--db", db, "edit", "2")
    for argv, ext in ((["--ext", "png", "--batch-size", "2"], "png"),
                      (["--fast", "--ext", "jpg", "--exposure", "1.0"],
                       "jpg"),
                      (["--auto", "--auto-levels", "--decode-threads", "1",
                        "--ext", "png"], "png")):
        out = "{D}/out" + str(len(argv))
        (jcode, jout), (pcode, pout) = _both(
            capsys, tmp_path, "--db", db, "export", "-o", out, *argv)
        want, got = json.loads(jout), json.loads(pout)
        assert (pcode, jcode) == (0, 0)
        for key in ("total", "succeeded", "skipped", "failed"):
            assert got[key] == want[key], key
        for i in (0, 1):
            _close(tmp_path, f"out{len(argv)}/s{i}.{ext}",
                   max_lsb=1 if ext == "png" else None)
    (jcode, jout), (pcode, pout) = _both(
        capsys, tmp_path, "export", "-o", "{D}/missing", "--files",
        tmp_path / "nope.nef")
    assert pcode == jcode == 1
    assert json.loads(pout)["failed"] == json.loads(jout)["failed"] == 1
    with pytest.raises(SystemExit, match="--auto"):
        main(["export", "-o", str(tmp_path / "x"), "--files",
              str(photos / "s0.nef"), "--auto-levels"])


def test_session_command_answers_as_the_jax_cli(tmp_path, photos,
                                               monkeypatch):
    answers = []
    for name, entry in zip(NAMES, (jax_main, main)):
        monkeypatch.setattr(sys, "stdin", io.StringIO(
            "set exposure 1.0\ncheckpoint\nhistory\nlocal list\n"
            "histogram\nquit\n"))
        out = io.StringIO()
        monkeypatch.setattr(sys, "stdout", out)
        assert entry(["--db", str(tmp_path / name / "cat.db"), "session",
                      str(photos / "s0.nef"), "--no-pipeline"]) == 0
        answers.append([json.loads(x) for x in out.getvalue().splitlines()])
    monkeypatch.undo()
    want, got = answers
    for i, (w, g) in enumerate(zip(want, got)):
        w.pop("render_ms", None)
        g.pop("render_ms", None)
        if i == 3:  # `local`: the port answers that it is not ported
            assert w["ok"] and not g["ok"]
            assert g["error"].startswith("not ported yet")
            continue
        assert g == w, i


def test_warmup_and_doctor_on_the_cpu(capsys):
    assert main(["warmup", "--width", "64", "--height", "48",
                 "--batch-size", "2"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["device"] == "cpu" and out["width"] == 64
    names = [c["program"] for c in out["compiled"]]
    assert "build" not in names  # nothing is built for the CPU
    assert names == ["develop_rgba", "develop_rgba_bilinear",
                     "develop_rgba_malvar", "develop_rgba_grad",
                     "develop_rgba_cfa_nearest", "develop_rgba_cfa_smooth",
                     "develop_rgba_cfa_grad", "extras_rgba"]
    code = main(["doctor", "--probe"])
    report = json.loads(capsys.readouterr().out)
    checks = {c["check"]: c for c in report["checks"]}
    assert code == 0 and report["status"] == "warn"
    assert checks["device"]["status"] == "warn"  # the CPU is pinned
    assert "torch" in checks["versions"]["detail"]
    assert checks["probe"]["status"] == "ok"
    assert "jax" not in json.dumps(report)


def test_parser_surface_and_ranges_equal_the_jax_cli():
    assert RANGES == JAX_RANGES
    assert list(RANGES) == list(JAX_RANGES)
    assert set(RANGES) == set(EditParams.field_names())
    ours, theirs = build_parser(), jax_parser()
    assert ours.format_help() == theirs.format_help()

    def subs(ap):
        return next(a for a in ap._actions
                    if hasattr(a, "choices") and a.choices).choices

    assert list(subs(ours)) == list(subs(theirs))
    assert len(subs(ours)) == 22
    for name, p in subs(ours).items():
        assert p.format_help() == subs(theirs)[name].format_help(), name


@pytest.mark.parametrize("argv, message", [
    (["preset", "list"], "preset: not ported yet: raweditor_tpu_torch.presets"),
    (["develop", "{P}", "-o", "{T}/a.jpg", "--preset", "vivid"],
     "develop: not ported yet: raweditor_tpu_torch.presets"),
    (["develop", "{P}", "-o", "{T}/a.jpg", "--local", "linear:x0=0.5"],
     "develop: not ported yet: raweditor_tpu_torch.ops.local_adjust"),
    (["develop", "{P}", "-o", "{T}/a.jpg", "--color-space", "display-p3"],
     "develop: not ported yet: color_space 'display-p3'"),
    (["develop", "{P}", "-o", "{T}/a.jpg", "--rotate", "5"],
     "develop: not ported yet: rotate"),
    (["develop", "{P}", "-o", "{T}/a.tif"],
     "develop: not ported yet: 16-bit TIFF export"),
    (["export", "-o", "{T}/o", "--files", "{P}", "--ext", "tif"],
     "export: not ported yet: bits=16"),
    (["export", "-o", "{T}/o", "--files", "{P}", "--long-edge", "16"],
     "export: not ported yet: long_edge"),
    (["export", "-o", "{T}/o", "--files", "{P}", "--num-hosts", "2",
      "--coordinator", "localhost:1"], "export: not ported yet: --num-hosts"),
    (["export", "-o", "{T}/o", "--files", "{P}", "--mesh-rows", "2"],
     "export: not ported yet: --mesh-rows"),
    (["bench"], "bench: not ported yet: bench"),
])
def test_unported_commands_exit_with_a_message(argv, message, tmp_path,
                                               photos, capsys):
    if message in NOW_PORTED:
        # Wide gamut, 16-bit TIFF, the geometry and the long-edge resize
        # are ported: the command answers as the JAX CLI's and writes its
        # picture (develop: the ICC profile equal and the JPEG decoded
        # close; TIFFs within 1 LSB of u16); the geometry and resize
        # files equal the port engine's export of the same arguments.
        argv = [a.replace("{P}", str(photos / "s0.nef")).replace(
            "{T}", "{D}") for a in argv] + NOW_PORTED[message]
        (jcode, jout), (pcode, pout) = _both(capsys, tmp_path, *argv)
        assert pcode == jcode == 0
        if argv[0] == "export":
            want, got = json.loads(jout), json.loads(pout)
            for key in ("total", "succeeded", "skipped", "failed"):
                assert got[key] == want[key] == (key in ("total",
                                                         "succeeded")), key
            rel = "o/s0." + ("tif" if "tif" in argv else "jpg")
        else:
            assert pout == jout
            rel = argv[3].replace("{D}/", "")
        if rel.endswith(".tif"):
            a, b = (_tiff_pixels(tmp_path / n / rel) for n in NAMES)
            assert a.shape == b.shape == (24, 32, 3)
            assert np.abs(a - b).max() <= 1
        else:
            _close(tmp_path, rel)
        icc = [Image.open(tmp_path / n / rel).info.get("icc_profile")
               for n in NAMES if not rel.endswith(".tif")]
        if "color_space" in message:
            assert icc[0] and icc[0] == icc[1]
        if message in ENGINE_FILE:
            _engine_writes_the_cli_file(photos / "s0.nef", tmp_path, rel,
                                        ENGINE_FILE[message])
        return
    argv = [a.replace("{P}", str(photos / "s0.nef")).replace(
        "{T}", str(tmp_path)) for a in argv]
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert str(e.value.code).startswith(message)


def _tiff_pixels(path):
    """(H, W, 3) int pixels of a 16-bit RGB TIFF, through the port's
    TIFF walker (PIL reads no 16-bit RGB)."""
    from raweditor_tpu_torch.raw import tiff as T

    data = path.read_bytes()
    ifd = T.TiffFile(data).ifds[0]
    off = ifd.get_scalar(T.STRIP_OFFSETS)
    h, w = ifd.get_scalar(T.IMAGE_LENGTH), ifd.get_scalar(T.IMAGE_WIDTH)
    return np.frombuffer(data[off:off + h * w * 6], "<u2").reshape(
        h, w, 3).astype(int)


# Cases of the test above that are ported now, with the arguments the
# check adds (a wide space needs accurate mode).
NOW_PORTED = {
    "develop: not ported yet: color_space 'display-p3'": ["--mode",
                                                          "accurate"],
    "develop: not ported yet: rotate": [],
    "develop: not ported yet: 16-bit TIFF export": [],
    "export: not ported yet: bits=16": [],
    "export: not ported yet: long_edge": [],
}
# Of those, the cases whose file must equal the port engine's export with
# these keywords (and the CLI's default quality).
ENGINE_FILE = {
    "develop: not ported yet: rotate": dict(rotate=5.0),
    "export: not ported yet: long_edge": dict(long_edge=16),
}


def _engine_writes_the_cli_file(photo, tmp_path, rel, kw):
    """The port CLI's file equals ``DevelopEngine.open(photo).export`` of
    the default edit with ``kw``, byte for byte; for ``long_edge`` the
    picture is the resized one."""
    from raweditor_tpu_torch import DevelopEngine
    from raweditor_tpu_torch.utils.config import Config

    eng = DevelopEngine.open(photo)
    ref = eng.export(tmp_path / ("engine" + rel[-4:]), EditParams(),
                     quality=Config.from_env().jpeg_quality, **kw)
    data = (tmp_path / "port" / rel).read_bytes()
    assert open(ref, "rb").read() == data
    if "long_edge" in kw:
        assert Image.open(io.BytesIO(data)).size == (16, 12)


def test_an_import_error_inside_the_port_is_not_called_unported(
        monkeypatch):
    """Only a module of the port that does not exist reads as "not
    ported yet"; an import that fails inside one that exists is raised."""
    from raweditor_tpu_torch import cli

    def broken(args):
        from raweditor_tpu_torch.params import NO_SUCH_NAME  # noqa: F401

    monkeypatch.setitem(cli._COMMANDS, "verify", broken)
    with pytest.raises(ImportError, match="NO_SUCH_NAME"):
        main(["verify"])


# -- validate, with the two faults of the JAX module repaired -------------

def _scene(h=96, w=128):
    yy, xx = np.mgrid[0:h, 0:w]
    v = (xx / w + yy / h) / 2.0
    v += 0.4 * np.exp(-(((yy - h / 3) / (h / 6)) ** 2
                        + ((xx - w / 3) / (w / 6)) ** 2))
    return (200 + v / v.max() * 3600).astype(np.uint16)


def _corpus(tmp_path):
    """Two files (one in a subfolder) and a manifest: one entry whose
    expected codec is not the file's, one missing entry."""
    root = tmp_path / "corpus"
    (root / "nikon").mkdir(parents=True)
    write_synthetic_raw(root / "nikon" / "a.nef", _scene(),
                        compression="nikon")
    write_synthetic_orf(root / "b.orf", _scene(64, 96))
    manifest = tmp_path / "manifest.json"
    manifest.write_text(json.dumps({"name": "t", "files": [
        {"file": "nikon/a.nef", "codec": "nef"},
        {"file": "b.orf", "codec": "nef"},
        {"file": "missing.arw", "codec": "arw"}]}))
    return root, manifest


def test_validate_dir_answers_as_the_jax_cli(tmp_path, capsys):
    root, _ = _corpus(tmp_path)
    for argv in ([], ["--no-recursive"], ["--limit", "1", "--threads", "2"]):
        (jcode, jout), (pcode, pout) = _both(
            capsys, tmp_path, "validate", root, "--per-file", *argv)
        want, got = json.loads(jout), json.loads(pout)
        assert pcode == jcode
        assert got["summary"] == want["summary"] and \
            got["per_codec"] == want["per_codec"]
        for g, w in zip(got["files"], want["files"]):
            assert abs(g.pop("correlation") - w.pop("correlation")) < 1e-3
            assert g == w


def test_validate_manifest_checks_the_expected_codec(tmp_path, capsys):
    """The manifest says b.orf is a "nef": the port reports a codec
    mismatch; the JAX check overwrote the expected codec with the file's
    own before comparing and passed it."""
    root, manifest = _corpus(tmp_path)
    (jcode, jout), (pcode, pout) = _both(
        capsys, tmp_path, "validate", root, "--manifest", manifest,
        "--per-file")
    want = {r["file"]: r for r in json.loads(jout)["files"]}
    got = {r["file"]: r for r in json.loads(pout)["files"]}
    assert want["b.orf"]["status"] == "ok" and want["b.orf"]["codec"] == "orf"
    assert got["b.orf"]["status"] == "codec_mismatch"
    assert got["b.orf"]["codec"] == "nef" and got["b.orf"]["got_codec"] == "orf"
    assert got["nikon/a.nef"]["status"] == "ok"
    assert got["missing.arw"]["status"] == "missing"
    assert pcode == jcode == 1  # the missing entry fails both runs
    assert json.loads(pout)["per_codec"]["nef"] == {"ok": 1,
                                                    "codec_mismatch": 1}


@pytest.mark.parametrize("argv, files", [
    (["--limit", "1"], ["nikon/a.nef"]),
    (["--no-recursive"], ["b.orf", "missing.arw"]),
    (["--no-recursive", "--limit", "1", "--threads", "2"], ["b.orf"]),
    (["--threads", "3"], ["nikon/a.nef", "b.orf", "missing.arw"]),
])
def test_validate_manifest_honours_limit_recursion_and_threads(
        argv, files, tmp_path, capsys):
    """The JAX CLI ignores ``--limit``, ``--no-recursive`` and
    ``--threads`` under ``--manifest`` (every entry, one thread); the
    port applies them as in directory mode."""
    root, manifest = _corpus(tmp_path)
    (_, jout), (_, pout) = _both(capsys, tmp_path, "validate", root,
                                 "--manifest", manifest, "--per-file", *argv)
    assert [r["file"] for r in json.loads(jout)["files"]] == [
        "nikon/a.nef", "b.orf", "missing.arw"]
    assert [r["file"] for r in json.loads(pout)["files"]] == files
