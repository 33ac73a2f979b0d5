"""Every frozen copy under ``bench_torch/`` equals its source as it stood
at the commit ``COPIES.json`` names: a whole-file copy once its import
prefix is rewritten back, a span copy verbatim at its lines. The source
may move on; the copy may not."""

import hashlib
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads(
    (ROOT / "bench_torch" / "yardstick" / "COPIES.json").read_text())


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


@pytest.mark.parametrize("entry", MANIFEST["copies"],
                         ids=lambda e: f"{e['copy']}:{e['lines'][0]}")
def test_copy_equals_its_source_at_the_commit(entry):
    text = (ROOT / entry["copy"]).read_text()
    if "rewrite" in entry:
        old, new = entry["rewrite"]
        assert old not in text, "a copy must not name the program"
        text = text.replace(new, old)
    else:
        a, b = entry["copy_lines"]
        text = "".join(text.splitlines(keepends=True)[a - 1:b])
    a, b = entry["lines"]
    assert _sha(text) == entry["sha256"], (
        f"{entry['copy']} differs from {entry['source']}:{a}-{b} at "
        f"{MANIFEST['commit'][:12]}")


def _imports(path):
    import ast

    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_nothing_under_the_benchmark_imports_jax_or_the_jax_package():
    for path in (ROOT / "bench_torch").rglob("*.py"):
        for n in _imports(path):
            assert n.split(".")[0] not in ("jax", "jaxlib", "raweditor_tpu"), (
                f"{path.relative_to(ROOT)} imports {n}")


def test_the_yardstick_imports_nothing_of_the_program():
    """The reference, the writers and the bounds take nothing from the
    system under test."""
    for path in (ROOT / "bench_torch" / "yardstick").rglob("*.py"):
        for n in _imports(path):
            assert not n.startswith("raweditor_tpu"), (
                f"{path.relative_to(ROOT)} imports {n}")


# Calls that load code from a file named at run time, not by import.
FILE_LOADERS = ("spec_from_file_location", "ExtensionFileLoader",
                "load_dynamic", "CDLL", "LoadLibrary", "PyDLL", "dlopen",
                "load_library", "cpp_extension")


def _strings_and_calls(path):
    """(string constants that are not docstrings, names of called
    functions) of one source file."""
    import ast

    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                docs.add(id(first.value))
    strings, calls = [], []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            strings.append(node.value)
        elif isinstance(node, ast.Call):
            f = node.func
            calls.append(f.attr if isinstance(f, ast.Attribute) else
                         getattr(f, "id", ""))
        elif isinstance(node, ast.Attribute) and node.attr in FILE_LOADERS:
            calls.append(node.attr)
    return strings, calls


def test_nothing_under_the_benchmark_loads_code_by_file_path():
    """No load of native or Python code by its path, in what a run of the
    benchmark executes (all but these tests), reaches the JAX package or
    the program: no string names the JAX package's folder (but for
    ``run.BARRED``, the modules a run refuses to hold), and only
    ``core.py`` loads by path, the metric readers beside it."""
    import re

    from bench_torch import run

    jax_dir = re.compile(r"raweditor_tpu(?!_torch)\b")
    tests = ROOT / "bench_torch" / "tests"
    for path in (ROOT / "bench_torch").rglob("*.py"):
        if tests in path.parents:
            continue
        rel = path.relative_to(ROOT)
        strings, calls = _strings_and_calls(path)
        for s in strings:
            barred = rel.as_posix() == "bench_torch/run.py" and s in run.BARRED
            assert barred or not jax_dir.search(s), f"{rel} names {s!r}"
            assert not s.endswith((".so", ".dll", ".dylib")), (
                f"{rel} names a shared library {s!r}")
        loads = sorted(set(calls) & set(FILE_LOADERS))
        if rel.as_posix() == "bench_torch/core.py":
            assert loads == ["spec_from_file_location"], loads
        else:
            assert not loads, f"{rel} loads code by file path: {loads}"


@pytest.mark.parametrize("name", ["jax", "jaxlib.xla_client", "flax",
                                  "raweditor_tpu.ops"])
def test_a_run_that_holds_jax_prints_no_result(monkeypatch, capsys, name):
    """A run whose process holds JAX or the JAX package once the window
    has closed exits non-zero, names it, and prints no result."""
    import types

    import torch

    from bench_torch import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run.core, "set_cache_dirs", lambda: None)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: {"checks": {}})
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    rc = run.main(["--workload", "d3300_dng.export", "--seed", "1",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert repr(name.partition(".")[0]) in out.err


def test_the_jax_package_folder_check_sees_a_load_by_path(tmp_path):
    """The scan above finds the load this benchmark once made."""
    src = tmp_path / "loader.py"
    src.write_text(
        "import importlib.machinery\n"
        "d = ROOT / 'raweditor_tpu' / 'native'\n"
        "importlib.machinery.ExtensionFileLoader('_rawkit', str(d))\n")
    strings, calls = _strings_and_calls(src)
    assert "raweditor_tpu" in strings
    assert "ExtensionFileLoader" in calls


def test_the_numpy_packer_gives_the_copied_writer_its_bytes():
    """``yardstick/native.pack`` against the copied NumPy path
    (``raw/bitpack``) on residuals of every category, 16 included."""
    import numpy as np

    from bench_torch.yardstick import native
    from bench_torch.yardstick.raw import bitpack, ljpeg

    codes = ljpeg._canonical_codes([0] + ljpeg._ENC_BITS[1:],
                                   ljpeg._ENC_VALUES)
    code_tab = np.zeros(17, np.uint64)
    clen_tab = np.zeros(17, np.int64)
    for s, (code, length) in codes.items():
        code_tab[s], clen_tab[s] = code, length
    rng = np.random.default_rng(7)
    for n in (1, 5, 999, 20000):
        wide = rng.integers(-32768, 32768, n)
        d = np.where(rng.random(n) < 0.6, wide % 64 - 32, wide)
        d[0] = -32768
        d = d.astype(np.int16)
        cats = bitpack.category_of(d)
        raws = np.where(cats > 15, 0, bitpack.raw_bits_of(d, cats))
        want = bitpack.interleave_code_and_raw(
            code_tab[cats], clen_tab[cats], raws, np.where(cats > 15, 0, cats))
        got = native.pack(d, code_tab, clen_tab.astype(np.int32), 15)
        assert got == want, n


@pytest.mark.parametrize("shape", [(64, 96), (300, 530)])
def test_tiles_packed_ahead_give_the_copied_writer_its_file(tmp_path, shape):
    """A DNG written with its tiles packed ahead on the device
    (``drivers/files.write_files``) equals, byte for byte, the one the
    copied writer makes alone, over edge tiles of every size."""
    import numpy as np
    import torch

    from bench_torch.containers import dng
    from bench_torch.drivers import files
    from bench_torch.yardstick import native
    from bench_torch.yardstick.raw import synth

    cfg = json.loads((ROOT / "bench_torch" / "configs" /
                      "d3300_dng.json").read_text())
    out = files.write_files(cfg, tmp_path, 2, np.random.default_rng(11),
                            {"frame": {"d3300_dng": shape}},
                            torch.device("cpu"))
    native.forget()
    for path, frame in out:
        alone = synth.write_synthetic_raw(
            None, frame.mosaic, bpp=cfg["bits"], compression="ljpeg",
            wb_neutral=tuple(cfg["wb_neutral"]), xyz_to_cam=dng.matrix(cfg),
            black_level=cfg["black_level"], white_level=cfg["white_level"],
            make=cfg["camera"]["make"], model=cfg["camera"]["model"],
            preview_jpeg=dng.PREVIEW_JPEG, cfa=cfg["cfa"],
            tile_size=tuple(cfg["tile_size"]))
        with open(path, "rb") as f:
            assert f.read() == alone
