"""The port imports neither jax nor the JAX package: the card's machine
has no jax, and importing any ``raweditor_tpu`` module imports jax."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "raweditor_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "raweditor_tpu")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    src = path.read_text()
    bad = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0 and _forbidden(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and _forbidden(str(node.args[0].value))):
            bad.append(node.args[0].value)
    assert not bad, f"{path.name} imports {bad}"
    for line in src.splitlines():
        s = line.strip()
        assert not s.startswith(("import jax", "from jax")), line


def test_guard_catches_violations(tmp_path):
    for src in ("import jax.numpy as jnp\n",
                "from raweditor_tpu.ops import develop\n",
                "def f():\n    import raweditor_tpu\n"):
        tree = ast.parse(src)
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names] + [n.module for n in ast.walk(tree)
                                      if isinstance(n, ast.ImportFrom)]
        assert any(_forbidden(n) for n in names), src
    assert not _forbidden("raweditor_tpu_torch.ops")


# Host-side modules of the JAX package that import no jax are kept in the
# port as copies with the package name rewritten; the copies must not
# drift from their sources.
COPIES = [
    "version.py", "utils/logging.py", "xmp.py",
    # the batch exporter's helpers
    "utils/config.py", "utils/memory.py", "utils/timing.py",
    "catalog/__init__.py", "catalog/data.py", "catalog/library.py",
    # containers and bit-level codecs
    "raw/exif.py", "raw/tiff.py", "raw/bitpack.py", "raw/packing.py",
    "raw/ljpeg.py", "raw/jpeg_scan.py",
    "raw/decode.py",
    # per-maker decoders
    "raw/nikon.py", "raw/nikon_crypt.py", "raw/olympus.py", "raw/pentax.py",
    "raw/panasonic.py", "raw/samsung.py", "raw/samsung3.py", "raw/arw2.py",
    "raw/kodak.py", "raw/kodak_radc.py", "raw/raf.py", "raw/ciff.py",
    "raw/bmff.py", "raw/crx.py",
    # writers (test files and the card run's files)
    "raw/synth.py", "raw/tiff_out.py", "raw/dng_out.py",
]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_source_after_the_rename(rel):
    source = (ROOT / "raweditor_tpu" / rel).read_text()
    copy = ROOT / "raweditor_tpu_torch" / rel
    assert copy in PORT_FILES  # so the import guard above reads it too
    assert copy.read_text() == source.replace("raweditor_tpu.",
                                              "raweditor_tpu_torch.")
    assert "raweditor_tpu." not in copy.read_text().replace(
        "raweditor_tpu_torch.", "")


def test_raw_image_fields_equal_the_jax_ones():
    """``raw/types.py`` stays the port's own (it adds ``from_fields``),
    so its fields are held to the JAX container's, names and order: the
    copied decoders build it by keyword."""
    import dataclasses

    from raweditor_tpu.raw.types import RawImage as JaxRaw
    from raweditor_tpu_torch.raw.types import RawImage

    def names(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert names(RawImage) == names(JaxRaw)
    for coeffs in ([2.0, 1.0, 1.5], [1.9, 0.0, 1.2, float("nan")], [],
                   [512, 256, 384, -1]):
        assert (RawImage.normalize_wb(coeffs).tobytes()
                == JaxRaw.normalize_wb(coeffs).tobytes())


def test_xtrans_pattern_equals_the_jax_constant():
    """``raw/decode.py`` gives RAF frames the pattern of the port's
    ``ops/cfa_generic``, so it must be the JAX package's."""
    from raweditor_tpu.ops.cfa_generic import XTRANS_PATTERN as JAX_PATTERN
    from raweditor_tpu_torch.ops.cfa_generic import XTRANS_PATTERN

    assert XTRANS_PATTERN == JAX_PATTERN and len(XTRANS_PATTERN) == 36
