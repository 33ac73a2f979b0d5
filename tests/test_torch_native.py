"""The port's native loader keeps the JAX package's contract, and the
atomic write has the JAX signature.

- ``get_rawkit()`` returns the ``_rawkit`` module, or None when
  ``RAWEDITOR_TPU_NO_NATIVE`` is set or the file is missing, as
  ``raweditor_tpu.native.get_rawkit`` does; the decoders then take their
  pure-Python codecs.
- ``require_rawkit()`` (the JFIF encoder's) raises naming the file, so an
  export never degrades quietly.
- ``pipeline/export._atomic_write(out_path, write_fn)`` leaves no
  temporary file behind and makes the parent directory.
"""

import os

import numpy as np
import pytest

import raweditor_tpu.native as jax_native
import raweditor_tpu_torch.native as native
from raweditor_tpu_torch import DevelopEngine, EditParams, RawImage
from raweditor_tpu_torch.pipeline.export import _atomic_write


@pytest.fixture
def fresh(monkeypatch):
    """Both packages' loaders with their cached answers cleared (one
    variable switches both); monkeypatch restores them afterwards."""
    for mod in (native, jax_native):
        monkeypatch.setattr(mod, "_tried", False)
        monkeypatch.setattr(mod, "_cached", None)
    monkeypatch.delenv("RAWEDITOR_TPU_NO_NATIVE", raising=False)
    return monkeypatch


@pytest.mark.parametrize("no_native", [False, True])
def test_get_rawkit_honours_the_variable_like_jax(fresh, no_native):
    if no_native:
        fresh.setenv("RAWEDITOR_TPU_NO_NATIVE", "1")
    got, want = native.get_rawkit(), jax_native.get_rawkit()
    assert (got is None) == (want is None) == no_native
    if not no_native:
        assert got.__name__ == "_rawkit"
        assert set(jax_native.REQUIRED_EXPORTS) <= set(dir(got))
    # The answer is cached until the state is reset, as in JAX.
    fresh.setenv("RAWEDITOR_TPU_NO_NATIVE", "" if no_native else "1")
    assert (native.get_rawkit() is None) == no_native


def test_require_rawkit_ignores_the_variable(fresh):
    fresh.setenv("RAWEDITOR_TPU_NO_NATIVE", "1")
    assert native.get_rawkit() is None
    assert hasattr(native.require_rawkit(), "encode_jpeg_420")


def test_missing_extension(fresh, tmp_path):
    """With no extension file: get_rawkit() is None, require_rawkit()
    raises naming the file it looked for, and a JPEG export raises."""
    fresh.setattr(native, "NATIVE_DIR", tmp_path)
    fresh.setattr(native, "_module", None)
    assert native.get_rawkit() is None
    with pytest.raises(FileNotFoundError) as err:
        native.require_rawkit()
    assert str(tmp_path / "_rawkit") in str(err.value)
    rng = np.random.default_rng(7)
    raw = RawImage(rng.integers(0, 4096, (32, 48), dtype=np.uint16),
                   np.ones(4, np.float32), np.eye(3, dtype=np.float32))
    eng = DevelopEngine(raw, device="cpu")
    with pytest.raises(FileNotFoundError):
        eng.export(tmp_path / "out.jpg", EditParams())
    assert not (tmp_path / "out.jpg").exists()


def test_atomic_write_makes_the_directory(tmp_path):
    out = tmp_path / "a" / "b" / "out.bin"
    seen = []

    def write(tmp):
        seen.append(tmp)
        with open(tmp, "wb") as f:
            f.write(b"payload")

    _atomic_write(str(out), write)
    assert out.read_bytes() == b"payload"
    assert os.path.basename(seen[0]).startswith(f"out.bin.{os.getpid()}.")
    assert [p.name for p in out.parent.iterdir()] == ["out.bin"]


def test_atomic_write_leaves_nothing_when_the_writer_raises(tmp_path):
    out = tmp_path / "out.bin"
    out.write_bytes(b"old")

    def write(tmp):
        with open(tmp, "wb") as f:
            f.write(b"half")
        raise OSError("disk full")

    with pytest.raises(OSError, match="disk full"):
        _atomic_write(str(out), write)
    assert out.read_bytes() == b"old"
    assert [p.name for p in tmp_path.iterdir()] == ["out.bin"]


def test_engine_and_dng_writer_share_the_jax_signature():
    import inspect

    from raweditor_tpu.pipeline import export as jax_export
    from raweditor_tpu_torch.pipeline import engine

    assert engine._atomic_write is _atomic_write
    assert (inspect.signature(_atomic_write)
            == inspect.signature(jax_export._atomic_write))
