"""The shared native extension ``_rawkit`` (JFIF encoder and the RAW
codecs), loaded by file path.

The compiled module lives in the JAX package's tree
(``raweditor_tpu/native/_rawkit.*.so``, built from ``rawkit.cpp``) and is
a plain CPython extension with no JAX in it. Importing it as
``raweditor_tpu.native._rawkit`` would run ``raweditor_tpu/__init__.py``,
which imports jax, so the port loads the file directly under the name
``_rawkit``.

Two entry points, for two kinds of caller:

- ``get_rawkit()`` keeps the JAX package's contract, which the decoders
  under ``raw/`` are written against: the module, or None when the file
  is missing or ``RAWEDITOR_TPU_NO_NATIVE`` is set, and the caller then
  takes its pure-Python codec (the same results; the tests hold the two
  equal). The answer is cached in ``_tried``/``_cached``, which a test
  resets after changing the variable.
- ``require_rawkit()`` is for the JFIF encoder, which has no Python
  form: it returns the module whatever the variable says, or raises
  ``FileNotFoundError`` naming the file it looked for, so an export never
  degrades quietly.
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import os
import threading
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent.parent / "raweditor_tpu" / "native"

_lock = threading.Lock()
_module = None  # the loaded extension, whatever the variable says
_cached = None  # get_rawkit()'s answer once _tried
_tried = False


def rawkit_path() -> Path:
    """The extension file for this interpreter; raises
    ``FileNotFoundError`` naming it when it is absent."""
    for suffix in importlib.machinery.EXTENSION_SUFFIXES:
        p = NATIVE_DIR / f"_rawkit{suffix}"
        if p.exists():
            return p
    want = NATIVE_DIR / f"_rawkit{importlib.machinery.EXTENSION_SUFFIXES[0]}"
    raise FileNotFoundError(
        f"no _rawkit extension for this interpreter: {want} is missing "
        "(build it with `make native`)")


def require_rawkit():
    """The ``_rawkit`` module; raises if its file is missing or does not
    load."""
    global _module
    with _lock:
        if _module is None:
            path = str(rawkit_path())
            loader = importlib.machinery.ExtensionFileLoader("_rawkit", path)
            spec = importlib.util.spec_from_file_location(
                "_rawkit", path, loader=loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
            _module = mod
        return _module


def get_rawkit():
    """The ``_rawkit`` module, or None (file missing, or
    ``RAWEDITOR_TPU_NO_NATIVE`` set): the decoders' switch between the
    native and the pure-Python codecs."""
    global _cached, _tried
    if _tried:
        return _cached
    _tried = True
    if os.environ.get("RAWEDITOR_TPU_NO_NATIVE"):
        return None
    try:
        _cached = require_rawkit()
    except (FileNotFoundError, ImportError):
        _cached = None
    return _cached
