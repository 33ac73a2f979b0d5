"""The shared native extension ``_rawkit`` (JFIF encoder), loaded by
file path.

The compiled module lives in the JAX package's tree
(``raweditor_tpu/native/_rawkit.*.so``, built from ``rawkit.cpp``) and is
a plain CPython extension with no JAX in it. Importing it as
``raweditor_tpu.native._rawkit`` would run ``raweditor_tpu/__init__.py``,
which imports jax, so the port loads the file directly under the name
``_rawkit``.
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import threading
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent.parent / "raweditor_tpu" / "native"

_lock = threading.Lock()
_module = None


def rawkit_path() -> Path:
    for suffix in importlib.machinery.EXTENSION_SUFFIXES:
        p = NATIVE_DIR / f"_rawkit{suffix}"
        if p.exists():
            return p
    raise FileNotFoundError(
        f"no _rawkit extension for this interpreter under {NATIVE_DIR} "
        "(build it with `make native`)")


def get_rawkit():
    """The ``_rawkit`` extension module; raises if it is missing."""
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
