"""SQLite catalog: image library + non-destructive edit store."""

from raweditor_tpu_torch.catalog.data import Image
from raweditor_tpu_torch.catalog.library import Library, RAW_EXTENSIONS

__all__ = ["Image", "Library", "RAW_EXTENSIONS"]
