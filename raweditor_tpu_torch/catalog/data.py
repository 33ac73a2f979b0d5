"""Catalog row model (reference: state/data.rs:8-23)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Image:
    """One imported RAW file."""

    id: int
    filename: str
    path: str
    cache_path_thumb: Optional[str] = None  # 256 px tier
    cache_path_instant: Optional[str] = None  # 384 px tier
    cache_path_working: Optional[str] = None  # 1280 px tier
    file_status: str = "exists"  # 'exists' | 'deleted'

    def is_deleted(self) -> bool:
        return self.file_status == "deleted"
