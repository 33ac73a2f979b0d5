"""Typed configuration.

The reference has no config system — every knob is a hardcoded constant
(SURVEY.md §5: tier sizes processor.rs:13-15, preview cap
pipeline.rs:125, histogram width pipeline.rs:131, zoom clamp
main.rs:803, paths library.rs:40-48). Headless batch operation is
config-driven, so all of those become one dataclass, overridable from
environment (RAWEDITOR_TPU_*) or JSON.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Optional


@dataclasses.dataclass
class Config:
    # Storage (reference defaults: state/library.rs:40-48,
    # raw/processor.rs:18-31).
    db_path: Optional[str] = None  # None → platform default
    cache_dir: Optional[str] = None

    # Render targets (reference: gpu/pipeline.rs:125,131;
    # raw/processor.rs:13-15).
    max_preview_width: int = 1280
    histogram_width: int = 128
    tier_thumb: int = 256
    tier_instant: int = 384
    tier_working: int = 1280

    # Interaction (reference: main.rs:803 zoom clamp 0.1-10).
    zoom_min: float = 0.1
    zoom_max: float = 10.0
    # Slider ticks keep up to N renders in flight (engine
    # preview_tick_pipelined): per-tick wall latency amortizes the
    # transport round trip; returned frames lag the slider by N ticks.
    # 0 = classic true-sync mode (every tick waits for its own frame).
    # Default ON (depth 2, the latest-wins frame discipline every
    # interactive renderer ships): slider p50 is the dispatch cost, not
    # a transport round trip. Fetch commands (render/full/histogram/
    # frame) still flush and stay true-sync; `--no-pipeline` or
    # RAWEDITOR_TPU_SESSION_PIPELINE_DEPTH=0 restores per-tick sync
    # (VERDICT r4 item 3).
    session_pipeline_depth: int = 2

    # Develop semantics.
    mode: str = "parity"  # parity | accurate
    use_pallas_kernel: bool = False

    # Batch export.
    batch_size: int = 8
    decode_threads: int = 4
    encode_threads: int = 4
    jpeg_quality: int = 95
    # Per-image optimal Huffman tables (2-pass encode): ~3-5% smaller
    # JPEGs for ~1.9x the encode time. Off by default like libjpeg.
    jpeg_optimize: bool = False
    mesh_rows: int = 0  # 0 = no intra-image row sharding

    def validate(self) -> "Config":
        if self.mode not in ("parity", "accurate"):
            raise ValueError(f"mode must be parity|accurate, got {self.mode}")
        if not (0 < self.zoom_min <= self.zoom_max):
            raise ValueError("zoom bounds must satisfy 0 < min <= max")
        for field in ("max_preview_width", "histogram_width", "tier_thumb",
                      "tier_instant", "tier_working", "batch_size",
                      "decode_threads", "encode_threads"):
            if getattr(self, field) <= 0:
                raise ValueError(f"{field} must be positive")
        if not 1 <= self.jpeg_quality <= 100:
            raise ValueError("jpeg_quality must be in 1..100")
        if self.mesh_rows < 0:
            raise ValueError("mesh_rows must be >= 0 (0 = no mesh)")
        if not 0 <= self.session_pipeline_depth <= 8:
            # >8 in-flight frames buys nothing (the transport round
            # trip is amortized by 2-3) and holds device buffers.
            raise ValueError("session_pipeline_depth must be in 0..8")
        return self

    # -- sources ---------------------------------------------------------
    @classmethod
    def from_env(cls, base: Optional["Config"] = None) -> "Config":
        """Overlay RAWEDITOR_TPU_<FIELD> environment variables.

        Without an explicit ``base``, a JSON config file named by
        RAWEDITOR_TPU_CONFIG is the base layer (env variables still
        win) — the deploy-file + per-run-env layering of every
        production config system. A missing/unreadable file raises
        ValueError like any other bad config value."""
        if base is None:
            path = os.environ.get("RAWEDITOR_TPU_CONFIG")
            if path:
                try:
                    base = cls.from_json(path)
                except OSError as e:
                    raise ValueError(
                        f"RAWEDITOR_TPU_CONFIG: cannot read {path}: {e}"
                    ) from e
        cfg = dataclasses.replace(base) if base else cls()
        for f in dataclasses.fields(cls):
            raw = os.environ.get(f"RAWEDITOR_TPU_{f.name.upper()}")
            if raw is None:
                continue
            if f.type in ("int",):
                value = int(raw)
            elif f.type in ("float",):
                value = float(raw)
            elif f.type in ("bool",):
                value = raw.lower() in ("1", "true", "yes")
            else:
                value = raw
            object.__setattr__(cfg, f.name, value)
        return cfg.validate()

    @classmethod
    def from_json(cls, path: os.PathLike) -> "Config":
        data = json.loads(Path(path).read_text())
        unknown = set(data) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown config key(s): {sorted(unknown)}")
        return cls(**data).validate()

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)
