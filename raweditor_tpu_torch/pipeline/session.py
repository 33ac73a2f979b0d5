"""Interactive develop session driver (headless).

The PyTorch counterpart of the JAX package's ``DevelopSession``: the
reference's develop tab (slider tick, persist the edit, re-render the
preview and the histogram) as a line protocol on stdin/stdout, so a
frontend or a latency harness can drive the engine without a GUI. Every
verb answers one JSON object with the JAX session's keys:

    set <slider> <value>     update one slider (persists with a catalog)
    open <id|path>           switch to another image (replays its edits)
    prefetch <id|path>       decode and upload the next image in the
                             background so the following `open` is
                             instant (one slot, latest wins)
    zoom <z> | pan <x> <y>   view transform (zoom clamped like the UI)
    render <path>            write the current preview as a picture
    frame [quality] [latest] the current preview as inline base64 JPEG;
                             `latest` returns the newest proven pipelined
                             frame without waiting ("lagged": true)
    curve list|set|clear     point tone curve control points
    auto [levels] [contrast] [tone]  apply auto-adjust suggestions
    checkpoint | undo | history   freeze the current edits row / revert
                             to the previous row / list rows
    rate [0-5] [pick|reject|none] star/flag the current image
    full <path> [long-edge]  full-resolution export
    histogram                (3, 256) histogram as JSON
    wb <x> <y>               white-balance eyedropper at frame-normalised
                             (x, y) through the temperature/tint sliders
    before <path>            preview with default params
    reset                    defaults (deletes stored edits)
    stats                    latency percentiles of this session, and
                             the server side of its verbs: `set` as
                             persist and tick, `frame` as render, fetch
                             and encode, `histogram` (totals and counts)
    local ... | preset ...   not ported yet: answer {"ok": false}
    quit

Slider ticks run the engine's latest-wins pipelined mode unless
``config.session_pipeline_depth`` is 0 (then each tick waits for its
frame); fetch verbs (frame, render, full, histogram) flush it first.

Two behaviours differ from the JAX session on purpose: `local` and
`preset` answer "not ported yet" (their modules are not ported; an
import error would escape ``handle`` and end the REPL), and `open` drops
a prefetch slot it does not take, with its engine, so the slot can never
later serve an engine built from an older file or older settings.
"""

from __future__ import annotations

import json
import math
import sys
from typing import Optional

from raweditor_tpu_torch.params import EditParams
from raweditor_tpu_torch.pipeline.engine import DevelopEngine
from raweditor_tpu_torch.utils.config import Config
from raweditor_tpu_torch.utils.timing import LatencyStats, StageTimer

_NOT_PORTED = {
    "local": "not ported yet: local adjustments "
             "(raweditor_tpu_torch.ops.local_adjust)",
    "preset": "not ported yet: presets (raweditor_tpu_torch.presets)",
}


class DevelopSession:
    def __init__(self, engine: Optional[DevelopEngine], library=None,
                 image_id: Optional[int] = None,
                 config: Optional[Config] = None,
                 engine_defaults: Optional[dict] = None):
        # ``engine=None`` is the image-less shell the TCP service starts
        # connections with; the first `open` builds the engine from
        # ``engine_defaults``.
        self.engine = engine
        self.library = library
        self.image_id = image_id
        self.config = config or Config()
        self._engine_defaults = engine_defaults or {}
        self.params = EditParams()
        if library is not None and image_id is not None:
            self.params = library.load_edit_params(image_id)
        self.zoom = 1.0
        self.pan = (0.0, 0.0)
        self.latency = LatencyStats()
        # The server side of the verbs (``stats``): set.persist,
        # set.tick, frame.render, frame.fetch, frame.encode, histogram.
        self.verbs = StageTimer()
        # (path, thread, box, kwargs) of the background prefetch, or None.
        self._prefetch = None
        # After a checkpoint the newest edits row is frozen: the next
        # tick appends a working row instead of updating it. A replayed
        # image's newest row may be a checkpoint of an earlier process,
        # so it starts frozen.
        self._frozen = image_id is not None

    # -- commands --------------------------------------------------------
    def set_slider(self, name: str, value: float) -> dict:
        if name not in EditParams.field_names():
            raise ValueError(f"unknown slider {name!r}")
        value = float(value)
        if not math.isfinite(value):
            raise ValueError(f"{name} must be finite, got {value}")
        self.params = self.params.replace(**{name: value})
        with self.verbs.span("set.persist"):
            self._persist_params()
        with self.verbs.span("set.tick"):
            ms = self._timed_tick()
        return {"ok": True, "slider": name, "value": float(value),
                "render_ms": round(ms, 3)}

    def curve_cmd(self, *args) -> dict:
        """Point tone curve: ``curve list`` / ``curve set x1 y1 x2 y2
        ...`` (replaces the whole list) / ``curve clear``."""
        from raweditor_tpu_torch.ops.curve import validate_points

        op = args[0] if args else "list"
        if op == "list":
            return {"ok": True,
                    "points": [[float(x), float(y)]
                               for x, y in self.params.point_curve]}
        if op == "clear":
            self.params = self.params.replace(point_curve=())
        elif op == "set":
            coords = [float(v) for v in args[1:]]
            if not coords or len(coords) % 2:
                raise ValueError(
                    "usage: curve set x1 y1 x2 y2 ... (pairs)")
            pts = validate_points(list(zip(coords[0::2], coords[1::2])))
            self.params = self.params.replace(point_curve=pts)
        else:
            raise ValueError(
                f"unknown curve op {op!r} (list|set|clear)")
        self._persist_params()
        ms = self._timed_tick()
        return {"ok": True,
                "points": [[float(x), float(y)]
                           for x, y in self.params.point_curve],
                "render_ms": round(ms, 3)}

    def pick_wb(self, x: float, y: float) -> dict:
        """White-balance eyedropper: set the temperature/tint sliders
        that neutralise the patch at (x, y) (``engine.pick_wb``),
        persist, re-render."""
        if not (math.isfinite(x) and math.isfinite(y)):
            raise ValueError("wb point must be finite")
        t, u = self.engine.pick_wb(x, y)
        self.params = self.params.replace(temperature=t, tint=u)
        self._persist_params()
        ms = self._timed_tick()
        return {"ok": True, "temperature": round(t, 4),
                "tint": round(u, 4), "render_ms": round(ms, 3)}

    def _persist_params(self) -> None:
        """Persist on every tick; a frozen (checkpointed) row is never
        updated: the first tick after a checkpoint appends."""
        if self.library is not None and self.image_id is not None:
            self.library.save_edit_params(self.image_id, self.params,
                                          append=self._frozen)
            self._frozen = False

    def _timed_tick(self) -> float:
        """Render the preview and record the slider latency, on success
        only; returns milliseconds. With
        ``config.session_pipeline_depth`` > 0 the tick is pipelined and
        the time is its dispatch; with 0 it waits for the frame."""
        import time

        t0 = time.perf_counter()
        depth = int(getattr(self.config, "session_pipeline_depth", 0))
        if depth > 0:
            self.engine.preview_tick_pipelined(self.params, self.zoom,
                                               self.pan, depth=depth)
        else:
            self.engine.preview_tick(self.params, self.zoom, self.pan)
        dt = time.perf_counter() - t0
        self.latency.record(dt)
        return dt * 1000.0

    def _flush_pipeline(self) -> None:
        """Retire the in-flight pipelined ticks before a fetch verb
        produces a frame."""
        if self.engine is not None:
            self.engine.flush_pipeline()

    def set_zoom(self, zoom: float) -> dict:
        # NaN passes min/max clamps unchanged and would poison every
        # later render and the JSON answer.
        if not math.isfinite(zoom):
            raise ValueError("zoom must be finite")
        self.zoom = min(max(zoom, self.config.zoom_min),
                        self.config.zoom_max)
        return {"ok": True, "zoom": self.zoom}

    def set_pan(self, x: float, y: float) -> dict:
        if not (math.isfinite(x) and math.isfinite(y)):
            raise ValueError("pan must be finite")
        self.pan = (x, y)
        return {"ok": True, "pan": list(self.pan)}

    def render(self, path: str, params: Optional[EditParams] = None) -> dict:
        from PIL import Image

        self._flush_pipeline()
        img = self.engine.preview(params or self.params, self.zoom,
                                  self.pan)
        Image.fromarray(img).save(path)
        return {"ok": True, "path": path,
                "size": [img.shape[1], img.shape[0]]}

    def frame(self, quality: int = 80,
              params: Optional[EditParams] = None,
              latest: bool = False) -> dict:
        """The current preview as an inline base64 JPEG, the frame
        transport of remote clients (``render`` writes on the server's
        disk). ``latest`` returns the newest proven pipelined frame
        without flushing or rendering ("lagged": true), or the
        synchronous frame when nothing is proven yet."""
        import base64

        if not 1 <= int(quality) <= 100:
            raise ValueError("quality must be 1..100")
        dev = self.engine.newest_pipelined_frame() if latest else None
        if dev is None:
            self._flush_pipeline()
        data, w, h = self.engine.preview_jpeg(
            params or self.params, self.zoom, self.pan,
            quality=int(quality), frame=dev, stages=self.verbs)
        return {"ok": True, "size": [w, h],
                "quality": int(quality), "bytes": len(data),
                "lagged": dev is not None,
                "jpeg_base64": base64.b64encode(data).decode("ascii")}

    def full(self, path: str, long_edge: int = 0) -> dict:
        self._flush_pipeline()
        return {"ok": True,
                "path": self.engine.export(
                    path, self.params,
                    long_edge=int(long_edge) or None)}

    def histogram(self) -> dict:
        with self.verbs.span("histogram"):
            self._flush_pipeline()
            hist = self.engine.histogram(self.params, self.zoom, self.pan)
        return {"ok": True, "r": hist[0].tolist(), "g": hist[1].tolist(),
                "b": hist[2].tolist()}

    def checkpoint(self) -> dict:
        """Freeze the current params as a history entry (undo target)."""
        if self.library is None or self.image_id is None:
            return {"ok": False, "error": "no catalog attached"}
        self.library.save_edit_params(self.image_id, self.params)
        self._frozen = True
        n = len(self.library.edit_history(self.image_id))
        return {"ok": True, "checkpoints": n}

    def undo(self) -> dict:
        if self.library is None or self.image_id is None:
            return {"ok": False, "error": "no catalog attached"}
        self.params = self.library.undo_edit(self.image_id)
        # The restored row is a checkpoint: the next tick appends.
        self._frozen = True
        return {"ok": True, "params": json.loads(self.params.to_json())}

    def history(self) -> dict:
        if self.library is None or self.image_id is None:
            return {"ok": False, "error": "no catalog attached"}
        entries = self.library.edit_history(self.image_id)
        return {"ok": True,
                "history": [json.loads(p.to_json()) for p in entries]}

    def reset(self) -> dict:
        self.params = EditParams()
        if self.library is not None and self.image_id is not None:
            self.library.delete_edits(self.image_id)
        return {"ok": True, "reset": True}

    def auto(self, *options: str) -> dict:
        """Apply the auto-adjust suggestion (exposure and WB; the
        'levels'/'contrast'/'tone' tokens add those corrections)."""
        from raweditor_tpu_torch.pipeline.auto import suggest_auto

        if set(options) - {"levels", "contrast", "tone"}:
            return {"ok": False,
                    "error": "usage: auto [levels] [contrast] [tone]"}
        self.params = suggest_auto(
            self.engine, self.params,
            include_levels="levels" in options,
            include_contrast="contrast" in options,
            include_tone="tone" in options,
        )
        self._persist_params()
        return {"ok": True, "params": json.loads(self.params.to_json())}

    def open(self, target: str) -> dict:
        """Switch the session to another image (a catalog id with a
        catalog, or a file path): decode, replay its stored edits, reset
        the view. On a decode error the session stays on its image."""
        try:
            path, image_id = self._resolve_target(target)
        except ValueError as e:
            return {"ok": False, "error": str(e)}
        eng = self.engine
        kwargs = self._engine_kwargs()
        new_engine = self._take_prefetched(path, kwargs)
        if new_engine is None:
            try:
                new_engine = DevelopEngine.open(path, **kwargs)
            except Exception as e:  # quarantine, stay on current image
                return {"ok": False, "error": f"decode: {e}"}
        if eng is not None:
            # Retire the outgoing engine's syncer thread and its frames.
            try:
                eng.close_pipeline()
            except Exception:  # noqa: BLE001 - a wedged tail sync must
                pass           # not block the image switch
        self.engine = new_engine
        self.image_id = image_id
        self.params = (self.library.load_edit_params(image_id)
                       if self.library is not None and image_id is not None
                       else EditParams())
        self.zoom = 1.0
        self.pan = (0.0, 0.0)
        self._frozen = image_id is not None
        return {"ok": True, "path": path, "image_id": image_id,
                "size": [self.engine.width, self.engine.height],
                "params": json.loads(self.params.to_json())}

    def _resolve_target(self, target: str):
        """(path, image_id) of an `open`/`prefetch` target; raises
        ValueError with the user-facing message."""
        import os

        path = target
        image_id = None
        if self.library is not None and target.isdigit():
            image_id = int(target)
            row = self.library.get_image(image_id)
            if row is None:
                raise ValueError(f"no catalog image {image_id}")
            path = row.path
        if not os.path.exists(path):
            raise ValueError(f"no such file: {path}")
        return path, image_id

    def _engine_kwargs(self) -> dict:
        """The next engine's constructor keywords: the current engine's
        as-constructed ones, or the server defaults for an image-less
        shell."""
        if self.engine is not None:
            return dict(self.engine.ctor_kwargs)
        return dict(self._engine_defaults)

    def prefetch(self, target: str) -> dict:
        """Decode and upload the next image on a background thread so a
        following ``open`` is instant. One slot, latest wins; the engine
        is built with the settings ``open`` would use and is taken only
        if they still match. Decode errors are deferred to ``open``."""
        import threading

        try:
            path, _ = self._resolve_target(target)
        except ValueError as e:
            return {"ok": False, "error": str(e)}
        slot = self._prefetch
        if slot is not None and slot[0] == path \
                and (slot[1].is_alive() or "engine" in slot[2]):
            return {"ok": True, "path": path, "pending": True}
        kwargs = self._engine_kwargs()
        box = {}

        def work():
            try:
                box["engine"] = DevelopEngine.open(path, **kwargs)
            except Exception as e:  # noqa: BLE001 - deferred to open()
                box["error"] = f"{type(e).__name__}: {e}"

        th = threading.Thread(target=work, daemon=True,
                              name="raweditor-prefetch")
        self._prefetch = (path, th, box, kwargs)
        th.start()
        return {"ok": True, "path": path, "pending": True}

    def _take_prefetched(self, path: str, kwargs: dict):
        """Empty the prefetch slot; returns its engine if it holds
        ``path`` built with ``kwargs``, else None. A slot that does not
        match is dropped with its engine, so it cannot serve a stale
        engine later. Waits for an in-flight prefetch of the right
        path."""
        slot, self._prefetch = self._prefetch, None
        if slot is None or slot[0] != path or slot[3] != kwargs:
            return None
        slot[1].join(timeout=120.0)
        if slot[1].is_alive():  # wedged decode: fall back
            return None
        return slot[2].get("engine")  # None on a recorded error

    def rate(self, *args) -> dict:
        """Star and/or flag the current image in the catalog (``rate
        <0-5>``, ``rate pick|reject|none``); ``rate`` alone reads both
        back."""
        if self.library is None or self.image_id is None:
            return {"ok": False, "error": "no catalog attached"}
        rating = flag = None
        for a in args:
            if a in self.library.FLAGS:
                flag = a
            else:
                try:
                    rating = int(a)
                except ValueError:
                    return {"ok": False,
                            "error": f"usage: rate [0-5] "
                                     f"[{'|'.join(self.library.FLAGS)}]"}
        if rating is not None or flag is not None:
            self.library.set_rating(self.image_id, rating=rating,
                                    flag=flag)
        cur_rating, cur_flag = self.library.get_rating(self.image_id)
        return {"ok": True, "image_id": self.image_id,
                "rating": cur_rating, "flag": cur_flag}

    def stats(self) -> dict:
        return {"ok": True, "latency": dict(self.latency.summary(),
                                            verbs=self.verbs.report())}

    def close(self) -> None:
        """Session teardown: drop the prefetch slot and retire the
        engine's syncer thread and frames (best effort: a wedged tail
        sync must not block shutdown)."""
        self._prefetch = None
        if self.engine is not None:
            try:
                self.engine.close_pipeline()
            except Exception:  # noqa: BLE001 - the tail sync's error;
                pass           # the thread still stops

    # -- line protocol ---------------------------------------------------
    def handle(self, line: str) -> Optional[dict]:
        parts = line.strip().split()
        if not parts:
            return None
        cmd, args = parts[0], parts[1:]
        if cmd == "quit":
            return None
        # Arity check up front so a missing operand reads as usage help.
        min_args = {"set": 2, "zoom": 1, "pan": 2, "render": 1, "full": 1,
                    "before": 1, "open": 1, "prefetch": 1, "wb": 2}
        usage = {"set": "set <slider> <value>", "zoom": "zoom <factor>",
                 "pan": "pan <x> <y>", "render": "render <path>",
                 "full": "full <path> [long-edge]",
                 "before": "before <path>",
                 "open": "open <image-id|path>",
                 "prefetch": "prefetch <image-id|path>",
                 "wb": "wb <x> <y>  (frame-normalized 0..1)"}
        if len(args) < min_args.get(cmd, 0):
            return {"ok": False, "error": f"usage: {usage[cmd]}"}
        try:
            if cmd == "set":
                return self.set_slider(args[0], float(args[1]))
            if cmd == "zoom":
                return self.set_zoom(float(args[0]))
            if cmd == "pan":
                return self.set_pan(float(args[0]), float(args[1]))
            if cmd == "render":
                return self.render(args[0])
            if cmd == "frame":
                latest = "latest" in args
                nums = [a for a in args if a != "latest"]
                return self.frame(int(nums[0]) if nums else 80,
                                  latest=latest)
            if cmd == "full":
                return self.full(args[0],
                                 int(args[1]) if len(args) > 1 else 0)
            if cmd == "histogram":
                return self.histogram()
            if cmd == "wb":
                return self.pick_wb(float(args[0]), float(args[1]))
            if cmd == "before":
                return self.render(args[0], EditParams())
            if cmd == "reset":
                return self.reset()
            if cmd == "checkpoint":
                return self.checkpoint()
            if cmd == "undo":
                return self.undo()
            if cmd == "history":
                return self.history()
            if cmd == "auto":
                return self.auto(*args)
            if cmd == "preset" and len(args) > 1:
                return {"ok": False, "error": "usage: preset <name|list>"}
            if cmd in _NOT_PORTED:
                return {"ok": False, "error": _NOT_PORTED[cmd]}
            if cmd == "open":
                return self.open(args[0])
            if cmd == "prefetch":
                return self.prefetch(args[0])
            if cmd == "rate":
                return self.rate(*args)
            if cmd == "curve":
                return self.curve_cmd(*args)
            if cmd == "stats":
                return self.stats()
            return {"ok": False, "error": f"unknown command {cmd!r}"}
        except (IndexError, ValueError, OSError, RuntimeError) as e:
            # OSError: a bad render/full/frame target; RuntimeError: a
            # failed pipelined sync re-raised by flush_pipeline, and
            # NotImplementedError (a not-ported export option, such as
            # `full`'s long edge). The command fails, the session lives.
            return {"ok": False, "error": str(e)}

    def repl(self, stdin=None, stdout=None) -> None:
        stdin = stdin or sys.stdin
        stdout = stdout or sys.stdout
        try:
            for line in stdin:
                # First-token match like the TCP service: a "quit" with
                # trailing tokens exits.
                if line.split() and line.split()[0] == "quit":
                    break
                result = self.handle(line)
                if result is not None:
                    stdout.write(json.dumps(result) + "\n")
                    stdout.flush()
        finally:
            self.close()
