"""The general generator of slider traffic: one user dragging sliders in a
remote editor, a closed loop over the session's line protocol, read from
a traffic mix whose ``driver`` is ``slider_session``.

The mix's keys: ``verbs`` (the lines an event sends after ``set <slider>
<value>``, each after the previous reply), ``drag`` (``steps`` on one
slider before the next, ``sliders`` {slider: [low, high]} the drag stays
in, ``jitter`` of a step as a share of the range), ``warm_events``,
``check_events`` (events the check compares, drawn from the seed, with
the slowest among them) and ``limits``.

Set-up writes one file of the configuration, imports it into a catalog,
starts ``DevelopServer`` on 127.0.0.1 in this process with the
configuration's engine flags and the catalog, connects one client, sends
``open <id>`` (so that every ``set`` persists the edit, as the reference
editor does on every change) and runs the warm events. The window sends
events until ``--seconds`` have passed: a seeded drag, about ``steps``
moves of one slider, then another. An event's latency runs from sending
``set`` to parsing the last verb's reply; ``slider_p50_ms`` and
``slider_p95_ms`` are over every event of the window. The client's round
trip of each verb is kept as a span.

The check, after the window: every reply ok; for the sampled events the
frame the session encoded (observed by wrapping ``DevelopEngine.
_encode_planes``, the 4:2:0 planes of an even preview, and ``_pil_jpeg``,
the RGB of an odd one) against the preview of the configuration's plain
reference (``core.reference_of``) at the client's edit, zoom and pan
(largest difference in LSB, within the configuration's
``tolerance_lsb``), and the frame's JPEG decoded by libjpeg against that
preview (``yardstick/jfif.py``: all three planes of an even preview, the
luma of an odd one; within the mix's ``frame_jpeg_max_lsb``); the
``histogram`` counts against the reference's (``bin_shift``, within
``tolerance_lsb`` bins); and the catalog's newest edit row against the
client's last edit."""

from __future__ import annotations

import base64
import json
import socket
import sqlite3
import statistics
import time

import numpy as np

from bench_torch import core
from bench_torch.drivers.files import write_files

# The ten sliders of the reference editor, in the catalog's order.
SLIDERS = ("exposure", "contrast", "highlights", "shadows", "whites",
           "blacks", "vibrance", "saturation", "temperature", "tint")
DEFAULTS = {s: (1.0 if s == "whites" else 0.0) for s in SLIDERS}
# What the check calls on the configuration's reference: a configuration
# whose reference lacks any of it makes no cell under this driver's mixes.
REFERENCE = ("preview", "preview_planes", "histogram", "bin_shift")


class State:
    pass


def drag(rng, spec: dict, start: dict):
    """Endless (slider, value) moves: a seeded order of the sliders; on
    each, ``steps`` moves from its value toward a drawn target with a
    little jitter, rounded to 4 decimals, inside the slider's range."""
    sliders = sorted(spec["sliders"])
    value = dict(start)
    while True:
        for name in rng.permutation(sliders):
            lo, hi = spec["sliders"][name]
            a = value[name]
            b = float(rng.uniform(lo, hi))
            steps = int(spec["steps"])
            jitter = float(spec["jitter"]) * (hi - lo)
            for i in range(1, steps + 1):
                v = a + (b - a) * i / steps + float(rng.normal(0, jitter))
                v = round(min(max(v, lo), hi), 4)
                value[name] = v
                yield str(name), v


class Client:
    """A line client of the server: ``send`` returns (reply, seconds)."""

    def __init__(self, address):
        self.sock = socket.create_connection(address, timeout=300)
        self.rfile = self.sock.makefile("r")
        hello = json.loads(self.rfile.readline())
        if not hello.get("ok"):
            raise RuntimeError(f"server greeting {hello}")

    def send(self, line: str):
        t = time.perf_counter()
        self.sock.sendall((line + "\n").encode())
        reply = json.loads(self.rfile.readline())
        return reply, time.perf_counter() - t

    def close(self):
        try:
            self.sock.sendall(b"quit\n")
        finally:
            self.rfile.close()
            self.sock.close()


def session_of(ctx) -> dict:
    """The configuration's preview and histogram widths (the rehearsal
    may shrink them with its frame)."""
    return dict(ctx.cfg["session"],
                **ctx.rehearsal.get("session", {}).get(ctx.cfg["name"], {}))


def setup(ctx):
    from raweditor_tpu_torch import Library
    from raweditor_tpu_torch.pipeline.engine import DevelopEngine
    from raweditor_tpu_torch.pipeline.serve import DevelopServer

    st = State()
    st.reference = core.reference_of(ctx.cfg)
    with ctx.setup.phase("write_files"):
        ((st.path, st.frame),) = write_files(
            ctx.cfg, ctx.workdir / "files", 1, ctx.rng("scene"),
            ctx.rehearsal, ctx.device)
    with ctx.setup.phase("catalog"):
        st.db = str(ctx.workdir / "catalog.db")
        with Library(st.db) as lib:
            lib.import_folder(str(ctx.workdir / "files"))
            st.image_id = lib.get_all_images()[0].id
    flags = ctx.cfg["flags"]
    engine_kwargs = dict(mode=flags["mode"], use_kernel=flags["use_kernel"],
                         demosaic_method=flags["demosaic_method"],
                         transfer=flags["transfer"],
                         color_space=flags["color_space"],
                         max_preview_width=session_of(ctx)[
                             "max_preview_width"],
                         histogram_width=session_of(ctx)["histogram_width"],
                         device=ctx.device)
    # The frame, observed on its way to the encoder: an even preview's
    # 4:2:0 planes (the shared native encoder), an odd one's RGB (PIL).
    st.last_frame = None
    st.encoders = {n: DevelopEngine.__dict__[n]
                   for n in ("_encode_planes", "_pil_jpeg")}

    def observing(name):
        plain = st.encoders[name].__func__

        def observed(image, *args, **kwargs):
            st.last_frame = (name, image)
            return plain(image, *args, **kwargs)
        return staticmethod(observed)

    for name in st.encoders:
        setattr(DevelopEngine, name, observing(name))
    with ctx.setup.phase("open"):
        st.srv = DevelopServer(db_path=st.db, engine_kwargs=engine_kwargs)
        st.thread = st.srv.serve_background()
        st.client = Client(st.srv.address)
        reply, _ = st.client.send(f"open {st.image_id}")
        if not reply.get("ok"):
            raise RuntimeError(f"open: {reply}")
    st.values = dict(DEFAULTS)
    st.moves = drag(ctx.rng("drag"), ctx.mix["drag"], st.values)
    with ctx.setup.phase("warm_up"):
        for _ in range(int(ctx.mix["warm_events"])):
            event(ctx, st)
    return st


def event(ctx, st):
    """One slider event: ``set``, then each verb; returns (seconds, the
    round trip of each line, the replies, ok)."""
    name, value = next(st.moves)
    st.values[name] = value
    lines = [f"set {name} {value!r}"] + list(ctx.mix["verbs"])
    t = time.perf_counter()
    spans, replies, ok = [], [], True
    for line in lines:
        reply, s = st.client.send(line)
        spans.append(s)
        replies.append(reply)
        ok = ok and bool(reply.get("ok"))
    return time.perf_counter() - t, spans, replies, ok


def window(ctx, st, seconds, trace):
    import torch

    rng = ctx.rng("check")
    k = int(ctx.mix["check_events"])
    verbs = [v.split()[0] for v in ctx.mix["verbs"]]
    lat, spans, failed = [], {"set": []}, 0
    for v in verbs:
        spans.setdefault(v, [])
    kept, slowest = [], None
    t_end = time.perf_counter() + seconds
    i = 0
    while time.perf_counter() < t_end:
        with torch.profiler.record_function("bench.slider_event"):
            s, parts, replies, ok = event(ctx, st)
        lat.append(s)
        failed += not ok
        spans["set"].append(parts[0])
        for v, p in zip(verbs, parts[1:]):
            spans[v].append(p)
        sample = (i, dict(st.values), replies, st.last_frame, s)
        # A seeded reservoir of k events, and the slowest event apart.
        if len(kept) < k:
            kept.append(sample)
        else:
            j = int(rng.integers(0, i + 1))
            if j < k:
                kept[j] = sample
        if slowest is None or s > slowest[4]:
            slowest = sample
        i += 1
    st.sample = kept + ([] if any(x is slowest for x in kept)
                         else [slowest])
    core.log("window " + json.dumps({
        "events": len(lat), "seconds": sum(lat),
        **{f"{v}_median_ms": statistics.median(xs) * 1e3
           for v, xs in spans.items() if xs}}))
    ms = [x * 1e3 for x in lat]
    cuts = (statistics.quantiles(ms, n=100) if len(ms) >= 2
            else [ms[0]] * 99)
    return {
        "attempted": len(lat),
        "failed": failed,
        "e2e": {"slider_p50_ms": statistics.median(ms),
                "slider_p95_ms": cuts[94]},
        "events": len(lat),
        "spans_ms": {v: [x * 1e3 for x in xs] for v, xs in spans.items()},
    }


def release(ctx, st):
    """Close the client and the server (the session retires its engine),
    restore the encoder, free the device."""
    from raweditor_tpu_torch.pipeline.engine import DevelopEngine

    st.client.close()
    st.srv.shutdown()
    st.srv.server_close()
    st.thread.join(timeout=60)
    for name, fn in st.encoders.items():
        setattr(DevelopEngine, name, fn)
    if ctx.cuda:
        import torch

        torch.cuda.empty_cache()


def check(ctx, st, record):
    import torch

    from bench_torch.yardstick import jfif
    from bench_torch.yardstick.params import EditParams

    limits = ctx.mix["limits"]
    tol = int(ctx.cfg["tolerance_lsb"])
    flags = dict(ctx.cfg["flags"], **session_of(ctx))
    mosaic = torch.from_numpy(np.ascontiguousarray(st.frame.mosaic)).to(
        ctx.device)
    verbs = [v.split()[0] for v in ctx.mix["verbs"]]
    worst, shift, jpeg_worst, unseen = 0, 0, 0, 0
    for _, values, replies, seen, _ in st.sample:
        params = EditParams(**values)
        by_verb = dict(zip(verbs, replies[1:]))
        if "frame" in by_verb:
            reply = by_verb["frame"]
            if seen is None or not reply.get("ok"):
                unseen += 1
            else:
                rgb = st.reference.preview(st.frame, mosaic, params, flags)
                kind, image = seen
                data = base64.b64decode(reply["jpeg_base64"])
                if kind == "_encode_planes":
                    got = [p.cpu().numpy() for p in image]
                    want = st.reference.preview_planes(rgb)
                    jpeg = jfif.max_lsb(data, want)
                else:
                    got, want = [np.asarray(image)], [rgb.cpu().numpy()]
                    jpeg = jfif.luma_max_lsb(data, want[0])
                jpeg_worst = max(jpeg_worst, jpeg)
                for a, b in zip(got, want):
                    worst = max(worst, 255 if a.shape != b.shape else int(
                        np.abs(a.astype(np.int16) - b.astype(np.int16))
                        .max()))
        if "histogram" in by_verb:
            reply = by_verb["histogram"]
            if not reply.get("ok"):
                unseen += 1
            else:
                got = np.array([reply["r"], reply["g"], reply["b"]],
                               np.int64)
                want = st.reference.histogram(st.frame, mosaic, params, flags)
                shift = max(shift, st.reference.bin_shift(got, want))
    with sqlite3.connect(st.db) as conn:
        row = conn.execute(
            "SELECT settings_json FROM edits WHERE image_id = ? "
            "ORDER BY id DESC LIMIT 1", (st.image_id,)).fetchone()
    saved = json.loads(row[0]) if row else {}
    persisted = sum(saved.get(s) != st.values[s] for s in SLIDERS)
    return {
        "failed_replies": {"value": record["failed"] + unseen,
                           "limit": limits["failed_replies"]},
        "preview_max_lsb": {"value": worst, "limit": tol},
        "frame_jpeg_max_lsb": {"value": jpeg_worst,
                               "limit": limits["frame_jpeg_max_lsb"]},
        "histogram_bin_shift": {"value": shift, "limit": tol},
        "persisted_sliders_mismatch": {
            "value": persisted, "limit": limits["persisted_sliders_mismatch"]},
    }
