"""The port's interactive session (``pipeline/session.py``) and the engine
surface it calls, against the JAX session on the same files and lines.

Every verb of ``DevelopSession.handle`` goes through both sessions with
the same edit sequence; the answers are equal leaving out ``render_ms``
and ``latency`` (timings) and the output paths (each package writes its
own). Previews are held within 1 LSB of the JAX session's (the parity
lane's tolerance; the finish extras reach it), histograms within one bin
for each count, the auto suggestion and the white-balance pick within
1e-6; each test prints what it measured. The inline JPEG frames differ
from the JAX session's bytes: the JAX engine converts the preview to
4:2:0 planes in a jitted program that rounds up to 1 LSB of chroma away
from its own op-by-op ``rgb_u8_to_ycbcr420``; the port's frame equals the
native encoder over that op-by-op function's planes of its preview, byte
for byte.
"""

import base64
import io
import json
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from raweditor_tpu.catalog import Library as JaxLibrary
from raweditor_tpu.ops.jpeg import rgb_u8_to_ycbcr420 as jax_ycbcr420
from raweditor_tpu.params import EditParams as JaxParams
from raweditor_tpu.pipeline.engine import DevelopEngine as JaxEngine
from raweditor_tpu.pipeline.session import DevelopSession as JaxSession
from raweditor_tpu_torch.catalog import Library
from raweditor_tpu_torch.native import get_rawkit
from raweditor_tpu_torch.params import EditParams
from raweditor_tpu_torch.pipeline import engine as engine_mod
from raweditor_tpu_torch.pipeline.engine import DevelopEngine
from raweditor_tpu_torch.pipeline.session import DevelopSession
from raweditor_tpu_torch.raw import raf, synth
from raweditor_tpu_torch.utils.config import Config

H, W = 64, 96
MODES = {"parity": dict(mode="parity"),
         "accurate": dict(mode="accurate", demosaic_method="malvar",
                          transfer="srgb")}
TIMINGS = ("render_ms", "latency")


def _write(path, seed, h=H, w=W):
    synth.write_synthetic_raw(path, np.random.default_rng(seed).integers(
        0, 4096, size=(h, w), dtype=np.uint16))
    return str(path)


def _pair(tmp_path, kw, seed=11):
    """Two files, one catalog per package holding both, and a session of
    each package on the first file: (files, jax side, port side), a side
    being (session, library, image ids, output dir)."""
    files = [_write(tmp_path / n, seed + i)
             for i, n in enumerate(("a.nef", "b.nef"))]
    sides = []
    for tag, lib_cls, eng, sess, extra in (
            ("jax", JaxLibrary, JaxEngine, JaxSession, {}),
            ("port", Library, DevelopEngine, DevelopSession,
             {"device": "cpu"})):
        out = tmp_path / tag
        out.mkdir()
        lib = lib_cls(tmp_path / f"{tag}.db")
        ids = [lib.import_image(p, p.rsplit("/", 1)[1]) for p in files]
        s = sess(eng.open(files[0], **kw, **extra), lib, ids[0])
        sides.append((s, lib, ids, out))
    return files, sides[0], sides[1]


def _strip(answer, out_dir):
    """An answer without its timings, with the package's output directory
    taken out of paths."""
    return {k: (v.replace(str(out_dir), "OUT") if isinstance(v, str) else v)
            for k, v in answer.items() if k not in TIMINGS}


def _lines(ids):
    """Every verb of ``handle``, in an order that exercises the pipelined
    state between fetches (``frame latest`` right after a flush)."""
    return [
        "set exposure 0.5", "set contrast 10", "wb 0.5 0.5", "zoom 2",
        "pan 0.1 -0.05", "histogram", "frame 80", "set sharpen 40",
        "curve set 0 0 0.5 0.6 1 1", "curve list", "histogram",
        "frame 75 latest", "frame 75", "checkpoint", "set exposure 0.8",
        "undo", "history", "rate 4 pick", "rate", "auto",
        "auto levels contrast tone", "histogram", "render OUT/r.png",
        "before OUT/b.png", "full OUT/f.jpg", f"prefetch {ids[1]}",
        f"open {ids[1]}", "set saturation 20", "histogram", "frame 90",
        "curve clear", "reset", "history", "zoom 50", "pan 0 0",
        "bogus", "set bogus 1", "zoom nan", "wb 0.5", "frame 0",
        "rate banana", "stats",
    ]


def _within_one_bin(want, got):
    """Histograms of two renders whose pixels differ by at most one level:
    every count has moved by at most one bin, i.e. for each level k
    #(want <= k-1) <= #(got <= k) <= #(want <= k+1). Returns how many
    counts moved (the L1 distance of the cumulative counts)."""
    a, b = np.cumsum(want), np.cumsum(got)
    assert a[-1] == b[-1]
    assert (b[1:] >= a[:-1]).all() and (b[:-1] <= a[1:]).all()
    return int(np.abs(a - b).sum())


@pytest.mark.parametrize("mode", sorted(MODES))
def test_every_verb_answers_as_the_jax_session(mode, tmp_path):
    _, (js, jlib, ids, jout), (ps, plib, _, pout) = _pair(tmp_path,
                                                          MODES[mode])
    rk = get_rawkit()
    worst = {"preview": 0, "histogram_counts_moved": 0,
             "frame_chroma_vs_jax_jit": 0}
    for line in _lines(ids):
        ja = js.handle(line.replace("OUT", str(jout)))
        pa = ps.handle(line.replace("OUT", str(pout)))
        if line.startswith(("frame", "histogram")) and ja["ok"]:
            # The previews of the two sessions' state: within 1 LSB.
            want = np.asarray(js.engine.preview(js.params, js.zoom, js.pan))
            got = ps.engine.preview(ps.params, ps.zoom, ps.pan)
            worst["preview"] = max(worst["preview"], int(np.abs(
                want.astype(int) - got).max()))
        if line.startswith("histogram") and ja["ok"]:
            for c in "rgb":
                worst["histogram_counts_moved"] = max(
                    worst["histogram_counts_moved"],
                    _within_one_bin(ja.pop(c), pa.pop(c)))
        if line.startswith("frame") and ja["ok"]:
            # The port's bytes are the encoder over the op-by-op JAX 4:2:0
            # planes of the port's preview.
            y, cb, cr = (np.ascontiguousarray(np.asarray(p))
                         for p in jax_ycbcr420(got))
            ref = rk.encode_jpeg_420(y, cb, cr, got.shape[1], got.shape[0],
                                     pa["quality"], False)
            assert base64.b64decode(pa["jpeg_base64"]) == ref, line
            assert pa["bytes"] == len(ref)
            jit = [np.asarray(p) for p in _jax_jit_planes(want)]
            worst["frame_chroma_vs_jax_jit"] = max(
                worst["frame_chroma_vs_jax_jit"],
                max(int(np.abs(a.astype(int) - np.asarray(b)).max())
                    for a, b in zip(jit, jax_ycbcr420(got))))
            ja, pa = ({k: v for k, v in a.items()
                       if k not in ("jpeg_base64", "bytes")}
                      for a in (ja, pa))
        assert _strip(pa, pout) == _strip(ja, jout), line
    print(f"{mode}: largest differences {worst}")
    assert worst["preview"] <= 1 and worst["frame_chroma_vs_jax_jit"] <= 2
    for name in ("r.png", "b.png"):
        got = np.asarray(Image.open(pout / name)).astype(int)
        want = np.asarray(Image.open(jout / name)).astype(int)
        assert got.shape == want.shape and np.abs(got - want).max() <= 1
    got = np.asarray(Image.open(pout / "f.jpg").convert("RGB")).astype(int)
    want = np.asarray(Image.open(jout / "f.jpg").convert("RGB")).astype(int)
    print(f"{mode}: full export decoded, max {np.abs(got - want).max()}, "
          f"mean {np.abs(got - want).mean():.4f}")
    assert got.shape == want.shape and np.abs(got - want).mean() < 0.05
    # Both catalogs hold the same edits and ratings after the session.
    for i in ids:
        assert plib.load_edit_params(i).to_json() == \
            jlib.load_edit_params(i).to_json()
        assert plib.get_rating(i) == jlib.get_rating(i)
    for s, lib in ((js, jlib), (ps, plib)):
        s.close()
        lib.close()


@pytest.mark.parametrize("mode", ["parity", "accurate"])
def test_highlight_recovery_and_full_tif_answer_as_the_jax_session(
        mode, tmp_path):
    """``set highlight_recovery 60`` and ``full x.tif``: the answers equal
    the JAX session's, the previews within 1 LSB, the TIFF's pixels
    within 1 LSB of u16 and every other byte equal."""
    from raweditor_tpu_torch.raw import tiff as T

    _, (js, jlib, _, jout), (ps, plib, _, pout) = _pair(tmp_path,
                                                        MODES[mode])
    for line in ("set highlight_recovery 60", "set exposure 0.4",
                 "full OUT/x.tif", "set highlight_recovery 0",
                 "full OUT/y.tiff"):
        ja = js.handle(line.replace("OUT", str(jout)))
        pa = ps.handle(line.replace("OUT", str(pout)))
        assert pa["ok"] and _strip(pa, pout) == _strip(ja, jout), line
        want = np.asarray(js.engine.preview(js.params))
        got = ps.engine.preview(ps.params)
        assert np.abs(want.astype(int) - got).max() <= 1, line
    worst = 0
    for name in ("x.tif", "y.tiff"):
        a, b = ((d / name).read_bytes() for d in (pout, jout))
        ifd = T.TiffFile(a).ifds[0]
        off = ifd.get_scalar(T.STRIP_OFFSETS)
        n = H * W * 6
        assert len(a) == len(b) and a[:off] + a[off + n:] == b[:off] + b[
            off + n:]
        worst = max(worst, int(np.abs(
            np.frombuffer(a[off:off + n], "<u2").astype(int)
            - np.frombuffer(b[off:off + n], "<u2")).max()))
    print(f"{mode}: TIFFs max {worst} LSB of u16")
    assert worst <= 1
    for s, lib in ((js, jlib), (ps, plib)):
        s.close()
        lib.close()


def _jax_jit_planes(rgb):
    """The JAX engine's own (jitted) 4:2:0 conversion of a preview."""
    from raweditor_tpu.pipeline.engine import _ycbcr420_jit

    return _ycbcr420_jit()(rgb)


def test_auto_suggestions_match_jax(tmp_path):
    """``auto`` with every token: the suggested params agree with the
    JAX session's within 1e-6 (measured here: 0.0)."""
    _, (js, jlib, _, _), (ps, plib, _, _) = _pair(
        tmp_path, MODES["accurate"], seed=3)
    worst = 0.0
    for line in ("set exposure -1.5", "auto", "auto levels contrast tone",
                 "auto tone"):
        ja, pa = js.handle(line), ps.handle(line)
        if line.startswith("auto"):
            assert set(ja["params"]) == set(pa["params"])
            worst = max([worst] + [abs(ja["params"][k] - pa["params"][k])
                                   for k in ja["params"]])
    print(f"auto params: largest difference {worst}")
    assert worst <= 1e-6
    assert js.handle("auto bogus") == ps.handle("auto bogus")
    for s, lib in ((js, jlib), (ps, plib)):
        s.close()
        lib.close()


def _cast(tmp_path, name="cast.nef"):
    """A flat scene with a known cast (the JAX session tests' fixture)."""
    h, w = 48, 64
    m = np.zeros((h, w), np.uint16)
    yy, xx = np.mgrid[0:h, 0:w]
    is_r = (yy % 2 == 0) & (xx % 2 == 0)
    is_b = (yy % 2 == 1) & (xx % 2 == 1)
    m[is_r] = int(0.25 * 0.8 * 4095)
    m[~(is_r | is_b)] = int(0.5 * 4095)
    m[is_b] = int(0.35 * 1.15 * 4095)
    path = tmp_path / name
    synth.write_synthetic_raw(path, m, wb_neutral=(0.5, 1.0, 1.0 / 1.4))
    return str(path)


def _xtrans(tmp_path):
    mosaic = np.random.default_rng(8).integers(200, 3000, size=(60, 90),
                                               dtype=np.uint16)
    path = tmp_path / "x.raf"
    path.write_bytes(raf.write_raf(mosaic, model="X-T2",
                                   wb_grbg=(256, 512, 384, 256)))
    return str(path)


@pytest.mark.parametrize("kind", ["cast", "random", "xtrans"])
def test_pick_wb_matches_jax(kind, tmp_path):
    path = {"cast": lambda: _cast(tmp_path),
            "random": lambda: _write(tmp_path / "r.nef", 4),
            "xtrans": lambda: _xtrans(tmp_path)}[kind]()
    kw = MODES["accurate"]
    port = DevelopEngine.open(path, device="cpu", **kw)
    ref = JaxEngine.open(path, **kw)
    worst = 0.0
    for x, y, r in ((0.5, 0.5, 0.02), (0.0, 0.0, 0.02), (1.0, 1.0, 0.1),
                    (0.3, 0.7, 0.05)):
        got, want = port.pick_wb(x, y, r), ref.pick_wb(x, y, r)
        worst = max(worst, *(abs(a - b) for a, b in zip(got, want)))
    print(f"{kind} pick_wb: largest difference {worst}")
    assert worst <= 1e-6
    if kind == "cast":
        t, u = port.pick_wb(0.5, 0.5)
        before = port.preview(EditParams()).astype(int)[8:-8, 8:-8]
        after = port.preview(EditParams(temperature=t, tint=u)).astype(
            int)[8:-8, 8:-8]

        def gap(img):
            return (abs(img[..., 0] - img[..., 1]).mean()
                    + abs(img[..., 2] - img[..., 1]).mean())

        assert gap(before) > 5 and gap(after) < gap(before) / 3


def test_pick_wb_refuses_bad_patches_like_jax(tmp_path):
    for value, match in ((4095, "clipped"), (0, "black")):
        path = tmp_path / f"{match}.nef"
        synth.write_synthetic_raw(path, np.full((24, 32), value, np.uint16))
        for eng in (DevelopEngine.open(path, mode="accurate", device="cpu"),
                    JaxEngine.open(path, mode="accurate")):
            with pytest.raises(ValueError, match=match):
                eng.pick_wb(0.5, 0.5)
            with pytest.raises(ValueError, match="0..1"):
                eng.pick_wb(1.5, 0.5)


def test_before_after_and_preview_jpeg_of_a_frame(tmp_path):
    path = _write(tmp_path / "a.nef", 2)
    port = DevelopEngine.open(path, device="cpu")
    ref = JaxEngine.open(path)
    p, jp = EditParams(exposure=0.7), JaxParams(exposure=0.7)
    for got, want in zip(port.before_after(p, 1.5, (0.1, 0.0)),
                         ref.before_after(jp, 1.5, (0.1, 0.0))):
        np.testing.assert_array_equal(got, np.asarray(want))
    # A proven frame encodes as the same render would.
    frame = port.preview_device(p)
    assert port.preview_jpeg(EditParams(), frame=frame) == \
        port.preview_jpeg(p)
    assert port._icc_bytes() is None and ref._icc_bytes() is None


def test_preview_jpeg_needs_the_encoder_for_even_frames(tmp_path,
                                                        monkeypatch):
    """An even preview takes device planes and the native encoder, and
    raises without it; nothing moves the conversion to PIL."""
    from raweditor_tpu_torch import native

    port = DevelopEngine.open(_write(tmp_path / "a.nef", 2), device="cpu")
    assert port.preview_h % 2 == 0 and port.preview_w % 2 == 0

    def missing():
        raise RuntimeError("no _rawkit")

    monkeypatch.setattr(native, "require_rawkit", missing)
    with pytest.raises(RuntimeError, match="_rawkit"):
        port.preview_jpeg(EditParams())


def test_ctor_kwargs_and_color_space(tmp_path):
    path = _write(tmp_path / "a.nef", 2)
    a = DevelopEngine.open(path, device="cpu", mode="accurate",
                           use_kernel=True, demosaic_method="grad")
    b = DevelopEngine.open(path, **a.ctor_kwargs)
    assert a.ctor_kwargs == b.ctor_kwargs
    assert a.ctor_kwargs == dict(
        mode="accurate", max_preview_width=1280, histogram_width=128,
        use_kernel=True, fast_gamma=False, demosaic_method="grad",
        transfer="gamma22", auto_orient=False, color_space="srgb",
        device="cpu")
    # The JAX keywords, with the port's two names.
    jax_keys = set(JaxEngine.open(path).ctor_kwargs)
    assert set(a.ctor_kwargs) == jax_keys - {"use_pallas"} | {
        "use_kernel", "device"}
    assert DevelopEngine.open(path, device="cpu",
                              color_space="SRGB").color_space == "srgb"
    # The wide spaces are ported: the JAX engine's matrix, bit for bit,
    # and its resolved transfer (the space's, then fast_gamma); parity
    # refuses them with ValueError, as the JAX engine does.
    for space in ("display-p3", "adobe-rgb"):
        for fast in (False, True):
            eng = DevelopEngine.open(path, device="cpu", mode="accurate",
                                     color_space=space, fast_gamma=fast)
            ref = JaxEngine.open(path, mode="accurate", color_space=space,
                                 fast_gamma=fast)
            assert (eng.color_space, eng.transfer) == (ref.color_space,
                                                       ref.transfer)
            assert eng.cam_matrix.tobytes() == ref.cam_matrix.tobytes()
        with pytest.raises(ValueError, match="accurate"):
            DevelopEngine.open(path, device="cpu", color_space=space)
    with pytest.raises(ValueError, match="unknown color space"):
        DevelopEngine.open(path, device="cpu", color_space="rec2020")


# -- the pipelined state machine -----------------------------------------

def _pipelined(tmp_path, depth=2):
    eng = DevelopEngine.open(_write(tmp_path / "p.nef", 9, 24, 32),
                             device="cpu")
    return eng, DevelopSession(eng, None, None,
                               config=Config(session_pipeline_depth=depth))


def test_pipelined_frames_match_true_sync(tmp_path):
    eng, _ = _pipelined(tmp_path)
    values = [0.1, 0.4, 0.7, 1.0, 1.3]
    assert eng.preview_tick_pipelined(EditParams(exposure=values[0])) is None
    for v in values[1:]:
        frame = eng.preview_tick_pipelined(EditParams(exposure=v))
        assert frame is None or frame.dtype == torch.uint8
    want = eng.preview_tick(EditParams(exposure=values[-1]))
    assert torch.equal(eng.flush_pipeline(), want)
    assert torch.equal(eng.flush_pipeline(), want)  # idle: a no-op
    assert torch.equal(eng.newest_pipelined_frame(), want)
    eng.close_pipeline()
    assert eng._pipe is None and eng.newest_pipelined_frame() is None
    eng.close_pipeline()  # repeatable
    # A tick after close starts the syncer again.
    assert eng.preview_tick_pipelined(EditParams(exposure=0.6)) is None
    assert torch.equal(eng.flush_pipeline(),
                       eng.preview_tick(EditParams(exposure=0.6)))
    eng.close_pipeline()


def test_pipelined_extras_and_curve_pipeline_too(tmp_path):
    from raweditor_tpu_torch.ops.curve import validate_points

    eng, _ = _pipelined(tmp_path)
    for p in (EditParams(sharpen=50.0, hue_red=20.0),
              EditParams(point_curve=validate_points(
                  [(0.0, 0.0), (0.5, 0.62), (1.0, 1.0)]))):
        assert eng.preview_tick_pipelined(p) is None
        assert eng._pipe is not None
        assert torch.equal(eng.flush_pipeline(), eng.preview_tick(p))
        eng.close_pipeline()


class _Event:
    """Stands in for a CUDA event: ``synchronize`` blocks until the test
    releases it, and records which tick it proved."""

    def __init__(self, n, log, gate, fail=False):
        self.n, self.log, self.gate, self.fail = n, log, gate, fail

    def synchronize(self):
        assert self.gate.wait(timeout=30)
        self.log.append(self.n)
        if self.fail:
            raise RuntimeError("device lost")


def test_latest_wins_syncs_only_the_newest_event(tmp_path, monkeypatch):
    """While the syncer waits on one event, later ticks replace each
    other: only the newest is waited on next, and its frame is the one
    published (a stream runs in order, so it proves the skipped ones)."""
    eng, _ = _pipelined(tmp_path)
    log, gate, made = [], threading.Event(), []

    def record(device):
        made.append(_Event(len(made), log, gate))
        return made[-1]

    monkeypatch.setattr(engine_mod, "_record_event", record)
    for i in range(6):
        assert eng.preview_tick_pipelined(EditParams(exposure=0.1 * i)) \
            is None
    gate.set()
    newest = eng.flush_pipeline()
    # At most the tick the syncer had taken before the release, then the
    # newest: six ticks, at most two waits.
    assert log[-1] == 5 and len(log) <= 2
    assert torch.equal(newest, eng.preview_device(EditParams(exposure=0.5)))
    st = eng._pipe
    assert st["synced_seq"] == st["seq"] == 6
    eng.close_pipeline()


def test_pipeline_under_a_short_switch_interval(tmp_path):
    """The tick and the syncer share the pipeline state: with the
    interpreter switching threads every microsecond, every flush still
    returns the newest tick's frame and leaves nothing in flight."""
    import sys

    eng, _ = _pipelined(tmp_path)
    frames = [eng.preview_device(EditParams(exposure=0.05 * i))
              for i in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for n in range(200):
            i = n % 8
            eng.preview_tick_pipelined(EditParams(exposure=0.05 * i))
            if n % 7 == 3:
                assert torch.equal(eng.flush_pipeline(), frames[i])
                st = eng._pipe
                assert st["synced_seq"] == st["seq"] == n + 1
    finally:
        sys.setswitchinterval(old)
    assert torch.equal(eng.flush_pipeline(), frames[199 % 8])
    eng.close_pipeline()
    assert eng._pipe is None


def test_a_failed_sync_is_raised_by_flush_and_the_syncer_lives(
        tmp_path, monkeypatch):
    eng, sess = _pipelined(tmp_path)
    log, gate = [], threading.Event()
    gate.set()
    monkeypatch.setattr(engine_mod, "_record_event",
                        lambda device: _Event(0, log, gate, fail=True))
    assert sess.set_slider("exposure", 0.4)["ok"]
    with pytest.raises(RuntimeError, match="pipelined preview sync") as e:
        eng.flush_pipeline()
    assert "device lost" in str(e.value.__cause__)
    assert eng.flush_pipeline() is None  # raised once; nothing proven
    # Through the protocol: the fetch verb fails, the session lives.
    sess.set_slider("exposure", 0.5)
    out = sess.handle("histogram")
    assert out["ok"] is False and "pipelined preview sync" in out["error"]
    monkeypatch.setattr(engine_mod, "_record_event", lambda device: None)
    assert sess.set_slider("exposure", 0.6)["ok"]
    assert sess.handle("histogram")["ok"]
    assert sess.handle("frame 80 latest")["lagged"] is True
    sess.close()
    assert eng._pipe is None


def test_session_pipeline_default_and_synchronous_ticks(tmp_path):
    eng, sess = _pipelined(tmp_path, depth=2)
    assert Config().session_pipeline_depth >= 1
    out = sess.handle("frame 80 latest")
    assert out["ok"] and out["lagged"] is False  # nothing proven yet
    for i in range(4):
        assert sess.set_slider("exposure", 0.1 * i)["ok"]
    assert eng._pipe is not None
    out = sess.handle("frame 80")
    st = eng._pipe
    assert out["ok"] and st["synced_seq"] == st["seq"]  # flushed first
    out = sess.handle("frame 80 latest")
    assert out["ok"] and out["lagged"] is True
    sess.repl(stdin=io.StringIO("set exposure 0.5\nquit now\n"),
              stdout=io.StringIO())
    assert eng._pipe is None  # quit closed the syncer
    sync_eng, sync = _pipelined(tmp_path, depth=0)
    assert sync.set_slider("exposure", 0.4)["ok"]
    assert sync_eng._pipe is None and sync.stats()["latency"]["count"] == 1
    DevelopSession(None).close()


@pytest.mark.parametrize("depth", [0, 2])
def test_stats_split_the_verbs_as_they_were_sent(tmp_path, depth):
    """``stats`` carries the server side of the verbs under ``latency``:
    a ``set`` as its catalog write and its tick, a ``frame`` as render,
    fetch and encode, and ``histogram``; each count follows the verbs
    sent, pipelined or not."""
    path = _write(tmp_path / "a.nef", 3, 24, 32)
    lib = Library(tmp_path / "c.db")
    image_id = lib.import_image(path, "a.nef")
    sess = DevelopSession(DevelopEngine.open(path, device="cpu"), lib,
                          image_id,
                          config=Config(session_pipeline_depth=depth))
    for line in ("set exposure 0.3", "frame 80", "set contrast 5", "zoom 2",
                 "set shadows 10", "histogram", "frame 75 latest",
                 "histogram", "pan 0.1 0"):
        assert sess.handle(line)["ok"], line
    latency = sess.handle("stats")["latency"]
    assert latency["count"] == 3
    verbs = latency["verbs"]
    assert {k: v["count"] for k, v in verbs["spans"].items()} == {
        "set.persist": 3, "set.tick": 3, "frame.render": 2,
        "frame.fetch": 2, "frame.encode": 2, "histogram": 2}
    assert all(v["total_s"] >= 0 for v in verbs["spans"].values())
    assert verbs["counters"] == {}
    assert lib.load_edit_params(image_id).shadows == 10
    sess.close()


# -- the two verbs of modules not ported yet, and the long edge ----------

def test_unported_verbs_answer_without_ending_the_session(tmp_path):
    eng, sess = _pipelined(tmp_path, depth=0)
    for line in ("local list", "local add linear x0=0.5", "preset list",
                 "preset vivid"):
        out = sess.handle(line)
        assert out["ok"] is False and out["error"].startswith(
            "not ported yet: "), line
    assert sess.handle("preset a b") == {
        "ok": False, "error": "usage: preset <name|list>"}
    # The long edge is ported: ``full <path> <long-edge>`` writes the
    # engine's resized export (24x32 -> 12x16) and the session goes on.
    out = sess.handle(f"full {tmp_path / 'f.jpg'} 16")
    assert out == {"ok": True, "path": str(tmp_path / "f.jpg")}
    want = eng.export(tmp_path / "e.jpg", sess.params, long_edge=16)
    data = (tmp_path / "f.jpg").read_bytes()
    assert data == open(want, "rb").read()
    from PIL import Image

    assert Image.open(io.BytesIO(data)).size == (16, 12)
    buf = io.StringIO()
    sess.repl(stdin=io.StringIO("local list\nset exposure 0.3\n"),
              stdout=buf)
    answers = [json.loads(x) for x in buf.getvalue().splitlines()]
    assert [a["ok"] for a in answers] == [False, True]


# -- prefetch: the stale slot of the JAX session is not inherited ---------

def test_open_drops_a_prefetch_slot_it_does_not_take(tmp_path):
    """Prefetch b, open a, rewrite b on disk, open b. The JAX session
    kept the unmatched slot and serves b as it was when prefetched; the
    port dropped it at the first open and decodes b anew."""
    a = _write(tmp_path / "a.nef", 1)
    b = _write(tmp_path / "b.nef", 2)
    sizes = {}
    for tag, sess in (
            ("jax", JaxSession(JaxEngine.open(a), None, None)),
            ("port", DevelopSession(DevelopEngine.open(a, device="cpu"),
                                    None, None))):
        _write(tmp_path / "b.nef", 2)
        assert sess.prefetch(b)["ok"]
        sess._prefetch[1].join(timeout=60)
        assert sess.open(a)["ok"]
        if tag == "port":
            assert sess._prefetch is None
        _write(tmp_path / "b.nef", 3, h=32, w=48)  # b changes on disk
        sizes[tag] = sess.open(b)["size"]
        sess.close()
    assert sizes == {"jax": [W, H], "port": [48, 32]}


def test_prefetch_makes_open_instant(tmp_path, monkeypatch):
    a = _write(tmp_path / "a.nef", 1)
    b = _write(tmp_path / "b.nef", 2)
    sess = DevelopSession(DevelopEngine.open(a, device="cpu"), None, None)
    calls = []
    real_open = DevelopEngine.open

    def counting_open(path, **kw):
        calls.append(kw)
        return real_open(path, **kw)

    monkeypatch.setattr(DevelopEngine, "open", staticmethod(counting_open))
    assert sess.prefetch(b)["ok"] and sess.prefetch(b)["ok"]
    sess._prefetch[1].join(timeout=60)
    assert len(calls) == 1 and calls[0]["device"] == "cpu"
    out = sess.open(b)
    assert out["ok"] and out["path"] == b and len(calls) == 1
    assert sess._prefetch is None
    assert sess.set_slider("exposure", 0.4)["ok"]
    assert sess.open(a)["ok"] and len(calls) == 2
    # A missing target fails at once; a corrupt one fails at open.
    assert sess.prefetch(str(tmp_path / "nope.nef"))["ok"] is False
    junk = tmp_path / "junk.nef"
    junk.write_bytes(b"not raw" * 64)
    assert sess.prefetch(str(junk))["ok"]
    out = sess.open(str(junk))
    assert out["ok"] is False and "decode" in out["error"]
    assert sess.set_slider("exposure", 0.2)["ok"]
    sess.close()


# -- state carried across the two packages --------------------------------

def test_a_catalog_carries_edits_and_history_between_the_packages(
        tmp_path):
    """A catalog written by the JAX session opens in the port's session
    with the same params and history, and the other way round."""
    path = _write(tmp_path / "a.nef", 5)
    db = tmp_path / "cat.db"
    with JaxLibrary(db) as lib:
        image_id = lib.import_image(path, "a.nef")
        js = JaxSession(JaxEngine.open(path), lib, image_id)
        for line in ("set exposure 0.4", "set sharpen 30", "checkpoint",
                     "curve set 0 0 0.5 0.55 1 1", "rate 3 pick"):
            assert js.handle(line)["ok"], line
        want = js.handle("history")
        js.close()
    with Library(db) as lib:
        ps = DevelopSession(DevelopEngine.open(path, device="cpu"), lib,
                            image_id)
        assert ps.handle("history") == want
        assert ps.params.to_json() == lib.load_edit_params(image_id).to_json()
        assert ps.handle("rate")["rating"] == 3
        for line in ("undo", "set contrast 12", "checkpoint"):
            assert ps.handle(line)["ok"], line
        want = ps.handle("history")
        ps.close()
    with JaxLibrary(db) as lib:
        js = JaxSession(JaxEngine.open(path), lib, image_id)
        assert js.handle("history") == want
        assert js.params.to_json() == json.dumps(want["history"][-1])
        js.close()
