"""The control and the planted faults the check must read as not correct.

Each is a context manager that breaks the timed path underneath the
harness, by module attribute, and restores it on exit:

- ``control_bf16``: the reference put in the program's place and computed
  in bfloat16, the precision below the configuration's f32. The develop
  kernels' wrappers run their plain versions (the reference's math, the
  port's own copy of it) and the session's previews run, all under
  ``yardstick.control.bf16``;
- ``altered_answer``: the develop's output altered where it is produced
  (one luma sample of the first image of every batch, one slot of the
  exporter's eight, or one sample of the preview, moved by 9);
- ``half_batch_dropped``: the exporter leaves every other image of its
  encode queue unwritten;
- ``quality_lowered``: the exporter's JPEGs written at quality 90, not
  the configuration's 95 (a cheaper encode);
- ``stale_state``: the session answers ``set`` without changing its edit.

Used by ``test_faults.py`` on the CPU at a tiny frame and by
``chip_readings.py`` on the card at the cells' size."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(pairs):
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in pairs]
    try:
        for mod, name, value in pairs:
            setattr(mod, name, value)
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


@contextlib.contextmanager
def control_bf16():
    from raweditor_tpu_torch.ops import develop as dv
    from raweditor_tpu_torch.ops import fused_develop as fd
    from raweditor_tpu_torch.ops import fused_extras as fx

    from bench_torch.yardstick.control import bf16

    def develop(mosaics, scal, cfa_phase=(0, 0), gamma="pow",
                output="rgba", demosaic="nearest", pattern=None):
        with bf16():
            return fd.develop_rgba_folded_plain(mosaics, scal, cfa_phase,
                                                gamma, output, demosaic,
                                                pattern)

    def extras(words, table, *, mixer_on, grading_on, stencils,
               output="rgba"):
        with bf16():
            return fx.finish_extras_plain(words, table, mixer_on,
                                          grading_on, stencils, output)

    def lowered(fn):
        def run(*args, **kwargs):
            with bf16():
                return fn(*args, **kwargs)
        return run

    with _patched([(fd, "fused_batch_develop_rgba", develop),
                   (fx, "fused_finish_extras_rgba", extras),
                   (dv, "develop_preview", lowered(dv.develop_preview)),
                   (dv, "develop_xtrans_preview",
                    lowered(dv.develop_xtrans_preview))]):
        yield


def _bump(t):
    """Move one sample by 9 (mod 256) in place: the pixel (1, 1) of a
    (..., H, W) u8 plane, or of an (H, W, 3) preview's red channel."""
    if t.dim() == 3 and t.shape[-1] == 3:
        t[1, 1, 0] = (t[1, 1, 0].to(int) + 9) % 256
    else:
        t[..., 1, 1] = (t[..., 1, 1].to(int) + 9) % 256
    return t


@contextlib.contextmanager
def altered_answer():
    from raweditor_tpu_torch.ops import develop as dv
    from raweditor_tpu_torch.ops import fused_develop as fd
    from raweditor_tpu_torch.ops import fused_extras as fx

    def planes_bumped(fn):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            if isinstance(out, tuple):
                _bump(out[0][0])
            return out
        return run

    def preview_bumped(fn):
        def run(*args, **kwargs):
            return _bump(fn(*args, **kwargs))
        return run

    with _patched([
            (fd, "fused_batch_develop_rgba",
             planes_bumped(fd.fused_batch_develop_rgba)),
            (fx, "fused_finish_extras_rgba",
             planes_bumped(fx.fused_finish_extras_rgba)),
            (dv, "develop_preview", preview_bumped(dv.develop_preview)),
            (dv, "develop_xtrans_preview",
             preview_bumped(dv.develop_xtrans_preview))]):
        yield


@contextlib.contextmanager
def half_batch_dropped():
    import itertools
    import threading

    from raweditor_tpu_torch.pipeline import export

    encode = export._encode_one_jpeg420
    count, lock = itertools.count(), threading.Lock()

    def every_other(out_path, *args, **kwargs):
        with lock:
            i = next(count)
        if i % 2:
            return None
        return encode(out_path, *args, **kwargs)

    with _patched([(export, "_encode_one_jpeg420", every_other)]):
        yield


@contextlib.contextmanager
def quality_lowered():
    from raweditor_tpu_torch.pipeline import export

    encode = export._encode_one_jpeg420

    def at_90(out_path, y, cb, cr, quality, *args, **kwargs):
        return encode(out_path, y, cb, cr, min(int(quality), 90), *args,
                      **kwargs)

    with _patched([(export, "_encode_one_jpeg420", at_90)]):
        yield


@contextlib.contextmanager
def stale_state():
    from raweditor_tpu_torch.pipeline.session import DevelopSession

    def set_slider(self, name, value):
        return {"ok": True, "slider": name, "value": float(value),
                "render_ms": 0.0}

    with _patched([(DevelopSession, "set_slider", set_slider)]):
        yield


FAULTS = {"control_bf16": control_bf16, "altered_answer": altered_answer,
          "half_batch_dropped": half_batch_dropped,
          "quality_lowered": quality_lowered, "stale_state": stale_state}
# The faults each traffic's cells can have.
BY_DRIVER = {"catalog_export": ("control_bf16", "altered_answer",
                                "half_batch_dropped", "quality_lowered"),
             "slider_session": ("control_bf16", "altered_answer",
                                "stale_state")}
