"""The bfloat16 and TF32 controls of a web-export cell, beside
``faults.py``'s.

``faults.control_bf16`` puts the reference's develop math in bfloat16 in
place of the develop kernels and the extras kernel; a web export also
runs the output stage. Here:

- ``control_bf16_web``: that, and the exporter's ``long_edge`` resize
  (``ops/resize.resize_rgba_words``) replaced by the reference's resize
  (``yardstick/web_reference.resize_rgb``) under ``yardstick.control.
  bf16``: the whole chain in the precision below the configuration's f32;
- ``control_bf16_resize``: the resize alone so;
- ``control_tf32_resize``: the program's own resize with its matrix
  products allowed TF32 (on a card; the CPU has no TF32, so there it is
  the sound run);
- ``control_tf32_rounded``: the program's own resize with the operands
  of its matrix products rounded to TF32's 10-bit mantissa, as a card's
  TF32 takes them, on any device;
- ``altered_answer_web``: one luma sample of every shaped image moved by
  9 where the output stage leaves it (``ops/jpeg.rgba_words_to_ycbcr420``,
  the words-to-4:2:0 conversion after the resize). ``faults.
  altered_answer`` alters the develop's planes, which a shaped flush does
  not hand on: it asks the develop and the extras for words.

``planes_max_lsb`` catches the bfloat16 controls and the altered answer;
the TF32 ones move no sample by more than one LSB, and only
``planes_off_ppm`` catches them.

    python -m bench_torch.tests.web_control --cells r5_dng.export_web \
        --seeds 3 --fault-seeds 3 --faults \
        control_bf16_web,control_bf16_resize,control_tf32_resize,\
control_tf32_rounded,altered_answer_web --out readings.jsonl

takes ``chip_readings``'s arguments and runs it with these controls among
the faults it can name."""

from __future__ import annotations

import contextlib
import sys

import torch

from bench_torch.tests import faults


def _resize_bf16(words, out_w, out_h, method="lanczos3"):
    """The reference's resize of (H, W) RGBA words, in bfloat16."""
    from raweditor_tpu_torch.ops.develop import pack_rgba, unpack_rgba

    from bench_torch.yardstick import web_reference
    from bench_torch.yardstick.control import bf16

    with bf16():
        rgb = torch.stack([c.to(torch.float32) for c in unpack_rgba(words)])
        small = web_reference.resize_rgb(rgb, out_h, out_w)
    return pack_rgba(small[0], small[1], small[2])


@contextlib.contextmanager
def control_bf16_resize():
    from raweditor_tpu_torch.ops import resize

    with faults._patched([(resize, "resize_rgba_words", _resize_bf16)]):
        yield


@contextlib.contextmanager
def control_bf16_web():
    with faults.control_bf16(), control_bf16_resize():
        yield


@contextlib.contextmanager
def control_tf32_resize():
    from raweditor_tpu_torch.ops import resize

    words = resize.resize_rgba_words

    def tf32(*args, **kwargs):
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return words(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved

    with faults._patched([(resize, "resize_rgba_words", tf32)]):
        yield


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32's 10-bit mantissa, to nearest."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def control_tf32_rounded():
    from raweditor_tpu_torch.ops import resize

    words = resize.resize_rgba_words
    matmul = torch.matmul

    def rounded(*args, **kwargs):
        torch.matmul = lambda a, b: matmul(_tf32(a), _tf32(b))
        try:
            return words(*args, **kwargs)
        finally:
            torch.matmul = matmul

    with faults._patched([(resize, "resize_rgba_words", rounded)]):
        yield


@contextlib.contextmanager
def altered_answer_web():
    from raweditor_tpu_torch.ops import jpeg

    planes = jpeg.rgba_words_to_ycbcr420

    def bumped(words):
        out = planes(words)
        faults._bump(out[0])
        return out

    with faults._patched([(jpeg, "rgba_words_to_ycbcr420", bumped)]):
        yield


FAULTS = {"control_bf16_web": control_bf16_web,
          "control_bf16_resize": control_bf16_resize,
          "control_tf32_resize": control_tf32_resize,
          "control_tf32_rounded": control_tf32_rounded,
          "altered_answer_web": altered_answer_web}


def main(argv=None) -> int:
    from bench_torch.tests import chip_readings

    faults.FAULTS.update(FAULTS)
    return chip_readings.main(argv)


if __name__ == "__main__":
    sys.exit(main())
