"""The bfloat16 control of a LinearRaw cell, beside ``faults.py``'s.

``faults.control_bf16`` puts the reference's math in bfloat16 in place of
the develop kernels and the extras kernel; a LinearRaw frame takes no
develop kernel but the plain LinearRaw lane, so there it would lower the
extras kernel alone. ``control_bf16_linear`` also runs the exporter's
lane (``pipeline.export.batch_develop_linear_rgba``, the port's own copy
of the reference's math) under ``yardstick.control.bf16``: the whole
develop in the precision below the configuration's f32.

    python -m bench_torch.tests.linear_control --cells linear_dng.export \
        --seeds 12 --faults control_bf16_linear,control_bf16 \
        --out readings.jsonl

takes ``chip_readings``'s arguments and runs it with this control among
the faults it can name."""

from __future__ import annotations

import contextlib
import sys

from bench_torch.tests import faults


@contextlib.contextmanager
def control_bf16_linear():
    from raweditor_tpu_torch.pipeline import export

    from bench_torch.yardstick.control import bf16

    lane = export.batch_develop_linear_rgba

    def lowered(*args, **kwargs):
        with bf16():
            return lane(*args, **kwargs)

    with faults.control_bf16(), faults._patched(
            [(export, "batch_develop_linear_rgba", lowered)]):
        yield


FAULTS = {"control_bf16_linear": control_bf16_linear}


def main(argv=None) -> int:
    from bench_torch.tests import chip_readings

    faults.FAULTS.update(FAULTS)
    return chip_readings.main(argv)


if __name__ == "__main__":
    sys.exit(main())
