"""Helpers the readers of the exporter's output stage share (not a metric:
no entry in ``BENCHMARK.json`` names it): the window call's counters when
every slot it developed was shaped, and the sizes the driver records when
they are what the program counted."""

from bench_torch.metrics._stages import stages


def counters(record: dict):
    """The window call's counters when the output stage ran over every
    slot it developed (``shape.images`` equal to ``slots.developed`` and
    above 0), else None: a program without the counters, or a call with
    unshaped flushes, whose plain torch kernels are not the stage's."""
    st = stages(record)
    if st is None:
        return None
    got = st.get("counters", {})
    n = got.get("shape.images", 0)
    return got if n > 0 and n == got.get("slots.developed") else None


def sizes(record: dict):
    """The driver's ``shaped`` list (each written image's sizes in and
    out and what the stage left) when the program shaped exactly those
    images: as many as ``shape.images``, their pixels in and out summing
    to ``shape.in_pixels`` and ``shape.out_pixels``. Else None."""
    got, shaped = counters(record), record.get("shaped")
    if got is None or not shaped:
        return None
    counted = (len(shaped), sum(s["in"][0] * s["in"][1] for s in shaped),
               sum(s["out"][0] * s["out"][1] for s in shaped))
    program = (got["shape.images"], got.get("shape.in_pixels"),
               got.get("shape.out_pixels"))
    return shaped if counted == program else None
