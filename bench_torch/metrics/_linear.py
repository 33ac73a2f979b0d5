"""Helpers the readers of the plain LinearRaw lane share (not a metric: no
entry in ``BENCHMARK.json`` names it): the lane's device time in the
traced window and the slots the exporter developed on it.

The lane (``parallel/batch.batch_develop_linear_rgba``: ``ops/develop.
develop_linear`` an image, then the plain 4:2:0 conversion) runs plain
torch operators, so its kernels carry torch's names. Its device time is
that of every kernel of the window that is neither a copy (``core.
summarize`` keeps those apart) nor one of the port's own CUDA kernels,
named in ``PORT_KERNELS``: the develop kernels (``develop_*``), the
extras kernel B8 (``extras_*``), the staging fill (``unpack_slots``) and
the quantiser sweep (``quant_sweep``). In a call that developed LinearRaw
slots alone, that is the lane's time."""

from bench_torch.metrics._stages import stages

PORT_KERNELS = ("develop_", "extras_", "unpack_slots", "quant_sweep")


def lane_s(record: dict):
    """Device seconds of every traced kernel that is not one of the
    port's own, or None when the trace holds none."""
    kernels = (record.get("trace") or {}).get("kernels") or {}
    return sum(t for name, (t, _) in kernels.items()
               if not any(k in name for k in PORT_KERNELS)) or None


def counters(record: dict):
    """The window call's counters when it developed LinearRaw slots and
    no other (``develop.slots.linear`` equal to ``slots.developed`` and
    above 0), else None: a call with other routes runs plain torch
    kernels that are not the lane's."""
    st = stages(record)
    if st is None:
        return None
    got = st.get("counters", {})
    n = got.get("develop.slots.linear", 0)
    return got if n > 0 and n == got.get("slots.developed") else None
