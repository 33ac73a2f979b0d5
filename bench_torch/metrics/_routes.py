"""Helpers the readers of one develop kernel share (not a metric: no
entry in ``BENCHMARK.json`` names it): the slots the exporter counted on
one develop route, and one kernel's device time in the traced window."""

from bench_torch.metrics._stages import stages


def route_slots(record: dict, demosaic: str):
    """{output: slots} of the window call's ``develop.slots.<demosaic>.
    <output>`` counters that read more than 0 (``planes``, ``rgba``), or
    None when the call counted none (a program without route counters,
    or a cell that never takes the route)."""
    st = stages(record)
    if st is None:
        return None
    prefix = f"develop.slots.{demosaic}."
    got = {k[len(prefix):]: n for k, n in st.get("counters", {}).items()
           if k.startswith(prefix) and n > 0}
    return got or None


def kernel_s(record: dict, name: str):
    """Device seconds of every traced kernel whose name contains
    ``name``, or None when the trace holds none."""
    kernels = (record.get("trace") or {}).get("kernels") or {}
    return sum(t for k, (t, _) in kernels.items() if name in k) or None
