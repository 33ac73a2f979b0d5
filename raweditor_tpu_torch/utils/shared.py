"""Helpers the develop engine (``pipeline/engine.py``) and the batch
exporter (``pipeline/export.py``) share: the atomic file write, and the
device, stream and event of a thread's CUDA work."""

from __future__ import annotations

import contextlib
import os
import threading

import torch


def _atomic_write(out_path: str, write_fn) -> None:
    """Write via a temp name + rename so an interrupted run never
    leaves a partial file that ``skip_existing`` would later trust.
    ``write_fn(tmp_path)`` produces the file."""
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    tmp_path = (f"{out_path}.{os.getpid()}."
                f"{threading.get_ident()}.tmp")
    try:
        write_fn(tmp_path)
        os.replace(tmp_path, out_path)
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)


@contextlib.contextmanager
def _on(device: torch.device, stream=None):
    """The CUDA device (and ``stream``) current for a thread's work; a
    no-op on the CPU."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device), (torch.cuda.stream(stream)
                                     if stream is not None
                                     else contextlib.nullcontext()):
        yield


def _record_event(device: torch.device):
    """An event recorded on the device's current stream, or None on the
    CPU (where every op has finished when it returns)."""
    if device.type != "cuda":
        return None
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return done
