"""Device selection: explicit, never automatic.

``resolve_device("cuda")`` raises when no CUDA device is present instead
of quietly running on the CPU, so a run that asked for the card either
uses it or fails.
"""

from __future__ import annotations

import torch


def resolve_device(name="cuda") -> torch.device:
    """The ``torch.device`` for ``name`` ("cpu", "cuda", "cuda:N" or a
    ``torch.device``). Raises when a CUDA device is asked for and none
    is available."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda is not "
                "available")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
