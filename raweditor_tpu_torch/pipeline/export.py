"""Export helpers shared by the engine and the DNG writer.

Only the atomic write is ported so far, with the JAX package's signature
(``raw/dng_out.py`` imports it from here); the batch exporter is still to
come.
"""

from __future__ import annotations

import os


def _atomic_write(out_path: str, write_fn) -> None:
    """Write via a temp name + rename so an interrupted run never
    leaves a partial file that ``skip_existing`` would later trust.
    ``write_fn(tmp_path)`` produces the file."""
    import threading

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    tmp_path = (f"{out_path}.{os.getpid()}."
                f"{threading.get_ident()}.tmp")
    try:
        write_fn(tmp_path)
        os.replace(tmp_path, out_path)
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
