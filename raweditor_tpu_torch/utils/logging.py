"""Structured logging.

Replaces the reference's pervasive emoji println! logging (SURVEY.md §5,
e.g. reference: raw/loader.rs:75,136-143) with standard ``logging`` —
machine-parsable, leveled, and absent from hot paths by default.
"""

from __future__ import annotations

import logging
import os
import sys


def get_logger(name: str = "raweditor_tpu") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s: %(message)s",
                datefmt="%H:%M:%S",
            )
        )
        logger.addHandler(handler)
        level = os.environ.get("RAWEDITOR_TPU_LOG", "WARNING").upper()
        logger.setLevel(getattr(logging, level, logging.WARNING))
        logger.propagate = False
    return logger
