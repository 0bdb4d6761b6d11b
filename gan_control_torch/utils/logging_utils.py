"""Logging. Unlike the reference's get_logger (utils/logging_utils.py:4-12,
which adds a new handler per call and duplicates log lines), handlers are
attached once per logger."""

from __future__ import annotations

import logging
import sys


def get_logger(name: str) -> logging.Logger:
    import os

    logger = logging.getLogger(name)
    if not logger.handlers:
        # GANCTL_LOG_STDERR: keep stdout machine-parseable (bench.py JSON)
        stream = sys.stderr if os.environ.get("GANCTL_LOG_STDERR") else sys.stdout
        h = logging.StreamHandler(stream)
        h.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
        )
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger
