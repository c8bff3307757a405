"""Logging bootstrap, port of ``image_classification_tpu/utils/logging.py``:
the ``ic_tpu`` logger to stdout and, optionally, a file; idempotent unless
``force`` (which closes the handlers it replaces)."""

from __future__ import annotations

import logging
import os
import sys

_CONFIGURED = False


def setup_logging(log_file: str | None = None, level: int = logging.INFO,
                  force: bool = False) -> logging.Logger:
    global _CONFIGURED
    logger = logging.getLogger("ic_tpu_torch")
    if _CONFIGURED and not force:
        return logger
    logger.setLevel(level)
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    _CONFIGURED = True
    return logger
