"""Per-module logging (counterpart of ``compactfusion_tpu/utils/logger.py``).

Level comes from ``CFTPU_LOGGING_LEVEL`` (falling back to the reference's
``XDIT_LOGGING_LEVEL``), default INFO; one stdout handler on the package's
root logger.
"""

from __future__ import annotations

import logging
import sys

from compactfusion_tpu_torch import envs

_FORMAT = "%(levelname)s %(asctime)s [%(name)s] %(message)s"
_configured = False


def _level() -> int:
    name = envs.CFTPU_LOGGING_LEVEL.upper()
    return getattr(logging, name, logging.INFO)


def init_logger(name: str) -> logging.Logger:
    global _configured
    logger = logging.getLogger(name)
    if not _configured:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root = logging.getLogger("compactfusion_tpu_torch")
        root.addHandler(handler)
        root.setLevel(_level())
        root.propagate = False
        _configured = True
    return logger
