"""Logging (utils/logger.h analog: LOG_DEBUG/INFO/WARN/ERROR to stderr)."""
from __future__ import annotations

import logging
import sys

LOG = logging.getLogger("wfa_tpu_torch")
if not LOG.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("[%(levelname)s] (%(filename)s:%(lineno)d) %(message)s"))
    LOG.addHandler(_h)
    LOG.setLevel(logging.WARNING)


def set_verbosity(level: str) -> None:
    LOG.setLevel(getattr(logging, level.upper()))
