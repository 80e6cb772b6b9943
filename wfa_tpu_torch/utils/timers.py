"""Wall-clock timing (the reference's CLOCK_INIT/START/STOP/REPORT macros,
utils/wf_clock.h:29-54, used around file reads and the alignment run at
tools/aligner.c:288-309,450-474)."""
from __future__ import annotations

import contextlib
import time

from .logger import LOG


class Clock:
    """Start/stop wall clock with an alignments/s report."""

    def __init__(self) -> None:
        self._t0 = 0.0
        self.seconds = 0.0

    def start(self) -> "Clock":
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        self.seconds = time.perf_counter() - self._t0
        return self.seconds

    def report(self, name: str, num_alignments: int | None = None) -> None:
        if num_alignments is not None and self.seconds > 0:
            LOG.info(
                "%s time: %.3fs (%.3f alignments per second)",
                name, self.seconds, num_alignments / self.seconds,
            )
        else:
            LOG.info("%s time: %.3fs", name, self.seconds)


@contextlib.contextmanager
def timed(name: str, num_alignments: int | None = None):
    """``with timed("alignment", n):`` — CLOCK_START/STOP/REPORT in one."""
    c = Clock().start()
    try:
        yield c
    finally:
        c.stop()
        c.report(name, num_alignments)
