"""Wall-clock timing and the profiler hook.

Role of the reference's CLOCK_INIT/START/STOP/REPORT macros
(utils/wf_clock.h:29-54, used around file reads and the alignment run at
tools/aligner.c:288-309,450-474), plus an opt-in ``torch.profiler`` trace
of the card (the Nsight ``aligner-profile`` build-flavor analog,
Makefile:23-25).
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

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


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """``torch.profiler`` trace around a region, written to
    ``log_dir/trace.json`` (Chrome trace format: chrome://tracing, Perfetto).

    No-op when ``log_dir`` is None, so callers can thread a CLI flag through
    unconditionally.  Records host activity on every thread (the pipeline
    runs ``align_pairs`` on worker threads), and the card's kernels and
    copies when a CUDA device is present.
    """
    if not log_dir:
        yield
        return
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, experimental_config=config) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    LOG.info("profiler trace written to %s", path)
