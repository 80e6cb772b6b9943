"""Wall-clock timing and the profiler hook.

Role of the reference's CLOCK_INIT/START/STOP/REPORT macros
(utils/wf_clock.h:29-54, used around file reads and the alignment run at
tools/aligner.c:288-309,450-474), plus an opt-in ``torch.profiler`` trace
of the card (the Nsight ``aligner-profile`` build-flavor analog,
Makefile:23-25), and ``TRACE``: the spans and counters of each
``align_pairs`` call's host stages.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time

import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

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
    runs ``align_pairs`` on worker threads), with ``TRACE`` on, so that each
    host stage is a ``wfa.<stage>`` range, and the card's kernels and
    copies when a CUDA device is present.
    """
    if not log_dir:
        yield
        return
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    os.makedirs(log_dir, exist_ok=True)
    with TRACE.enabled(), profile(activities=activities,
                                  experimental_config=config) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    LOG.info("profiler trace written to %s", path)


# The span of every site while tracing is off.
_OFF = contextlib.nullcontext()


class _Call:
    """One ``call`` span and everything recorded inside it on its thread."""

    __slots__ = ("id", "thread", "cpu", "spans", "counters")

    def __init__(self, call_id: int) -> None:
        self.id = call_id
        self.thread = threading.get_ident()
        # The thread's CPU clock only around the whole call: on some hosts
        # it is a system call that costs up to milliseconds where it follows
        # a native OpenMP region, so read at every span it adds several
        # percent to a call.
        self.cpu = time.thread_time()
        # Open spans, then each one's (name, parent index or -1, start, end,
        # seconds its children cover) once it closes.
        self.spans: list = []
        self.counters: collections.Counter = collections.Counter()


class _Span:
    __slots__ = ("trace", "name", "call", "parent", "index", "start",
                 "children", "_range")

    def __init__(self, trace: "Trace", name: str) -> None:
        self.trace = trace
        self.name = name

    def __enter__(self) -> "_Span":
        stack = self.trace._stack()
        if stack:
            top = stack[-1]
            self.call, self.parent = top.call, top.index
        else:
            self.call, self.parent = _Call(next(self.trace._ids)), -1
        self.index = len(self.call.spans)
        self.call.spans.append(self)
        self.children = 0.0
        stack.append(self)
        # A range only where a profiler records it: it costs ~10 us.
        self._range = None
        if autograd_profiler._is_profiler_enabled:
            self._range = record_function("wfa." + self.name)
            self._range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(*exc)
        call = self.call
        # The record is a plain tuple, so that no cycle outlives the span.
        call.spans[self.index] = (self.name, self.parent, self.start, end,
                                  self.children)
        stack = self.trace._stack()
        stack.pop()
        if stack:
            stack[-1].children += end - self.start
        else:
            call.cpu = time.thread_time() - call.cpu
            self.trace._done.append(call)
        return False


class Trace:
    """Spans and counters of the host stages of ``align_pairs`` calls, kept
    in memory for the last ``max_calls`` calls.

    ``with TRACE.span(name):`` times a stage on ``time.perf_counter``, under
    the span open on this thread (each thread keeps its own stack).  A
    ``call`` span opened with nothing open on its thread starts a call
    record with a fresh id, which also takes the thread's CPU seconds over
    the call; other spans outside a call are not recorded.
    ``TRACE.count(name, n)`` adds to a counter of the call open on this
    thread; ``TRACE.level(name, n)`` raises one to ``n`` where ``n`` is
    larger (a level, such as a thread count, that a call's passes do not
    add up; ``levels`` names them).  While on, each span is also a
    ``record_function`` range ``wfa.<name>`` where a profiler is recording,
    so that under ``torch.profiler`` the stages share a clock with the
    card's kernels and copies.  Off (the default), a span site costs one
    flag test and returns a shared no-op."""

    def __init__(self, max_calls: int = 4096) -> None:
        self.on = False
        self._done: collections.deque[_Call] = collections.deque(maxlen=max_calls)
        self._local = threading.local()
        self._ids = itertools.count(1)
        self.levels: set[str] = set()

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    @contextlib.contextmanager
    def enabled(self, on: bool = True):
        """On inside the block where ``on``; as it was after it."""
        was = self.on
        self.on = was or on
        try:
            yield self
        finally:
            self.on = was

    def clear(self) -> None:
        self._done.clear()

    def _stack(self) -> list[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str):
        if not self.on:
            return _OFF
        if name != "call" and not self._stack():
            return _OFF
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        if not self.on:
            return
        stack = self._stack()
        if stack:
            stack[0].call.counters[name] += n

    def level(self, name: str, n: int) -> None:
        if not self.on:
            return
        self.levels.add(name)
        stack = self._stack()
        if stack:
            counters = stack[0].call.counters
            counters[name] = max(counters[name], n)

    def calls(self, t0: float = float("-inf"), t1: float = float("inf")) -> list[dict]:
        """The finished calls that lie wholly inside [t0, t1]
        (``time.perf_counter`` seconds), oldest first.  Each: ``id``,
        ``thread``, ``start``, ``end``, ``cpu`` (the thread's CPU seconds
        over the call); ``stages``, by span name, the spans' count ``n``
        and their ``wall`` and ``self`` seconds (self: the duration less
        the part child spans cover); ``other``, the seconds of the call
        that no leaf span covers; ``counters``; and ``spans``, each (name,
        parent index or -1, start, end)."""
        out = []
        for call in list(self._done):
            _, _, start, end, _ = call.spans[0]
            if start < t0 or end > t1:
                continue
            stages: dict[str, dict] = {}
            other = 0.0
            parents = {s[1] for s in call.spans}
            for i, (name, _, a, b, children) in enumerate(call.spans):
                st = stages.setdefault(name, {"n": 0, "wall": 0.0, "self": 0.0})
                st["n"] += 1
                st["wall"] += b - a
                st["self"] += b - a - children
                if i in parents:
                    other += b - a - children
            out.append({
                "id": call.id, "thread": call.thread, "start": start, "end": end,
                "cpu": call.cpu, "stages": stages, "other": other,
                "counters": dict(call.counters),
                "spans": [s[:4] for s in call.spans],
            })
        return out


TRACE = Trace()

