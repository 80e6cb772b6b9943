"""A ``torch.profiler`` slice over a few calls, read from its Chrome trace.

The harness marks each call and each host span with ``record_function``
(``wfabench.call``, ``wfabench.<span>``); the trace puts those ranges and
the card's kernels and copies on one clock.  ``read`` gives the slice's
length (first call's start to last call's end), the time some kernel, copy
or memset ran on the card, the port's kernels' time and count, the device
operations by time, and the time with nothing on the card split by what
the host was doing then: the span open over each part of a gap ("other"
where none was).
"""
from __future__ import annotations

import collections
import json
import re
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# The port's kernels: K1, K2 and K4 (wfa_kernel<...>) and K3.
PORT_KERNEL = re.compile(r"\bwfa_(?:traceback_)?kernel\b")
CALL = "wfabench.call"
SPAN_PREFIX = "wfabench."


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def read(path: Path, top: int = 10) -> dict:
    """Times in seconds; see the module's docstring."""
    events = json.loads(path.read_text())["traceEvents"]
    calls, spans, device = [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        a = float(ev["ts"])
        b = a + float(ev["dur"])
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat == "user_annotation" and name == CALL:
            calls.append((a, b))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append((a, b, name[len(SPAN_PREFIX):]))
        elif cat in DEVICE_CATS:
            device.append((a, b, name))
    if not calls:
        raise ValueError(f"{path}: no {CALL} range in the trace")
    t0 = min(a for a, _ in calls)
    t1 = max(b for _, b in calls)
    inside = [(max(a, t0), min(b, t1), n) for a, b, n in device if b > t0 and a < t1]
    busy = _union([(a, b) for a, b, _ in inside])
    by_name: dict[str, float] = collections.defaultdict(float)
    for a, b, n in inside:
        by_name[n] += b - a
    port = [(a, b) for a, b, n in inside if PORT_KERNEL.search(n)]
    idle: dict[str, float] = collections.defaultdict(float)
    prev = t0
    for a, b in busy + [(t1, t1)]:
        if a > prev:
            covered = 0.0
            for sa, sb, sn in spans:
                part = max(0.0, min(sb, a) - max(sa, prev))
                idle[sn] += part
                covered += part
            idle["other"] += (a - prev) - covered
        prev = max(prev, b)
    return {
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "port_kernel_s": sum(b - a for a, b in port) * 1e-6,
        "port_kernels": sum(1 for _, _, n in device if PORT_KERNEL.search(n)),
        "calls": len(calls),
        "device_ops": [[n, s * 1e-6] for n, s in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n, s * 1e-6] for n, s in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
    }
