"""The benchmark of ``wfa_tpu_torch.align_pairs`` on the card: one cell, one
seed, one run.

    python3 wfabench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration file, ``traffic/<traffic>.json``,
the generator ``gen/<generator>.py`` that the traffic names, and a reader
``metrics/<metric>.py`` for each per-layer metric the cell reports.  A run:

1. set-up (``setup_s``, from process start): imports, the native library
   and the kernels (built on a checkout's first run), the pool of distinct
   batches made from the seed, and one call on each batch;
2. with ``--trace 1``, the host spans that the cell's readers name and a
   ``torch.profiler`` slice over the traffic's ``trace_calls`` calls;
3. the window: one client calls ``align_pairs`` back to back, cycling
   through the pool, for ``--seconds``; only calls that return inside it
   count towards ``aln_per_s`` and ``call_p95_ms``;
4. after the window, with the program's peak memory read, the reference
   (``reference/``) on every distinct pair of the pool, on the card, and
   every answer of every call judged against it.

The last line of standard output is the result; the numbers judged, with
their limits, close standard error and the result.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "wfa_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT, bench: Path = BENCH) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"wfabench: no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)])


def load_module(path: Path):
    """A generator or reader module from its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "wfabench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Run:
    """What a run measured, for the per-layer readers."""

    cell: Cell
    calls: list[tuple[float, float, int]]   # counted calls: start, end, batch
    pairs: int                              # pairs of the counted calls
    on_card: int                            # of those, finished on the card
    spans: dict[str, float]                 # span seconds over counted calls
    span_calls: dict[str, int]              # span entries over counted calls
    slice: dict | None = None               # devslice.read of the slice
    least_s: float | None = None            # the slice's kernel work, least time


class Spans:
    """Host clocks around the program's functions (``module:attribute``),
    each also a ``record_function`` range for the profiler."""

    def __init__(self, specs: dict[str, str]):
        self.specs = specs
        self.seconds = dict.fromkeys(specs, 0.0)
        self.count = dict.fromkeys(specs, 0)

    def install(self) -> None:
        from torch.profiler import record_function

        for name, target in self.specs.items():
            mod_name, attr = target.split(":")
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)

            def wrapper(*a, _fn=fn, _name=name, **kw):
                with record_function("wfabench." + _name):
                    t0 = time.perf_counter()
                    try:
                        return _fn(*a, **kw)
                    finally:
                        self.seconds[_name] += time.perf_counter() - t0
                        self.count[_name] += 1

            setattr(mod, attr, wrapper)

    def reset(self) -> None:
        for name in self.specs:
            self.seconds[name] = 0.0
            self.count[name] = 0


class Answers:
    """Every answer of every call, kept small: per call its batch and
    distances, finished flags and on-card flags; CIGARs as the first call
    of each batch gave them, and where a later call differs, its own."""

    def __init__(self, pool, cigar: bool):
        self.pool = pool
        self.cigar = cigar
        self.calls: list[tuple[int, np.ndarray, np.ndarray, np.ndarray, dict]] = []
        self.first_cigars: list[list[str] | None] = [None] * len(pool)

    def add(self, b: int, results) -> int:
        """Record one call's results; returns the pairs finished on the card."""
        n = len(self.pool[b][0])
        res = list(results)[:n]
        got = len(res)
        dist = np.full(n, -1, dtype=np.int64)
        fin = np.zeros(n, dtype=bool)
        card = np.zeros(n, dtype=bool)
        dist[:got] = [r.error for r in res]
        fin[:got] = [r.finished for r in res]
        card[:got] = [r.finished_on_accelerator for r in res]
        diff = {}
        if self.cigar:
            cigs = [r.cigar for r in res] + [""] * (n - got)
            if self.first_cigars[b] is None:
                self.first_cigars[b] = cigs
            elif cigs != self.first_cigars[b]:
                diff = {i: c for i, (c, k) in enumerate(zip(cigs, self.first_cigars[b]))
                        if c != k}
        self.calls.append((b, dist, fin, card, diff))
        return int(card.sum())


def judge(answers: Answers, ref: list[tuple[np.ndarray, np.ndarray]],
          pen: tuple[int, int, int]) -> dict[str, int]:
    """Counts over every answer: distances that differ from the reference
    or are flagged unfinished, CIGARs that do not replay or do not cost the
    reference's distance, and pairs the reference could not finish."""
    x, o, e = pen
    from wfabench.reference.cigar import cost

    def bad_cigar(b: int, i: int, cig: str) -> bool:
        p, t = answers.pool[b][0][i], answers.pool[b][1][i]
        return cost(cig, p, t, x, o, e) != int(ref[b][0][i])

    first_bad = []
    if answers.cigar:
        for b, cigs in enumerate(answers.first_cigars):
            first_bad.append(np.array([bad_cigar(b, i, c) for i, c in enumerate(cigs)])
                             if cigs is not None else None)
    wrong_d = wrong_c = unjudged = attempted = failed = 0
    for b, dist, fin, _, diff in answers.calls:
        rd, rf = ref[b]
        bad = ~fin | (dist != rd)
        unj = ~rf
        if answers.cigar:
            cbad = first_bad[b].copy()
            for i, c in diff.items():
                cbad[i] = bad_cigar(b, i, c)
            cbad &= rf
            wrong_c += int(cbad.sum())
            bad = bad | cbad
        wrong_d += int((~fin | (dist != rd))[rf].sum())
        unjudged += int(unj.sum())
        attempted += len(dist)
        failed += int((bad | unj).sum())
    out = {"wrong_distance": wrong_d, "unjudged": unjudged}
    if answers.cigar:
        out["wrong_cigar"] = wrong_c
    out["attempted"], out["failed"] = attempted, failed
    return out


LIMITS = {"wrong_distance": 0, "wrong_cigar": 0, "unjudged": 0}


def setting(cell: Cell, control: bool = False):
    """The reference's setting for a cell; ``control`` breaks the guarantee
    the configuration states, as its ``control`` entry says."""
    from wfabench.reference.wfa import Setting

    c = cell.config
    x, o, e = c["penalties"]
    st = Setting(x, o, e, int(c["max_error"]), c.get("band", -1), c.get("band_width", 0))
    if control:
        st = dataclasses.replace(st, **c["control"]["setting"])
    return st


def reference(cell: Cell, pool, device, control: bool = False):
    """(distance, finished) of every pair of the pool, by batch."""
    from wfabench.reference import wfa

    st = setting(cell, control)
    out = []
    for pats, txts in pool:
        if control and not st.banded:
            # The truncated, uncertified window: the scores a centred
            # window of ``wf_width`` diagonals finds.
            d, f = wfa.run_window(st, pats, txts, device)
        else:
            d, f = wfa.distances(st, pats, txts, device)
        out.append((d, f))
    return out


def options(cell: Cell, backend: str):
    from wfa_tpu_torch import AlignmentOptions, Penalties

    c, t = cell.config, cell.traffic
    kw = dict(penalties=Penalties(*c["penalties"]),
              max_error=int(c["max_error"]),
              compute_cigar=bool(t.get("compute_cigar", False)), backend=backend)
    if c.get("band", -1) > 0:
        kw.update(band=c["band"], band_width=c["band_width"])
    return AlignmentOptions(**kw)


def _launches(counts: dict[str, int]) -> int:
    """Kernel launches in ``engine_cuda.LAUNCHES``: every key but the row
    placements of K1/K2 and the compact ring's second count of K4."""
    return sum(v for key, v in counts.items()
               if not key.startswith("rows_") and not key.endswith("_compact"))


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _power_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def execute(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
            backend: str = "cuda", fault=None) -> tuple[dict, list[str]]:
    """One run of ``cell``; returns (result, check lines).  ``backend``
    'torch' runs the plain engine on the CPU, for the tests; ``fault``
    wraps ``align_pairs`` to break it, for the tests."""
    import torch

    import wfa_tpu_torch
    from wfa_tpu_torch.ops import engine_cuda

    on_card = backend == "cuda"
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    gen = load_module(BENCH / "gen" / f"{cell.traffic['generator']}.py")
    pool = gen.make_pool(cell.traffic, cell.config["batch_size"], seed, BENCH / "data")
    opts = options(cell, backend)
    align = wfa_tpu_torch.align_pairs if fault is None else fault(wfa_tpu_torch.align_pairs)
    answers = Answers(pool, opts.compute_cigar)
    readers = {m["name"]: load_module(BENCH / "metrics" / f"{m['name']}.py")
               for m in (cell.per_layer if trace else [])}
    spans = Spans({k: v for r in readers.values() for k, v in getattr(r, "SPANS", {}).items()})

    for b, (pats, txts) in enumerate(pool):       # warm-up: every batch once
        answers.add(b, align(pats, txts, opts))
    gc.collect()
    setup_s = time.perf_counter() - t_start

    k = 0
    run_slice = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        spans.install()
        n_slice = int(cell.traffic.get("trace_calls", 10))
        before = _launches(engine_cuda.LAUNCHES)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        tmp = Path(tempfile.mkdtemp(prefix="wfabench_"))
        try:
            with profile(activities=acts) as prof:
                for _ in range(n_slice):
                    b = k % len(pool)
                    with record_function("wfabench.call"):
                        answers.add(b, align(*pool[b], opts))
                    k += 1
                if on_card:
                    torch.cuda.synchronize(dev)
            prof.export_chrome_trace(str(tmp / "trace.json"))
            from wfabench import devslice

            run_slice = devslice.read(tmp / "trace.json")
        finally:
            for f in tmp.iterdir():
                f.unlink()
            tmp.rmdir()
        slice_batches = [(k0 % len(pool)) for k0 in range(n_slice)]
        launched = _launches(engine_cuda.LAUNCHES) - before
        if on_card and run_slice["port_kernels"] != launched:
            raise RuntimeError(
                f"the profiler slice holds {run_slice['port_kernels']} of the port's "
                f"kernels where LAUNCHES counted {launched}")
        spans.reset()

    calls = []
    pairs = card = 0
    t_begin = time.perf_counter()
    deadline = t_begin + seconds
    while True:
        b = k % len(pool)
        t0 = time.perf_counter()
        res = align(*pool[b], opts)
        t1 = time.perf_counter()
        k += 1
        n_card = answers.add(b, res)
        if t1 > deadline:
            break
        calls.append((t0, t1, b))
        pairs += len(pool[b][0])
        card += n_card
    if not calls:
        raise RuntimeError(f"no call returned within {seconds} s")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
              "count": cell.chips if on_card else 0, "memory_peak_bytes": int(peak)}

    t_ref = time.perf_counter()
    ref = reference(cell, pool, dev)
    ref_s = time.perf_counter() - t_ref
    pen = tuple(cell.config["penalties"])
    counts = judge(answers, ref, pen)
    run = Run(cell, calls, pairs, card, dict(spans.seconds), dict(spans.count), run_slice)
    if run_slice is not None:
        from wfabench import roofline
        from wfabench.reference.wfa import scores

        st = setting(cell)
        width = st.wf_width if st.banded else 2 * st.max_steps + 1
        top = int(max(int(d.max()) for d, _ in ref))
        sched = np.array([s[0] for s in scores(st.x, st.o, st.e, 10**9, top)])
        least = 0.0
        for b in slice_batches:
            pats, txts = pool[b]
            ops, nbytes = roofline.work(
                sched, pen, width, ref[b][0],
                np.array([len(p) for p in pats]), np.array([len(t) for t in txts]),
                opts.compute_cigar)
            least += roofline.least_seconds(nbytes, ops)
        run.least_s = least

    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = readers[m["name"]].read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device["busy_s"] = run_slice["busy_s"]
        device["window_s"] = run_slice["window_s"]
    else:
        durs = np.array([b - a for a, b, _ in calls])
        values = {"aln_per_s": pairs / seconds,
                  "call_p95_ms": float(np.percentile(durs, 95)) * 1e3,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    checks = {name: {"value": counts[name], "limit": LIMITS[name]}
              for name in LIMITS if name in counts}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": counts["attempted"], "failed": counts["failed"],
              "metrics": metrics, "device": device}
    if trace:
        result["breakdown"] = {"device_ops": run_slice["device_ops"],
                               "idle_gaps": run_slice["idle_gaps"]}
    result["checks"] = checks
    q = np.percentile([b - a for a, b, _ in calls], [10, 50, 90, 99, 100]) * 1e3
    lines = [f"calls {len(calls)}, ms: p10 {q[0]:.2f} p50 {q[1]:.2f} p90 {q[2]:.2f} "
             f"p99 {q[3]:.2f} max {q[4]:.2f}; reference {ref_s:.1f} s"]
    lines += [f"check {name} {c['value']} limit {c['limit']}" for name, c in checks.items()]
    return result, lines


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = find_cell(args.workload)
    # One process per card: only the cell's cards are visible, so that
    # data_parallel spreads over exactly them.
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(visible.split(",")[: cell.chips])
    else:
        os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(map(str, range(cell.chips)))
    # Kernel caches of any library the program may use stay in the checkout.
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)
    import torch

    if not torch.cuda.is_available():
        print("wfabench: no CUDA device; the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() != cell.chips:
        print(f"wfabench: {torch.cuda.device_count()} cards visible, the cell "
              f"asks for {cell.chips}", file=sys.stderr)
        return 2
    print(f"card: {_power_line()}", file=sys.stderr, flush=True)
    result, lines = execute(cell, args.seed, args.seconds, bool(args.trace), t_start)
    found = forbidden_modules()
    if found:
        print("wfabench: modules of JAX or the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
