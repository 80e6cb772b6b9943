"""On the card: each cell's control at the cell's own size, on three seeds,
comes out not correct, and a short run of each cell comes out correct.

    python -m pytest --noconftest -p no:cacheprovider -m cuda wfabench/tests/test_wfabench_card.py

Skips without a CUDA device."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from wfabench import control, harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2**31 + 501, 2**31 + 502, 2**31 + 503)


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(cell):
    device = _card()
    for seed in SEEDS:
        counts = control.control_counts(harness.find_cell(cell), seed, device)
        assert counts["wrong_distance"] > harness.LIMITS["wrong_distance"], counts


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(cell):
    _card()
    proc = subprocess.run(
        [sys.executable, "wfabench/run.py", "--workload", cell, "--seed",
         str(2**31 + 77), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
