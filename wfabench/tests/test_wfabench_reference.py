"""The plain reference against the reference project's golden scores and
the stored adaptive-band scores, and the CIGAR check against stored
CIGARs."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from wfabench.harness import BENCH, load_module
from wfabench.reference.cigar import cost
from wfabench.reference.wfa import Setting, distances, run_window

DATA = Path(__file__).resolve().parents[2] / "tests" / "data"
GEN = load_module(BENCH / "gen" / "pairs.py")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _golden(name, key):
    return -np.array(json.loads((DATA / name).read_text())[key])


@pytest.mark.parametrize("part", [slice(0, 100), slice(500, 600)])
def test_exact_1k_equals_the_golden_scores(part):
    pairs = GEN.read_pairs(DATA / "seq_1000_n1000.seq")[part]
    want = _golden("seq_1000_n1000.golden.json", "results_1000_n1000_x2o3e1")[part]
    d, f = distances(Setting(2, 3, 1, 300), [p for p, _ in pairs], [t for _, t in pairs])
    assert f.all() and (d == want).all()


@pytest.mark.slow
def test_exact_1k_all_and_10k_equal_the_golden_scores():
    for name, key, bound in (("seq_1000_n1000", "results_1000_n1000_x2o3e1", 300),
                             ("seq_10K_n100", "results_10K_n100_x2o3e1", 3000)):
        pairs = GEN.read_pairs(DATA / f"{name}.seq")
        d, f = distances(Setting(2, 3, 1, bound), [p for p, _ in pairs],
                         [t for _, t in pairs])
        assert f.all() and (d == _golden(f"{name}.golden.json", key)).all()


@pytest.mark.parametrize("pen", [(2, 3, 1), (1, 4, 5), (5, 0, 3)])
def test_gotoh_equals_the_wavefront_at_a_full_window(pen):
    pool = GEN.make_pool({"source": "random", "length": [0, 150], "edit_rate": 0.2,
                          "pool_calls": 1}, 40, 11, BENCH / "data")
    pats, txts = pool[0]
    x, o, e = pen
    want = distances(Setting(x, o, e, 0), pats, txts)[0]
    d, f = run_window(Setting(x, o, e, 2000, wf_width=2 * 400 + 1), pats, txts)
    assert f.all() and (d == want).all()


def test_banded_w512_equals_the_stored_hifi_scores():
    ref = json.loads((DATA / "hifi_banded_w512_b25.json").read_text())
    assert ref["config"] == {"penalties": [2, 3, 1], "wf_width": 512, "band": 25,
                             "max_steps": 3000}
    pairs = GEN.read_pairs(DATA / "test_hifi.seq")
    d, f = distances(Setting(2, 3, 1, 3000, 25, 512), [p for p, _ in pairs],
                     [t for _, t in pairs])
    assert f.all() and d.tolist() == ref["distance"]


def test_a_window_too_narrow_misses_optimal_scores():
    pairs = GEN.read_pairs(DATA / "seq_1000_n1000.seq")[:200]
    want = _golden("seq_1000_n1000.golden.json", "results_1000_n1000_x2o3e1")[:200]
    d, f = run_window(Setting(2, 3, 1, 300, wf_width=17), [p for p, _ in pairs],
                      [t for _, t in pairs])
    assert ((d != want) | ~f).sum() > 0
    assert (d[f] >= want[f]).all()


def test_cigar_check_on_the_stored_hifi_cigars():
    ref = json.loads((DATA / "hifi_banded_cigar_w512_b25.json").read_text())
    pairs = GEN.read_pairs(DATA / "test_hifi.seq")
    for (p, t), cig, d in zip(pairs, ref["cigar"], ref["distance"]):
        assert cost(cig, p, t, 2, 3, 1) == d
    (p, t), cig = pairs[0], ref["cigar"][0]
    first = cig.index("M")
    n = int(cig[:first])
    assert cost(f"{n - 1}M1X" + cig[first + 1:], p, t, 2, 3, 1) is None
    assert cost(cig + "1I", p, t, 2, 3, 1) is None
    assert cost(cig.replace("M", "=", 1), p, t, 2, 3, 1) is None
    assert cost("", b"", b"", 2, 3, 1) == 0
    assert cost("2I1D", b"A", b"ACG", 2, 3, 1) is None
    assert cost("1M2I", b"A", b"ACG", 2, 3, 1) == 5
    assert cost("1M1I1I", b"A", b"ACG", 2, 3, 1) == 5
