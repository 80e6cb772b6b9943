"""The pair generator: the same pool for a seed, another for another seed,
the same set of sizes for every seed, no two pairs alike."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from wfabench.harness import BENCH, load_module

GEN = load_module(BENCH / "gen" / "pairs.py")
RANDOM = {"generator": "pairs", "source": "random", "length": [300, 340],
          "edit_rate": 0.06, "pool_calls": 2}
FILE = {"generator": "pairs", "source": "test_hifi.seq.gz", "edit_rate": 0.001,
        "pool_calls": 2}
BATCH = {"random": 16, "file": 100}


def _lengths(pool):
    return sorted(len(p) for pats, _ in pool for p in pats)


@pytest.mark.parametrize("kind", ["random", "file"])
def test_a_seed_repeats_and_seeds_differ(kind):
    traffic, n = (RANDOM if kind == "random" else FILE), BATCH[kind]
    big = 2**31 + 12345
    a = GEN.make_pool(traffic, n, big, BENCH / "data")
    assert a == GEN.make_pool(traffic, n, big, BENCH / "data")
    b = GEN.make_pool(traffic, n, big + 1, BENCH / "data")
    assert a != b
    assert len(a) == traffic["pool_calls"]
    assert all(len(p) == len(t) == n for p, t in a)
    pairs = [(p, t) for pats, txts in a for p, t in zip(pats, txts)]
    assert len(set(pairs)) == len(pairs)


def test_every_seed_draws_the_same_sizes():
    a = GEN.make_pool(RANDOM, 16, 1, BENCH / "data")
    b = GEN.make_pool(RANDOM, 16, 2, BENCH / "data")
    assert _lengths(a) == _lengths(b)
    texts = sorted(len(t) for _, txts in GEN.make_pool(FILE, 100, 3, BENCH / "data")
                   for t in txts)
    assert texts == sorted(len(t) for _, t in GEN.read_pairs(BENCH / "data" / FILE["source"])
                           for _ in range(2 * 100 // 50))


def test_the_cells_traffic_files_are_read_by_the_generator():
    for path in (BENCH / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        small = dict(traffic, pool_calls=1)
        pool = GEN.make_pool(small, 4 if traffic["source"] == "random" else 50, 7,
                             BENCH / "data")
        assert set(b"".join(p for pats, txts in pool for p in pats + txts)) <= set(b"ACGT")


def test_the_data_file_is_the_tests_hifi_pairs():
    root = Path(__file__).resolve().parents[2]
    assert GEN.read_pairs(BENCH / "data" / "test_hifi.seq.gz") == \
        GEN.read_pairs(root / "tests" / "data" / "test_hifi.seq")
