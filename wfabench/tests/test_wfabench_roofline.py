"""The kernels' least work, by hand at (2,3,1)."""
from __future__ import annotations

import numpy as np
import pytest

from wfabench import roofline
from wfabench.reference.wfa import scores


def test_scheduled_scores_at_231():
    # M at 2 (a mismatch), gaps from 4 = o + e on; 1 and 3 exist not.
    assert [s[0] for s in scores(2, 3, 1, 10**9, 8)] == [2, 4, 5, 6, 7, 8]
    assert scores(2, 3, 1, 10**9, 6)[-1] == (6, True, True, True)


@pytest.mark.parametrize("cigar", [False, True])
def test_work_by_hand(cigar):
    sched = np.array([s[0] for s in scores(2, 3, 1, 10**9, 20)])
    # Pair 1: distance 6 over scores 2, 4, 5, 6: 1 + 3 + 5 + 7 = 16 cells.
    # Pair 2: distance 7: 16 + 9 = 25 cells.  Pair 3: distance 0, none.
    dist = np.array([6, 7, 0])
    plen, tlen = np.array([32, 33, 10]), np.array([32, 40, 10])
    ops, nbytes = roofline.work(sched, (2, 3, 1), 512, dist, plen, tlen, cigar)
    words = (2 + 2) * 4 + (3 + 3) * 4 + (1 + 1) * 4      # packed rows
    if not cigar:
        assert ops == 41 * 32
        assert nbytes == words + 3 * 14
        return
    # Walks of at least ceil(6/4) = 2 and 2 steps; one choice word a lane of
    # the widest stored score of each group of 8: 7 and 9 words; op streams
    # of max(len) / 4 bytes.
    assert ops == 41 * 38 + 4 * 12
    assert nbytes == words + 3 * 14 + (7 + 9) * 4 + (32 + 40 + 10) / 4


def test_width_caps_the_cone_and_least_time():
    sched = np.array([s[0] for s in scores(2, 3, 1, 10**9, 20)])
    ops, _ = roofline.work(sched, (2, 3, 1), 5, np.array([6]), np.array([9]),
                           np.array([9]), False)
    assert ops == (1 + 3 + 5 + 5) * 32
    assert roofline.least_seconds(3.35e12, 0) == 1.0
    assert roofline.least_seconds(0, 33.5e12) == 1.0
