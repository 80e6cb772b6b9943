"""Static wavefront schedule, precomputed on the host.

The port's own copy of ``wfa_tpu/schedule.py``.  Whether the wavefront of
score ``d`` exists, and whether it needs the full M/I/D recurrence or only
the mismatch one, depends only on the penalties (x, o, e), never on the
sequences (lib/kernels/sequence_alignment_kernel.cu:584-626):

    GAP_exist(d) = M_exist(d-o-e) or I_exist(d-e)
    M_exist(d)   = GAP_exist(d) or M_exist(d-x)        (M_exist(0) = True)
    I_exist(d)   = GAP_exist(d)

So the control flow of the score loop is a table: one row per computed
wavefront with its score and the ring slots of its parents.  The plain
engine and the CUDA kernels both read it.

The step bookkeeping mirrors the reference, including the quirk that
``steps`` counts only full-MDI computations plus one
(sequence_alignment_kernel.cu:566-654): the loop runs
``while steps < max_steps - 1``, ``steps`` starts at 1, and only
``next_MDI`` iterations increment it.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .types import Penalties

STEP_M_ONLY = 0  # only the mismatch recurrence contributes (next_M)
STEP_MDI = 1     # full M/I/D recurrence (next_MDI)


@dataclasses.dataclass(frozen=True)
class WavefrontSchedule:
    """Host-precomputed schedule of the score loop.

    All arrays have length ``num_steps`` (computed wavefronts; skipped scores
    are folded into the bookkeeping).  Ring slots are ``score % ring_size``
    with ``ring_size = max(o+e, x) + 1``; a parent slot of ``-1`` means that
    parent wavefront does not exist at this step.
    """

    penalties: Penalties
    max_steps: int
    num_steps: int
    score: np.ndarray          # int32[num_steps]
    kind: np.ndarray           # int32[num_steps]: STEP_M_ONLY or STEP_MDI
    out_slot: np.ndarray       # int32[num_steps]
    mx_slot: np.ndarray        # int32[num_steps]: M at d-x
    moe_slot: np.ndarray       # int32[num_steps]: M at d-o-e
    ide_slot: np.ndarray       # int32[num_steps]: I/D at d-e
    mdi_index: np.ndarray      # int32[num_steps]: index among MDI steps, or -1
    num_mdi_steps: int
    # Score an unfinished alignment reports: the last processed score + 1.
    unfinished_score: int

    @property
    def ring_size(self) -> int:
        return self.penalties.active_working_set


@functools.lru_cache(maxsize=64)
def _existence(x: int, o: int, e: int, up_to: int) -> tuple[np.ndarray, np.ndarray]:
    """M/I existence bitmaps for scores 0..up_to (inclusive)."""
    m = np.zeros(up_to + 1, dtype=bool)
    i = np.zeros(up_to + 1, dtype=bool)
    m[0] = True
    for d in range(1, up_to + 1):
        gap = (d - o - e >= 0 and m[d - o - e]) or (d - e >= 0 and i[d - e])
        i[d] = gap
        m[d] = gap or (d - x >= 0 and m[d - x])
    return m, i


@functools.lru_cache(maxsize=64)
def build_schedule(
    penalties: Penalties, max_steps: int, score_limit: int | None = None
) -> WavefrontSchedule:
    """Simulate the reference score loop's control flow on the host
    (sequence_alignment_kernel.cu:566-657); scores above ``score_limit`` are
    never enumerated."""
    x, o, e = penalties.x, penalties.o, penalties.e
    ring = penalties.active_working_set
    # Each processed iteration advances the score by at least 1, there are
    # < max_steps MDI steps, and at most max(x, o+e) scores lie between two.
    score_cap = max_steps * (max(x, o + e) + 1) + ring + 2
    m_exist, i_exist = _existence(x, o, e, score_cap)

    scores: list[int] = []
    kinds: list[int] = []
    d = 1
    steps = 1
    while steps < max_steps - 1 and (score_limit is None or d <= score_limit):
        if i_exist[d]:
            scores.append(d)
            kinds.append(STEP_MDI)
            steps += 1
        elif m_exist[d]:
            scores.append(d)
            kinds.append(STEP_M_ONLY)
        d += 1
        if d >= score_cap:  # pragma: no cover - defensive
            break

    score = np.asarray(scores, dtype=np.int32)
    kind = np.asarray(kinds, dtype=np.int32)
    n = len(scores)
    out_slot = (score % ring).astype(np.int32)

    def parent(delta: int, exist: np.ndarray) -> np.ndarray:
        pd = score - delta
        ok = (pd >= 0) & exist[np.clip(pd, 0, None)]
        return np.where(ok, (score - delta) % ring, -1).astype(np.int32)

    mdi_index = np.where(kind == STEP_MDI, np.cumsum(kind == STEP_MDI) - 1, -1)
    return WavefrontSchedule(
        penalties=penalties,
        max_steps=max_steps,
        num_steps=n,
        score=score,
        kind=kind,
        out_slot=out_slot,
        mx_slot=parent(x, m_exist),
        moe_slot=parent(o + e, m_exist),
        ide_slot=parent(e, i_exist),
        mdi_index=mdi_index.astype(np.int32),
        num_mdi_steps=int((kind == STEP_MDI).sum()),
        unfinished_score=int(score[-1]) + 1 if n else 1,
    )


@functools.lru_cache(maxsize=64)
def cone_radii(
    penalties: Penalties, max_steps: int, score_limit: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """The cone of each scheduled step: the diagonals ``|k| <= radius`` that
    its score can reach, by the exact-mode kernels' rule, and the radius of
    the step that last wrote the same out slot (0 if none did).

    Score 0 reaches diagonal 0 only.  A step reaches as far as its mismatch
    parent (M at d-x) and one diagonal further than its gap parents (M at
    d-o-e, I/D at d-e): ``max(r[mx], r[moe] + 1, r[ide] + 1)`` over the
    parents that exist.  Outside the cone every offset is NULL or derived
    from NULL.  The radii are uncapped; a window of W diagonals caps both at
    W // 2.  Returns two int32 arrays of ``num_steps``."""
    sched = build_schedule(penalties, max_steps, score_limit)
    slot_radius = [0] * sched.ring_size
    radius = np.zeros(sched.num_steps, dtype=np.int32)
    previous = np.zeros(sched.num_steps, dtype=np.int32)
    for i in range(sched.num_steps):
        r = 0
        for slot, grow in ((sched.mx_slot[i], 0), (sched.moe_slot[i], 1),
                           (sched.ide_slot[i], 1)):
            if slot >= 0:
                r = max(r, slot_radius[slot] + grow)
        out = sched.out_slot[i]
        previous[i] = slot_radius[out]
        radius[i] = slot_radius[out] = r
    # The cache hands the same arrays to every caller.
    radius.flags.writeable = previous.flags.writeable = False
    return radius, previous
