"""``probe_order`` in the port: ``aligner._probe_distances``, the distances
one banded K1 launch at W=128 measures (here its plain version), against
wfa_tpu's Pallas probe in interpret mode; and the option's gate and
defaults.  The hints are integers held in float64; tolerance 0.
"""
import dataclasses

import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

import wfa_tpu_torch
from wfa_tpu.aligner import _probe_distances as jax_probe_distances
from wfa_tpu.types import Penalties as JaxPenalties
from wfa_tpu_torch.aligner import _probe_distances
from wfa_tpu_torch.types import Penalties
from wfa_tpu_torch.utils.synth import random_pairs

from test_presort import _mutate

# Several test processes share the machine's cores with jax's; two
# intra-op threads each keep them from crowding one another.
torch.set_num_threads(2)

CPU = torch.device("cpu")


def test_probe_distances_match_wfa_tpu_interpret():
    """tests/test_presort.py's probe inputs (4 pairs of 480 bp, max_error
    240, band 0 -> 25): the plain version of the W=128 K1 probe against
    wfa_tpu's Pallas probe in interpret mode, unfinished pairs at 1 << 30."""
    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pats, txts = [], []
    for e in (0.02, 0.0, 0.05, 0.01):
        p = rng.choice(bases, size=480).tobytes()
        pats.append(p)
        txts.append(_mutate(rng, p, e))
    with pltpu.force_tpu_interpret_mode():
        want = jax_probe_distances(pats, txts, [0, 1, 2, 3],
                                   JaxPenalties(2, 3, 1), 240, 0)
    assert want is not None
    got = _probe_distances(pats, txts, [0, 1, 2, 3], Penalties(2, 3, 1), 240,
                           0, CPU)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert got[1] == 0.0 and (got < float(1 << 30)).any()


def test_probe_order_only_reorders(monkeypatch):
    """``probe_order`` measures hints on the card only; on the plain engine
    it changes nothing, and the options' defaults are wfa_tpu's."""
    from wfa_tpu.params import AlignmentOptions as JaxOptions

    opts = wfa_tpu_torch.AlignmentOptions()
    assert (opts.data_parallel, opts.probe_order) == (
        JaxOptions().data_parallel, JaxOptions().probe_order) == (True, False)
    called = []
    monkeypatch.setattr("wfa_tpu_torch.aligner._probe_distances",
                        lambda *a: called.append(a))
    rng = np.random.default_rng(3)
    pairs = random_pairs(rng, 3, 4100, 4300, 0.01, n_rate=0.0, empty_rate=0.0)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    base = wfa_tpu_torch.AlignmentOptions(
        penalties=Penalties(2, 3, 1), max_error=200, band=25, band_width=64,
        backend="torch")
    a = wfa_tpu_torch.align_pairs(pats, txts, base)
    b = wfa_tpu_torch.align_pairs(
        pats, txts, dataclasses.replace(base, probe_order=True,
                                        data_parallel=False))
    assert a == b and not called
