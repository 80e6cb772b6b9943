"""The port's examples (examples/torch_auto_example.py,
examples/torch_manual_example.py) run on the CPU with ``--backend torch``:
the auto example's scores and CIGARs against the exact CPU oracle, the
manual example's banded scores against wfa_tpu's XLA engine at the same
options.  Tolerance 0 (integer scores)."""
import dataclasses
import importlib.util
import re
from pathlib import Path

import torch

from wfa_tpu import AlignmentOptions as JaxOptions
from wfa_tpu import Penalties as JaxPenalties
from wfa_tpu import align_pairs as jax_align_pairs
from wfa_tpu_torch import native
from wfa_tpu_torch.types import Penalties
from wfa_tpu_torch.utils.verification import affine_score, check_cigar

# Several test processes share the machine's cores with jax's; two
# intra-op threads each keep them from crowding one another.
torch.set_num_threads(2)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_auto_example_on_the_plain_engine(capsys):
    ex = _load("torch_auto_example")
    assert ex.main(["--backend", "torch"]) == 0
    out = capsys.readouterr().out
    found = re.findall(r"score:\s+(-?\d+)\s+cigar: (\S+)", out)
    assert len(found) == len(ex.PAIRS)
    pen = Penalties(2, 3, 1)
    for (pattern, text), (score, cigar) in zip(ex.PAIRS, found):
        p, t = pattern.encode(), text.encode()
        assert check_cigar(cigar, p, t)
        assert affine_score(cigar, pen) == -int(score)
        assert native.cpu_align_single(p, t, pen) == -int(score)


def test_manual_example_matches_xla(capsys):
    ex = _load("torch_manual_example")
    assert ex.main(["--backend", "torch"]) == 0
    out = capsys.readouterr().out
    assert "aligned 64 pairs (64 on the device engine)" in out
    scores = [int(s) for s in re.findall(r"pair \d: score (-?\d+)", out)]
    patterns, texts = ex.make_batch()
    opts = ex.options("torch")
    ref = jax_align_pairs(patterns[:3], texts[:3], JaxOptions(
        **{f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)
           if f.name not in ("penalties", "backend")},
        penalties=JaxPenalties(5, 3, 2), backend="xla"))
    assert scores == [-r.error for r in ref]
