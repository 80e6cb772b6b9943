#!/usr/bin/env python
"""Write tests/data/hifi_banded_cigar_w512_b25.json: the reference distances
and CIGARs of the 50 pairs of tests/data/test_hifi.seq from the XLA engine
(``wfa_tpu.ops.engine_xla.align_batch_device``) in banded CIGAR mode at
W=512, band 25, penalties (2,3,1), max_steps 3000 — the configuration of
``bench.py::_bench_hifi_banded_cigar`` — decoded by
``wfa_tpu.native.traceback_batch``.  The PyTorch port's CIGAR path is held
against this file on the card, where jax does not run.

    JAX_PLATFORMS=cpu python tools/torch_make_hifi_cigar_reference.py
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from wfa_tpu import native  # noqa: E402
from wfa_tpu.ops.engine_xla import EngineConfig, align_batch_device  # noqa: E402
from wfa_tpu.ops.packing import pack_batch  # noqa: E402
from wfa_tpu.schedule import build_schedule  # noqa: E402
from wfa_tpu.types import Penalties  # noqa: E402
from wfa_tpu.utils.io import read_seq_file  # noqa: E402
from wfa_tpu.utils.verification import affine_score, check_cigar  # noqa: E402

OUT = ROOT / "tests" / "data" / "hifi_banded_cigar_w512_b25.json"
CONFIG = {"penalties": [2, 3, 1], "wf_width": 512, "band": 25, "max_steps": 3000}


def main() -> int:
    batch = read_seq_file(ROOT / "tests" / "data" / "test_hifi.seq")
    lmax = max(max(len(p), len(t)) for p, t in batch.pairs())
    nwords = lmax // 16 + 2
    pat, plen, vp = pack_batch(batch.patterns, nwords)
    txt, tlen, vt = pack_batch(batch.texts, nwords)
    pen = Penalties(*CONFIG["penalties"])
    cfg = EngineConfig(
        penalties=pen,
        max_steps=CONFIG["max_steps"],
        wf_width=CONFIG["wf_width"],
        compute_cigar=True,
        band=CONFIG["band"],
    )
    out = align_batch_device(
        cfg, jnp.asarray(pat), jnp.asarray(txt),
        jnp.asarray(plen), jnp.asarray(tlen), jnp.asarray(vp & vt),
    )
    dist = np.asarray(out["distance"])
    fin = np.asarray(out["finished"])
    sched = build_schedule(pen, CONFIG["max_steps"], None)
    step_of_score = np.full(int(sched.score[-1]) + 1, -1, dtype=np.int32)
    step_of_score[sched.score] = np.arange(sched.num_steps, dtype=np.int32)
    rows = int(step_of_score[int(dist[fin].max())]) + 2
    cigars, _ = native.traceback_batch(
        np.asarray(out["choices"][:rows]), np.asarray(out["lo_trace"][:rows]),
        step_of_score, dist, fin, batch.patterns, batch.texts, pen,
    )
    for c, d, p, t in zip(cigars, dist, batch.patterns, batch.texts):
        assert c is not None and check_cigar(c, p, t) and affine_score(c, pen) == d
    doc = {
        "source": "tests/data/test_hifi.seq",
        "engine": "wfa_tpu.ops.engine_xla.align_batch_device",
        "decoder": "wfa_tpu.native.traceback_batch",
        "config": CONFIG,
        "distance": dist.astype(int).tolist(),
        "finished": fin.astype(bool).tolist(),
        "cigar": list(cigars),
    }
    OUT.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {OUT}: {int(fin.sum())}/{len(fin)} finished, "
          f"{OUT.stat().st_size} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
