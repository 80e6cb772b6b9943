#!/usr/bin/env python
"""Write tests/data/hifi_banded_w512_b25.json: the reference distances and
finished flags of the 50 pairs of tests/data/test_hifi.seq from the XLA
engine (``wfa_tpu.ops.engine_xla.align_batch_device``) in banded distance mode
at W=512, band 25, penalties (2,3,1), max_steps 3000 — the configuration of
``bench.py::_bench_hifi_banded``.  The PyTorch port's kernel and plain engine
are held against this file.

    JAX_PLATFORMS=cpu python tools/torch_make_hifi_reference.py
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

from wfa_tpu.ops.engine_xla import EngineConfig, align_batch_device  # noqa: E402
from wfa_tpu.ops.packing import pack_batch  # noqa: E402
from wfa_tpu.types import Penalties  # noqa: E402
from wfa_tpu.utils.io import read_seq_file  # noqa: E402

OUT = ROOT / "tests" / "data" / "hifi_banded_w512_b25.json"
CONFIG = {"penalties": [2, 3, 1], "wf_width": 512, "band": 25, "max_steps": 3000}


def main() -> int:
    batch = read_seq_file(ROOT / "tests" / "data" / "test_hifi.seq")
    lmax = max(max(len(p), len(t)) for p, t in batch.pairs())
    nwords = lmax // 16 + 2
    pat, plen, vp = pack_batch(batch.patterns, nwords)
    txt, tlen, vt = pack_batch(batch.texts, nwords)
    cfg = EngineConfig(
        penalties=Penalties(*CONFIG["penalties"]),
        max_steps=CONFIG["max_steps"],
        wf_width=CONFIG["wf_width"],
        compute_cigar=False,
        band=CONFIG["band"],
    )
    out = align_batch_device(
        cfg, jnp.asarray(pat), jnp.asarray(txt),
        jnp.asarray(plen), jnp.asarray(tlen), jnp.asarray(vp & vt),
    )
    doc = {
        "source": "tests/data/test_hifi.seq",
        "engine": "wfa_tpu.ops.engine_xla.align_batch_device",
        "config": CONFIG,
        "distance": np.asarray(out["distance"]).astype(int).tolist(),
        "finished": np.asarray(out["finished"]).astype(bool).tolist(),
    }
    OUT.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {OUT}: {sum(doc['finished'])}/{len(doc['finished'])} finished")
    return 0


if __name__ == "__main__":
    sys.exit(main())
