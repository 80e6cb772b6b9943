"""pack_ms: host time of packing a call, over the window's calls (spans
around ``aligner.pack_batch``, summed)."""

SPANS = {"pack": "wfa_tpu_torch.aligner:pack_batch"}


def read(run):
    if not run.span_calls["pack"]:
        return None
    return run.spans["pack"] / len(run.calls) * 1e3
