"""decode_ms: host time of the CIGAR decode a call, over the window's calls
(spans around ``native.cigar_from_ops_batch``)."""

SPANS = {"decode": "wfa_tpu_torch.native:cigar_from_ops_batch"}


def read(run):
    if not run.span_calls["decode"]:
        return None
    return run.spans["decode"] / len(run.calls) * 1e3
