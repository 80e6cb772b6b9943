"""presort_ms: host time of the divergence presort a call, over the
window's calls (a span around ``aligner.divergence_scores``)."""

SPANS = {"presort": "wfa_tpu_torch.aligner:divergence_scores"}


def read(run):
    if not run.span_calls["presort"]:
        return None
    return run.spans["presort"] / len(run.calls) * 1e3
