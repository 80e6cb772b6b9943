"""card_share: the window's pairs that the card finished
(``AlignmentResult.finished_on_accelerator``), against all its pairs, %.
The rest went through the retry ladder to the CPU fallback, whose time is
the span ``fallback`` (``native.cpu_align_batch``), which labels the
slice's idle gaps."""

SPANS = {"fallback": "wfa_tpu_torch.native:cpu_align_batch"}


def read(run):
    return run.on_card / run.pairs * 100.0
