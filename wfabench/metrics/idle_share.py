"""idle_share: the share of the profiler slice (first call's start to last
call's end) with no kernel, copy or memset on the card, %."""


def read(run):
    if run.slice is None or not run.slice["window_s"]:
        return None
    return (1.0 - run.slice["busy_s"] / run.slice["window_s"]) * 100.0
