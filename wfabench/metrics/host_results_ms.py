"""host_results_ms: host ms a call placing each chunk's results (``results``
spans: the ``AlignmentResult`` loop), mean over the window's calls.

Read from the program's own spans (``wfa_tpu_torch.utils.timers.TRACE``),
which loading this reader turns on, over the calls of the window on the
same ``time.perf_counter`` clock.  A program without them reads nothing."""
try:
    from wfa_tpu_torch.utils.timers import TRACE
except ImportError:
    TRACE = None
else:
    TRACE.enable()


def window_calls(run) -> list[dict] | None:
    """The program's records of the window's calls; raises where their
    number differs from the harness's."""
    if TRACE is None or not run.calls:
        return None
    calls = TRACE.calls(run.calls[0][0], run.calls[-1][1])
    if len(calls) != len(run.calls):
        raise RuntimeError(f"the program traced {len(calls)} calls in the window, "
                           f"the harness counted {len(run.calls)}")
    return calls


def read(run):
    calls = window_calls(run)
    if not calls or not any("results" in c["stages"] for c in calls):
        return None
    return sum(c["stages"]["results"]["wall"] for c in calls
               if "results" in c["stages"]) / len(calls) * 1e3
