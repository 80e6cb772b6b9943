"""kernel_ms: device time of the port's kernels (K1-K4) a call, over the
profiler slice's calls."""


def read(run):
    if run.slice is None or not run.slice["port_kernels"]:
        return None
    return run.slice["port_kernel_s"] / run.slice["calls"] * 1e3
