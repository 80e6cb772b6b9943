"""kernel_roofline: the least time the slice's kernel work could take on
the card (``wfabench/roofline.py``, from the inputs and the reference's
distances), against the port's kernels' device time over the slice, %."""


def read(run):
    if run.slice is None or not run.slice["port_kernel_s"] or run.least_s is None:
        return None
    return run.least_s / run.slice["port_kernel_s"] * 100.0
