"""Kernels: the least time of the window's alignments (`leastwork.py`,
against the card's peaks in `peaks.json`) as a share of the device's
busy time, in %."""


def read(ctx):
    if not ctx["busy_s"] or not ctx["least_s"]:
        return None
    return 100.0 * ctx["least_s"] / ctx["busy_s"]
