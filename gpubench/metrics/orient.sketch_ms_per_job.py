"""Orientation: the program's `orient.sketch` spans a job (the stranded
MinHash sets of every sequence and reverse complement a route reads,
built in one batch a route), in ms; None where the program has no such
span."""

from gpubench import spanlog


def read(ctx):
    snap = spanlog.totals()
    if snap is None or "orient.sketch" not in snap["spans"]:
        return None
    return spanlog.span_ms_per_job(ctx, "orient.sketch")
