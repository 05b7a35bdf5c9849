"""Orientation: the program's `orient.decide` spans a job (the strand
decisions and distance hints of the route taken: native per pair,
submatrix, NumPy matrix or device matrix), in ms; None where the program
has no such span."""

from gpubench import spanlog


def read(ctx):
    snap = spanlog.totals()
    if snap is None or "orient.decide" not in snap["spans"]:
        return None
    return spanlog.span_ms_per_job(ctx, "orient.decide")
