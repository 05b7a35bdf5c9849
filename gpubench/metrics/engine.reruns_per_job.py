"""Engines: the program's `reruns` counter a job (pairs queued to be
aligned again: escalations, run-cap reruns, the wavefront engine's
hand-backs)."""

from gpubench import spanlog


def read(ctx):
    return spanlog.count_per_job(ctx, "reruns")
