"""Engines: the program's `engine.wait` spans a job (the host waiting
on device-to-host copies of results), in ms."""

from gpubench import spanlog


def read(ctx):
    return spanlog.span_ms_per_job(ctx, "engine.wait")
