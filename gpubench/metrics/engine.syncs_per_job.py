"""Engines: the program's `syncs` counter a job (host waits on the
device: each device-to-host copy or copy-future wait)."""

from gpubench import spanlog


def read(ctx):
    return spanlog.count_per_job(ctx, "syncs")
