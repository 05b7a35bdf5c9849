"""Engines: the program's `engine.plan` spans a job (routing, length
buckets, band rounds and their groups, the sequence pool's upload on a
miss), in ms."""

from gpubench import spanlog


def read(ctx):
    return spanlog.span_ms_per_job(ctx, "engine.plan")
