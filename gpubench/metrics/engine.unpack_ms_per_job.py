"""Engines: the program's `engine.unpack` spans a job (results to
CIGARs and stats, certificate and escalation decisions, the router's
scatter), in ms."""

from gpubench import spanlog


def read(ctx):
    return spanlog.span_ms_per_job(ctx, "engine.unpack")
