"""Pipeline: the harness's pipeline span less its orientation span, the
program's four engine spans and its `pipeline.emit_wait` spans, a job:
the pipeline's host time that no span names, in ms."""

from gpubench import spanlog


def read(ctx):
    return spanlog.untraced_ms_per_job(ctx)
