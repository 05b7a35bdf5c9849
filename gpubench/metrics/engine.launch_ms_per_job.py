"""Engines: the program's `engine.launch` spans a job (index copies to
the card and the kernel wrappers' launches: the dense groups, the
wavefront and segmented sweeps and replay loops), in ms."""

from gpubench import spanlog


def read(ctx):
    return spanlog.span_ms_per_job(ctx, "engine.launch")
