"""CLI and writer: the program's `cli.drain` spans a job (the main
thread waiting for the writer thread's PAF text after the pipeline
returns), in ms."""

from gpubench import spanlog


def read(ctx):
    return spanlog.span_ms_per_job(ctx, "cli.drain")
