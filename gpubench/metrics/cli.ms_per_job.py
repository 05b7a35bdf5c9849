"""CLI and writer: the self time of the `cli.main` span a job (FASTA
read, argument parsing, the writer thread's drain after the pipeline
returns), in ms."""


def read(ctx):
    if not ctx["jobs"]:
        return None
    s = ctx["span_s"]
    return 1e3 * (s["cli"] - s["pairs"] - s["pipeline"]) / ctx["jobs"]
