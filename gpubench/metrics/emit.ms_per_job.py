"""Emit: the `AllPairAligner._emit_chunk` spans a job (each chunk's
results turned into records and handed to the CLI's writer), in ms.
They run on the pipeline's worker thread, beside the next chunk's
launches and waits, so they overlap the pipeline span's other time."""


def read(ctx):
    if not ctx["jobs"] or not ctx["span_s"].get("emit"):
        return None
    return 1e3 * ctx["span_s"]["emit"] / ctx["jobs"]
