"""Orientation: the `AllPairAligner._orient_all` span a job (the mash
sketches of every sequence and both strands, the strand decisions and
the distance hints), in ms; it runs inside the pipeline span."""


def read(ctx):
    if not ctx["jobs"] or not ctx["span_s"].get("orient"):
        return None
    return 1e3 * ctx["span_s"]["orient"] / ctx["jobs"]
