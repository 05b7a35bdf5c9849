"""Pairs and sketches: the `AllPairAligner.__init__` span a job (pair
selection, the orientation index), in ms."""


def read(ctx):
    if not ctx["jobs"]:
        return None
    return 1e3 * ctx["span_s"]["pairs"] / ctx["jobs"]
