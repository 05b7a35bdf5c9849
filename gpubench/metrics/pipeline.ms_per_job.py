"""Pipeline: the `AllPairAligner.for_each_with_callback` span a job
(orientation decisions, engine calls and their waits, emit), in ms."""


def read(ctx):
    if not ctx["jobs"]:
        return None
    return 1e3 * ctx["span_s"]["pipeline"] / ctx["jobs"]
