"""CLI and writer: the records a batch pass of the writer formats, the
program's `paf_batched` counter over its `paf_batches` counter; None
where the program keeps no such counters or ran no batch pass."""

from gpubench import spanlog


def read(ctx):
    snap = spanlog.totals()
    if not ctx["jobs"] or snap is None or not snap.get("paf_batches"):
        return None
    return snap["paf_batched"] / snap["paf_batches"]
