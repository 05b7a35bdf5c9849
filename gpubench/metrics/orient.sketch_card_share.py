"""Orientation: the share of the stranded MinHash sets the card built,
the program's `sketches_card` counter over its `sketches` counter; None
where the program keeps no `sketches_card` counter or built no set."""

from gpubench import spanlog


def read(ctx):
    snap = spanlog.totals()
    if not ctx["jobs"] or snap is None or "sketches_card" not in snap or not snap.get("sketches"):
        return None
    return snap["sketches_card"] / snap["sketches"]
