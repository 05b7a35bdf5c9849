"""Device: the share of the traced window in which no operation ran on
the card (1 - busy / wall, the union of every device interval)."""


def read(ctx):
    if not ctx["window_s"] or not ctx["busy_s"]:
        return None
    return 1.0 - ctx["busy_s"] / ctx["window_s"]
