"""Engines: the DP cells the engines counted (the program's
`utils.telemetry.counters.cells`, from launch shapes) over the least
work the window's pairs need (`leastwork.py`): band padding and
escalations are the excess."""


def read(ctx):
    if not ctx["cells_counted"] or not ctx["least_cells"]:
        return None
    return ctx["cells_counted"] / ctx["least_cells"]
