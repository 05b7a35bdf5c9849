"""Orientation: the program's `sketches` counter a job (the stranded
MinHash sets built: a sequence's forward set and its reverse
complement's count two); None where the program keeps no such counter."""

from gpubench import spanlog


def read(ctx):
    return spanlog.count_per_job(ctx, "sketches")
