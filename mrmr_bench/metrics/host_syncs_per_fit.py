"""Blocking device-to-host reads a fit makes, counted by the program at
each site (``tracing.host_read``: the selector's validation, each pick's
argmax, the result's copies), averaged over the traced window's fits."""

from mrmr_bench import records

UNIT = "reads"


def read(run):
    recs = records.of(run)
    if not recs:
        return None
    return sum(n for r in recs for n, _ in r.reads.values()) / len(recs)
