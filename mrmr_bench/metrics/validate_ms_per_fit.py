"""Host milliseconds a fit spends in the selector's validation (the span
``mrmr.validate``): it ends in blocking reads of X's and y's least and
greatest values, so it holds the two reductions over X.  Averaged over the
traced window's fits."""

from mrmr_bench import records

UNIT = "ms"
SPAN = "mrmr.validate"


def read(run):
    recs = records.of(run)
    if not recs or any(SPAN not in r.spans for r in recs):
        return None
    return 1e3 * sum(r.spans[SPAN][1] for r in recs) / len(recs)
