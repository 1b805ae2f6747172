"""Host milliseconds a pick spends outside blocking reads: the host seconds
of the passes (``mrmr.pass.*``), the picks (``mrmr.pick``) and the folds
(``mrmr.fold``), less the seconds blocked in each pick's argmax read, over
the picks of the traced window's fits."""

from mrmr_bench import records

UNIT = "ms"
PICK = "mrmr.pick"


def _spent(r) -> float:
    return sum(s for name, (_, s) in r.spans.items()
               if name.startswith("mrmr.pass.") or name in (PICK, "mrmr.fold"))


def read(run):
    recs = records.of(run)
    picks = sum(r.spans.get(PICK, (0, 0.0))[0] for r in recs or ())
    if not picks:
        return None
    blocked = sum(r.reads.get("pick", (0, 0.0))[1] for r in recs)
    return 1e3 * (sum(_spent(r) for r in recs) - blocked) / picks
