"""The program's own records of the traced window's fits
(``repro_torch.runtime.tracing``), for the metrics that read them.  A fit
is recorded only while a profiler collects, so the newest ``fits`` records
are the traced window's.  They are read only where the trace saw the
device work, as ``device_idle`` is: a run off the card reads nothing."""


def of(run):
    """The records of ``run``'s traced fits, or None where there is no
    trace, no fit or no device work in it, or a program that keeps no
    records of them."""
    t = run.trace
    if t is None or not t.fits or t.busy_s <= 0:
        return None
    try:
        from repro_torch.runtime import tracing
    except ImportError:  # a program without spans or records
        return None
    recs = tracing.records(t.fits)
    return recs if len(recs) == t.fits else None
