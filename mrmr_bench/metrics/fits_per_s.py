"""Completed fits over the whole window (host clock)."""

UNIT = "fits/s"


def read(run):
    return run.fits / run.window_s if run.fits else None
