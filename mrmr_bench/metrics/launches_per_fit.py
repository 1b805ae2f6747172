"""Launches of the program's kernel wrappers (their ``launches``
counters) over the window, divided by the fits."""

UNIT = "launches"


def read(run):
    return sum(run.launches.values()) / run.fits if run.fits else None
