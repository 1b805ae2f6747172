"""Seconds from the process's start to the window's: imports, the CUDA
context, building or loading the kernels, making the data on the card and
the warm-up fits."""

UNIT = "s"


def read(run):
    return run.setup_s
