"""``torch.cuda.max_memory_allocated()`` over the run, the dataset
included, read when the window closes: what a user must hold on the card."""

UNIT = "GiB"


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
