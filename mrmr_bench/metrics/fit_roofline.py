"""The fit's least time over its measured mean time.  The least time is
the bytes a fit must move at the HBM rate: each pass reads X once as
handed to ``fit`` and its int32 target, and writes its int32 tables.  It
counts the same work whatever implements the fit."""

from mrmr_bench import peaks
from mrmr_bench.work import fit_bytes

UNIT = "%"


def read(run):
    if not run.fits:
        return None
    least = fit_bytes(run.cell.config, run.cell.traffic) / peaks.HBM_BYTES_PER_S
    return 100.0 * least / (run.window_s / run.fits)
