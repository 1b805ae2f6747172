"""The contingency kernel's least time over its device time, for the fits
of the traced window.  A launch must read X once (its element size as
handed to ``fit``) and the int32 target, and write the int32 tables; a fit
makes one a pass.  Device time: the trace's kernels named
``contingency_*``."""

import re

from mrmr_bench import peaks
from mrmr_bench.work import fit_bytes

UNIT = "%"
KERNEL = re.compile(r"\bcontingency_(swar|shared|global)")


def read(run):
    t = run.trace
    spent = t.kernel_s(KERNEL.search) if t is not None else 0.0
    if spent <= 0:
        return None
    least = t.fits * fit_bytes(run.cell.config, run.cell.traffic) / peaks.HBM_BYTES_PER_S
    return 100.0 * least / spent
