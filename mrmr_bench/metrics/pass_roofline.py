"""The counting passes' least time over their device time, for the fits of
the traced window.  The least time is ``work.fit_bytes`` at the HBM rate,
the yardstick ``fit_roofline`` uses, whatever implements a pass; the
device time is each pass's span (``mrmr.pass.*``) between the CUDA events
the program records on its stream: the picked column, the fused target,
the count, MI, and the device's waits for the host between them."""

from mrmr_bench import peaks, records
from mrmr_bench.work import fit_bytes

UNIT = "%"


def read(run):
    timed = [r for r in records.of(run) or () if r.pass_s]
    spent = sum(s for r in timed for s in r.pass_s)
    if spent <= 0:
        return None
    least = len(timed) * fit_bytes(run.cell.config, run.cell.traffic) / peaks.HBM_BYTES_PER_S
    return 100.0 * least / spent
