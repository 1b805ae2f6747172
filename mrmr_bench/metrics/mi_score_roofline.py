"""The MI kernel's least time over its device time, for the fits of the
traced window.  A launch reads its int32 tables once and writes one
float32 a table.  A fit finalises the relevance tables (F x V x C), then
each pass's pair tables (F x V x V); a conditional criterion also the
per-class tables of the 3-way counts (F x C tables of V x V).  Device
time: the trace's kernels named ``mi_tables_*``."""

import re

from mrmr_bench import peaks
from mrmr_bench.work import passes

UNIT = "%"
KERNEL = re.compile(r"\bmi_tables_")


def fit_bytes(config, traffic) -> int:
    total = 0
    for i, p in enumerate(passes(config, traffic)):
        if i == 0:
            total += p.cols * p.values * p.classes * 4 + p.cols * 4
            continue
        total += p.cols * p.values * p.values * 4 + p.cols * 4
        if p.conditional:
            total += p.cols * p.values * p.values * p.classes * 4 + p.cols * p.classes * 4
    return total


def read(run):
    t = run.trace
    spent = t.kernel_s(KERNEL.search) if t is not None else 0.0
    if spent <= 0:
        return None
    least = t.fits * fit_bytes(run.cell.config, run.cell.traffic) / peaks.HBM_BYTES_PER_S
    return 100.0 * least / spent
