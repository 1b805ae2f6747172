"""The 95th percentile of every fit's time in the window, each timed on
the host clock from the call to ``torch.cuda.synchronize()``."""

import numpy as np

UNIT = "ms"


def read(run):
    return float(np.percentile(run.fit_s, 95)) * 1e3 if run.fit_s else None
