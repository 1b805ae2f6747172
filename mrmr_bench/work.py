"""The work one fit asks for, from the cell's shapes alone: whatever
implements the fit, it makes ``num_select`` counting passes over X, the
first against the class and each later one against the last pick (fused
with the class for a conditional criterion)."""

from __future__ import annotations

import dataclasses

from mrmr_bench.data import X_DTYPE
from mrmr_bench.reference import CONDITIONAL

X_BYTES = X_DTYPE.itemsize  # bytes of one element of X as handed to fit


@dataclasses.dataclass(frozen=True)
class Pass:
    rows: int  # M, observations
    cols: int  # F, features counted
    values: int  # V
    width: int  # values of the pass's target
    classes: int  # C
    conditional: bool  # tables carry the class (a conditional criterion)


def passes(config: dict, traffic: dict) -> list:
    """The counting passes of one fit."""
    m, f, v, c = config["rows"], config["cols"], config["num_values"], config["num_classes"]
    cond = traffic["criterion"] in CONDITIONAL
    first = Pass(m, f, v, c, c, False)
    later = Pass(m, f, v, v * c if cond else v, c, cond)
    return [first] + [later] * (int(traffic["num_select"]) - 1)


def fit_bytes(config: dict, traffic: dict) -> int:
    """The bytes one fit's counting passes must move: each reads X once and
    its int32 target, and writes its int32 tables."""
    return sum(p.rows * p.cols * X_BYTES + p.rows * 4 + p.cols * p.values * p.width * 4
               for p in passes(config, traffic))
