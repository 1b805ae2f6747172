"""Faults planted in the program under the timed path, each of the kinds a
cell can have, to show that the comparison catches them.  The benchmark's
runs never plant one; its tests do on the CPU, and ``readings.py`` does at
a cell's own size on the card.

* ``state_unchanged``: the criterion's fold returns its state unchanged;
* ``half_the_rows``: every count covers the first half of the
  observations;
* ``answer_altered``: the middle pick is replaced by the lowest-id column
  not picked, where the selector produces its answer;
* ``last_pick_altered``: the same at the last pick.

One chip has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
import dataclasses

FAULTS = ("state_unchanged", "half_the_rows", "answer_altered", "last_pick_altered")
_MISSING = object()


def _altered(finish, at):
    def finish_altered(self, res, plan, n):
        sel = res.selected.clone()
        l = at(len(sel))
        sel[l] = next(k for k in range(n) if k not in set(sel.tolist()))
        return finish(self, dataclasses.replace(res, selected=sel), plan, n)
    return finish_altered


def _patches(fault: str) -> list:
    """``[(owner, attribute, replacement), ...]`` that plant ``fault``."""
    import repro_torch.core.criteria as criteria
    import repro_torch.core.scores as scores
    from repro_torch.core.selector import MRMRSelector

    if fault == "state_unchanged":
        kinds = [c for c in vars(criteria).values() if isinstance(c, type)
                 and issubclass(c, criteria.Criterion) and "update" in vars(c)]
        return [(c, "update", lambda self, state, terms, l: state) for c in kinds]
    if fault == "half_the_rows":
        tables, cond = scores.MIScore.tables, scores.MIScore.conditional_tables

        def half(t):
            return t[: t.shape[0] // 2]
        return [(scores.MIScore, "tables",
                 lambda self, X, t, vy: tables(self, half(X), half(t), vy)),
                (scores.MIScore, "conditional_tables",
                 lambda self, X, xj, cls: cond(self, half(X), half(xj), half(cls)))]
    finish = MRMRSelector._finish_fit
    if fault == "answer_altered":
        return [(MRMRSelector, "_finish_fit", _altered(finish, lambda n: n // 2))]
    if fault == "last_pick_altered":
        return [(MRMRSelector, "_finish_fit", _altered(finish, lambda n: n - 1))]
    raise ValueError(f"no fault {fault!r}; have {FAULTS}")


@contextlib.contextmanager
def planted(fault: str):
    """Run the body with ``fault`` planted in the program."""
    patches = _patches(fault)
    saved = [(owner, name, vars(owner).get(name, _MISSING)) for owner, name, _ in patches]
    try:
        for owner, name, new in patches:
            setattr(owner, name, new)
        yield
    finally:
        for owner, name, old in reversed(saved):
            if old is _MISSING:
                delattr(owner, name)
            else:
                setattr(owner, name, old)
