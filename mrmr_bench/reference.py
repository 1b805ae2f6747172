"""The plain reference the fits are judged by: greedy mRMR from exact
counts, in float64, in plain PyTorch.

It shares nothing with the program under test: the counts are float32
matrix products of value indicators with the targets' one-hots (a judged
fit's class and picks together, in one read of X), over blocks of rows
(exact: every block's sums stay below 2**24, and TF32 is off), summed in
float64; mutual information and the criteria follow their textbook
definitions.  The program's picks and gains are judged by following them:
at each pick the reference scores every candidate given the program's
earlier picks, and reads

* ``pick_gap``: how far the program's pick lies below the best candidate;
* ``gain_err``: how far the program's gain lies from the reference's value
  of that pick;
* ``relevance_err``: the widest gap between the program's relevance
  vector (every feature's MI with the class) and the reference's,

each the worst over the picks, in nats.  :func:`control_fit` is the same
greedy computed in a lower precision (bfloat16): the control that the
limits must fail.
"""

from __future__ import annotations

import math

import torch

# Criteria that fold class-conditioned pair terms (the others fold the
# marginal pair MI alone).
CONDITIONAL = frozenset({"jmi", "cmim", "cife", "icap"})
_MIQ_EPS = 1e-4
_BLOCK_BYTES = 2 << 30  # float32 indicator block


class Tables:
    """Exact contingency tables of every column of ``X`` (M, F) against a
    target, by blocks of rows.  ``X`` must hold values in ``[0, V)``: the
    value-0 table is the target's histogram minus the others."""

    def __init__(self, X: torch.Tensor, num_values: int):
        self.X, self.V = X, int(num_values)
        lo, hi = int(X.min()), int(X.max())
        if lo < 0 or hi >= self.V:
            raise ValueError(f"X holds values in [{lo}, {hi}], outside [0, {self.V})")
        m, f = X.shape
        self.block = max(1, min(m, 2**24 - 1, _BLOCK_BYTES // (4 * max(f, 1))))

    def __call__(self, targets: list) -> list:
        """``[(t, width), ...]``, each an (M,) target in ``[0, width)`` ->
        an (F, V, width) float64 table each, from one read of X."""
        X, V = self.X, self.V
        m, f = X.shape
        widths = [int(w) for _, w in targets]
        out = torch.zeros((f, V, sum(widths)), dtype=torch.float64, device=X.device)
        codes = [torch.arange(w, device=X.device) for w in widths]
        hist = torch.zeros((sum(widths),), dtype=torch.float64, device=X.device)
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for lo in range(0, m, self.block):
                onehot = torch.cat([(t[lo:lo + self.block, None] == c).to(torch.float32)
                                    for (t, _), c in zip(targets, codes)], dim=1)
                hist += onehot.sum(0, dtype=torch.float64)
                xb = X[lo:lo + self.block]
                for v in range(1, V):
                    ind = (xb == v).to(torch.float32)
                    out[:, v] += (ind.T @ onehot).to(torch.float64)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        out[:, 0] = hist - out[:, 1:].sum(1)
        return list(out.split(widths, dim=2))


def mi(counts: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """(..., A, B) counts -> (...) mutual information in nats, in ``dtype``."""
    n = counts.to(dtype)
    total = n.sum(dim=(-2, -1), keepdim=True).clamp_min(1)
    p = n / total
    pa = p.sum(-1, keepdim=True)
    pb = p.sum(-2, keepdim=True)
    ratio = p / (pa * pb).clamp_min(torch.finfo(dtype).tiny)
    terms = torch.where(p > 0, p * torch.log(ratio.clamp_min(torch.finfo(dtype).tiny)),
                        torch.zeros_like(p))
    return terms.sum(dim=(-2, -1))


def cmi(counts: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """(..., A, B, C) counts -> (...) ``I(a; b | c)`` in nats: each class
    slice's MI weighted by its share of the observations."""
    per_class = mi(counts.movedim(-1, -3), dtype)  # (..., C)
    mass = counts.sum(dim=(-3, -2)).to(dtype)
    share = mass / mass.sum(-1, keepdim=True).clamp_min(1)
    return (per_class * share).sum(-1)


def objective(name: str, rel, state: dict, l: int):
    """The criterion's objective after ``l`` folded picks."""
    d = float(max(l, 1))
    if name == "mid":
        return rel - state["red"] / d
    if name == "miq":
        return rel / (state["red"] / d).clamp_min(_MIQ_EPS)
    if name == "maxrel":
        return rel
    if name == "mifs":
        return rel - state["red"]
    if name == "jmi":
        return rel + state["gap"] / d
    if name == "cife":
        return rel + state["gap"]
    if name == "cmim":
        return rel if l == 0 else rel + state["worst"]
    if name == "icap":
        return rel - state["cap"]
    raise ValueError(f"no reference for criterion {name!r}")


def fold(state: dict, marginal, conditional) -> dict:
    """``state`` with one more pick's pair terms folded in."""
    out = dict(state)
    out["red"] = state["red"] + marginal
    if conditional is not None:
        gap = conditional - marginal
        out["gap"] = state["gap"] + gap
        out["worst"] = torch.minimum(state["worst"], gap)
        out["cap"] = state["cap"] + (marginal - conditional).clamp_min(0)
    return out


class Greedy:
    """The greedy loop over one dataset and one target, in ``dtype``."""

    def __init__(self, tables: Tables, y: torch.Tensor, job: dict, dtype=torch.float64):
        self.tables, self.y, self.dtype = tables, y.to(torch.int64), dtype
        self.V, self.C = tables.V, int(job["num_classes"])
        self.L, self.criterion = int(job["num_select"]), job["criterion"]
        self.conditional = self.criterion in CONDITIONAL

    def target(self, k: int):
        """Feature ``k``'s pair target (fused with the class for a
        conditional criterion) and its width."""
        xk = self.tables.X[:, k].to(torch.int64)
        if self.conditional:
            return xk * self.C + self.y, self.V * self.C
        return xk, self.V

    def terms(self, counts: torch.Tensor):
        """Every candidate's (marginal, conditional or None) pair terms from
        its table against a pick's target."""
        if not self.conditional:
            return mi(counts, self.dtype), None
        cnt = counts.reshape(counts.shape[0], self.V, self.V, self.C)
        return mi(cnt.sum(-1), self.dtype), cmi(cnt, self.dtype)

    def run(self, picks=None):
        """Yield ``(l, objective, pick)`` for every pick: the program's
        ``picks[l]`` where given (every table then counted in one read of X),
        else the lowest-id best candidate (a read a pick)."""
        n = self.tables.X.shape[1]
        folds = 0 if self.criterion == "maxrel" else self.L - 1
        if picks is None:
            rel, ahead = mi(self.tables([(self.y, self.C)])[0], self.dtype), None
        else:
            folded = [int(k) for k in picks[:folds] if 0 <= int(k) < n]
            counts = self.tables([(self.y, self.C)] + [self.target(k) for k in folded])
            rel, ahead = mi(counts[0], self.dtype), iter(counts[1:])
        zeros = torch.zeros((n,), dtype=self.dtype, device=rel.device)
        state = dict(red=zeros, gap=zeros, cap=zeros, worst=torch.full_like(zeros, math.inf))
        taken = torch.zeros((n,), dtype=torch.bool, device=rel.device)
        self.rel = rel
        for l in range(self.L):
            g = torch.where(taken, -math.inf, objective(self.criterion, rel, state, l))
            k = int(torch.argmax(g)) if picks is None else int(picks[l])
            yield l, g, k
            if not 0 <= k < n:
                continue  # read as inf by the judge; nothing to fold
            taken[k] = True
            if l < folds:
                counts = next(ahead) if ahead is not None else self.tables([self.target(k)])[0]
                state = fold(state, *self.terms(counts))


def judge(tables: Tables, y, job: dict, selected, gains, relevance) -> dict:
    """The numbers compared for one fit: ``relevance_err``, ``gain_err``
    and ``pick_gap`` (nats, worst over the picks; inf where a pick is out
    of range, repeated or missing)."""
    sel = [int(s) for s in selected]
    gains = [float(g) for g in gains]
    greedy = Greedy(tables, y, job)
    if len(sel) != greedy.L or len(gains) != greedy.L:
        return dict(relevance_err=math.inf, gain_err=math.inf, pick_gap=math.inf)
    gap = err = 0.0
    for l, g, k in greedy.run(sel):
        n = g.shape[0]
        val = float(g[k]) if 0 <= k < n else -math.inf
        gap = max(gap, float(g.max()) - val)
        err = max(err, abs(gains[l] - val))
    rel = torch.as_tensor(relevance, dtype=torch.float64).to(greedy.rel.device)
    if rel.shape != greedy.rel.shape:
        rel_err = math.inf
    else:
        rel_err = float((rel - greedy.rel).abs().max())
    clean = lambda v: v if math.isfinite(v) else math.inf  # noqa: E731 (nan -> inf)
    return dict(relevance_err=clean(rel_err), gain_err=clean(err), pick_gap=clean(gap))


def control_fit(tables: Tables, y, job: dict, dtype=torch.bfloat16):
    """The reference in the program's place, computed in ``dtype``:
    ``(selected, gains, relevance)`` as a fit returns them."""
    greedy = Greedy(tables, y, job, dtype)
    sel, gains = [], []
    for _, g, k in greedy.run():
        sel.append(k)
        gains.append(float(g[k]))
    return sel, gains, greedy.rel.to(torch.float32).cpu()
