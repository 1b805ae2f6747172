"""Legacy selection API — thin wrappers over :mod:`repro_torch.core.selector`.

``FeatureSelector`` / ``mrmr_select`` predate the ``MRMRSelector`` front
door in the JAX package and are kept as its compatibility surface: the same
fields, the same ``layout=`` vocabulary, the same results.  New code should
use ``repro_torch.MRMRSelector`` directly.  As everywhere in the port, a
fit runs on ``device="cuda"`` unless told otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.mrmr import MRMRResult
from repro_torch.core.scores import MIScore, PearsonMIScore, ScoreFn
from repro_torch.core.selector import MRMRSelector


def infer_layout(n_obs: int, n_feat: int) -> str:
    """Paper §III: tall/narrow -> conventional, short/wide -> alternative."""
    return "conventional" if n_obs >= n_feat else "alternative"


@dataclasses.dataclass
class FeatureSelector:
    """mRMR feature selection with the paper's two encodings.

    Compatibility alias of :class:`repro_torch.core.selector.MRMRSelector`:
    ``layout`` maps onto ``encoding`` ("auto" resolves with the original
    shape rule).  ``layout="grid"`` and a ``mesh`` need the mesh engines,
    not yet ported: they raise ``NotImplementedError``.
    """

    num_select: int
    score: ScoreFn | None = None
    layout: str = "auto"
    mesh: object = None
    obs_axes: Sequence[str] | str = ("data",)
    feat_axes: Sequence[str] | str = ("model",)
    incremental: bool = True
    block: int = 64
    device: str = "cuda"

    selected_: np.ndarray | None = None
    gains_: np.ndarray | None = None

    def _encoding_for(self, X: torch.Tensor) -> str:
        if self.layout == "grid":
            raise NotImplementedError(
                "layout='grid' needs the mesh engines, not yet ported to repro_torch"
            )
        if self.layout != "auto":
            return self.layout
        m, n = X.shape
        discrete = not (X.dtype.is_floating_point or X.dtype.is_complex)
        return infer_layout(m, n) if discrete else "alternative"

    def fit(self, X, y) -> "FeatureSelector":
        """X: (observations, features) — conventional orientation; y: (obs,)."""
        X = torch.as_tensor(X)
        sel = MRMRSelector(
            num_select=self.num_select, score=self.score,
            encoding=self._encoding_for(X), mesh=self.mesh,
            obs_axes=self.obs_axes, feat_axes=self.feat_axes,
            incremental=self.incremental, block=self.block, device=self.device,
        ).fit(X, y)
        self.selected_ = sel.selected_
        self.gains_ = sel.gains_
        return self

    def transform(self, X):
        if self.selected_ is None:
            raise RuntimeError("fit() first")
        return np.asarray(X)[:, self.selected_]

    def fit_transform(self, X, y):
        return self.fit(X, y).transform(X)


def mrmr_select(
    X,
    y,
    num_select: int,
    *,
    score: ScoreFn | None = None,
    layout: str = "auto",
    mesh=None,
    obs_axes=("data",),
    feat_axes=("model",),
    incremental: bool = True,
    device: str = "cuda",
) -> MRMRResult:
    """One-call mRMR. See :class:`FeatureSelector`."""
    sel = FeatureSelector(
        num_select=num_select, score=score, layout=layout, mesh=mesh,
        obs_axes=obs_axes, feat_axes=feat_axes, incremental=incremental,
        device=device,
    )
    sel.fit(X, y)
    return MRMRResult(
        selected=torch.from_numpy(sel.selected_), gains=torch.from_numpy(sel.gains_)
    )


__all__ = [
    "FeatureSelector",
    "mrmr_select",
    "MIScore",
    "PearsonMIScore",
    "infer_layout",
]
