"""scikit-learn face of the mRMR engines — ``MRMRTransformer``.

A :class:`~sklearn.feature_selection.SelectorMixin` estimator wrapping
:class:`repro_torch.MRMRSelector`, so the paper's selection drops into the
standard composition machinery unchanged::

    from sklearn.pipeline import make_pipeline
    from sklearn.linear_model import LogisticRegression
    from repro_torch.interop.sklearn import MRMRTransformer

    pipe = make_pipeline(
        MRMRTransformer(num_select=10, criterion="jmi", bins=32),
        LogisticRegression(),
    )
    pipe.fit(X_train, y_train)                  # select-then-train
    GridSearchCV(pipe, {"mrmrtransformer__num_select": [5, 10, 20]})

Constructor params are stored verbatim (the sklearn ``clone`` contract:
``get_params`` must round-trip unmodified), and every selection knob —
``criterion`` (``mid``/``miq``/``maxrel``/``jmi``/``cmim`` or a
``Criterion`` instance), ``bins`` for on-the-fly quantile
discretisation of continuous data, ``encoding``/``devices`` for the
plan, ``device`` for where it runs (``"cuda"`` unless told otherwise) —
passes straight through to the selector at ``fit`` time.  ``transform`` keeps sklearn's convention (selected columns in
ascending index order, via the mixin's support mask); the greedy pick
order lives in ``selected_`` and the objective trajectory in ``gains_``.

scikit-learn is a soft dependency: importing this module without it
raises an actionable ``ImportError`` rather than leaving ``repro_torch``
depending on sklearn.
"""

from __future__ import annotations

import numpy as np

try:
    from sklearn.base import BaseEstimator
    from sklearn.feature_selection import SelectorMixin
    from sklearn.utils.validation import check_is_fitted, check_X_y
except ImportError:  # pragma: no cover - exercised only without sklearn
    raise ImportError(
        "repro_torch.interop.sklearn requires scikit-learn; install it "
        "(pip install scikit-learn) or use repro_torch.MRMRSelector directly"
    ) from None

from repro_torch.core.selector import MRMRSelector


class MRMRTransformer(SelectorMixin, BaseEstimator):
    """mRMR feature selection as a scikit-learn transformer.

    Args:
      num_select: number of features to select (L).
      criterion: greedy objective — a registered name (``"mid"``,
        ``"miq"``, ``"maxrel"``, ``"jmi"``, ``"cmim"``) or a
        :class:`~repro_torch.core.criteria.Criterion` instance.
      score: an explicit :class:`~repro_torch.core.scores.ScoreFn`; None
        resolves from the data (discrete -> exact MI, continuous ->
        Pearson-MI, or binned MI when ``bins`` is set).
      bins: quantile-discretise continuous features into this many
        equal-frequency bins and select with exact discrete MI (the
        route to ``jmi``/``cmim`` on float data); None = off.
      encoding: the plan (``"auto"`` applies the paper's §III rule) — see
        :class:`~repro_torch.core.selector.MRMRSelector`.
      devices: device budget for auto-planning (one device).
      block_obs: observations per streamed block (DataSource fits).
      device: where the fit runs (``"cuda"`` raises without a card).

    Fitted attributes follow sklearn conventions: ``n_features_in_``,
    ``selected_`` (pick order), ``gains_``, ``scores_`` (per-feature
    relevance), ``ranking_``; ``get_support()``/``transform`` come from
    ``SelectorMixin``.  The fitted :class:`~repro_torch.core.selector.
    MRMRSelector` is exposed as ``selector_`` for the full report
    (``selector_.result_``, ``selector_.plan_``).
    """

    def __init__(
        self,
        num_select: int = 10,
        *,
        criterion="mid",
        score=None,
        bins=None,
        encoding: str = "auto",
        devices=None,
        block_obs: int = 65536,
        device: str = "cuda",
    ):
        self.num_select = num_select
        self.criterion = criterion
        self.score = score
        self.bins = bins
        self.encoding = encoding
        self.devices = devices
        self.block_obs = block_obs
        self.device = device

    def fit(self, X, y=None):
        """Run the greedy selection; ``y`` is required (supervised)."""
        if y is None:
            raise ValueError(
                "MRMRTransformer is a supervised selector: fit(X, y)"
            )
        # dtype=None keeps integer matrices integral — the discrete-MI
        # route; sklearn's default float coercion would silently send
        # categorical data down the Pearson path.
        X, y = check_X_y(X, y, dtype=None)
        self.n_features_in_ = X.shape[1]
        self.selector_ = MRMRSelector(
            num_select=self.num_select,
            score=self.score,
            criterion=self.criterion,
            encoding=self.encoding,
            devices=self.devices,
            block_obs=self.block_obs,
            bins=self.bins,
            device=self.device,
        ).fit(X, y)
        self.selected_ = np.asarray(self.selector_.selected_)
        self.gains_ = np.asarray(self.selector_.gains_)
        self.scores_ = (
            None
            if self.selector_.scores_ is None
            else np.asarray(self.selector_.scores_)
        )
        self.ranking_ = np.asarray(self.selector_.ranking_)
        return self

    def _get_support_mask(self) -> np.ndarray:
        check_is_fitted(self, "selector_")
        return self.selector_.get_support()

    def _more_tags(self):  # sklearn < 1.6 tag API
        return {"allow_nan": False, "requires_y": True}

    def __sklearn_tags__(self):  # sklearn >= 1.6 tag API
        tags = super().__sklearn_tags__()
        tags.target_tags.required = True
        return tags


__all__ = ["MRMRTransformer"]
