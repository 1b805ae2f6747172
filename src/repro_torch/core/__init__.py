"""Selection core: contingency math, scores, criteria and the engines.

The JAX package's jit builders (``build_engine_fn``, ``make_*_fn``) have no
counterpart: the port's engines run eagerly."""

from repro_torch.core.criteria import (  # noqa: F401
    CIFECriterion,
    CMIMCriterion,
    Criterion,
    ICAPCriterion,
    JMICriterion,
    MIDCriterion,
    MIFSCriterion,
    MIQCriterion,
    MaxRelCriterion,
    available_criteria,
    conditional_terms,
    marginal_terms,
    register_criterion,
    resolve_criterion,
)
from repro_torch.core.mrmr import (  # noqa: F401
    MRMRResult,
    mrmr_alternative,
    mrmr_conventional,
    mrmr_grid,
    mrmr_reference,
)
from repro_torch.core.scores import (  # noqa: F401
    CustomScore,
    MIScore,
    PearsonMIScore,
    ScoreFn,
    cmi_from_counts,
    cor2mi,
    entropy_from_counts,
    mi_from_counts,
    mrmr_custom_score,
    pearson_rows,
)
from repro_torch.core.selector import (  # noqa: F401
    MRMRSelector,
    SelectionPlan,
    available_encodings,
    check_num_select,
    get_engine,
    plan_selection,
    register_engine,
)
from repro_torch.core.selection import FeatureSelector, infer_layout, mrmr_select  # noqa: F401

# Imported last: registers the "streaming" engine against the registry in
# repro_torch.core.selector (the out-of-core DataSource fit path).
from repro_torch.core.streaming import mrmr_streaming  # noqa: F401
