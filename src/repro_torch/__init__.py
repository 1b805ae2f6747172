"""repro_torch — the paper's MapReduce mRMR feature selection in PyTorch,
with hand-written CUDA kernels for one NVIDIA H100.

A port of the JAX package ``repro`` (which stays the reference): the same
module names, layouts, dtypes and results, run eagerly with torch tensors.
Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU, where the kernels' plain PyTorch versions run instead.

    >>> from repro_torch import MRMRSelector, CorralSource
    >>> X, y = CorralSource(100_000, 200).materialize()
    >>> MRMRSelector(num_select=10).fit(X, y).selected_

Continuous data takes the paper's Pearson score on the alternative
encoding, or quantile bins and exact MI:

    >>> MRMRSelector(num_select=10).fit(X_float, y)           # PearsonMIScore
    >>> MRMRSelector(num_select=10, bins=16).fit(X_float, y)  # binned MI

Out-of-core fits stream a ``DataSource`` (memmapped ``.npy``, CSV, Parquet,
Arrow, the CorrAL generator) block by block; ``spill_dir=`` spills the
parsed or encoded blocks once and replays them on later passes, and
``readahead=`` reads the next pass while the current one drains:

    >>> MRMRSelector(10, spill_dir="/tmp/spill", readahead=2).fit(CSVSource("d.csv"))

The paper's cluster regime is :mod:`repro_torch.dist.multihost`: under a
``torch.distributed`` (gloo) process group, ``hosts="auto"`` applies the
§III rule across processes, each reads only its rows and/or columns
(``iter_shard_blocks``), one collective a pass merges the exact integer
statistics, and every process commits the same picks, bitwise those of one
process; ``python -m repro_torch.launch.select_multihost`` spawns or joins
such a group:

    >>> from repro_torch.dist import init_multihost
    >>> init_multihost()                    # REPRO_* environment; idempotent
    >>> MRMRSelector(10, hosts="auto").fit(NpySource("X.npy", "y.npy"))

The paper's §III split also runs inside one process, over a device mesh
(:mod:`repro_torch.dist.meshes`): tall data shards observations, wide data
features, both-large a 2-D grid.  Positions may repeat a device, so four
shards can share one card:

    >>> from repro_torch.dist import make_mesh
    >>> mesh = make_mesh((2, 2), ("data", "model"), devices=["cuda:0"] * 4)
    >>> MRMRSelector(10, encoding="grid", mesh=mesh).fit(X, y)

The paper's custom-score interface (Listing 7) is ``CustomScore``;
``repro_torch.serve.selection.SelectionService`` runs fits as managed jobs
behind a result cache, and ``repro_torch.interop.sklearn.MRMRTransformer``
is the scikit-learn face.

Contingency counting, MI finalization, bin encoding and row correlation run
through ``repro_torch.kernels`` (``csrc/contingency.cu``, ``csrc/mi_score.cu``,
``csrc/bin_codes.cu``, ``csrc/pearson.cu``), built with ``nvcc`` for
``sm_90a`` at first use.

The dense decoder LMs of the registry are served by
:mod:`repro_torch.serve` over :mod:`repro_torch.models`, prefill attention
through ``csrc/flash_attention.cu``:

    >>> from repro_torch.configs import get_config
    >>> from repro_torch.models import build_model
    >>> from repro_torch.serve import Request, ServeEngine
    >>> ServeEngine(build_model(get_config("yi-6b"))).serve([Request([1, 2, 3])])
"""

from repro_torch.core.criteria import (
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
    register_criterion,
    resolve_criterion,
)
from repro_torch.core.mrmr import (
    MRMRResult,
    mrmr_alternative,
    mrmr_conventional,
    mrmr_grid,
    mrmr_reference,
)
from repro_torch.core.scores import (
    CustomScore,
    MIScore,
    PearsonMIScore,
    ScoreFn,
    cor2mi,
    mrmr_custom_score,
    pearson_rows,
)
from repro_torch.core.selection import FeatureSelector, mrmr_select
from repro_torch.core.selector import (
    MRMRSelector,
    SelectionPlan,
    available_encodings,
    plan_selection,
    register_engine,
)
from repro_torch.core.streaming import mrmr_streaming
from repro_torch.data.binning import (
    BinnedSource,
    QuantileBinner,
    QuantileSketch,
    fit_binned,
)
from repro_torch.data.sources import (
    ArraySource,
    CorralSource,
    DataSource,
    NpySource,
    as_source,
)

# The JAX package's version: the port follows its API.
__version__ = "1.6.0"

__all__ = [
    "ArraySource",
    "BinnedSource",
    "CIFECriterion",
    "CMIMCriterion",
    "CorralSource",
    "Criterion",
    "CustomScore",
    "DataSource",
    "FeatureSelector",
    "ICAPCriterion",
    "JMICriterion",
    "MIDCriterion",
    "MIFSCriterion",
    "MIQCriterion",
    "MIScore",
    "MRMRResult",
    "MRMRSelector",
    "MaxRelCriterion",
    "NpySource",
    "PearsonMIScore",
    "QuantileBinner",
    "QuantileSketch",
    "ScoreFn",
    "SelectionPlan",
    "as_source",
    "available_criteria",
    "available_encodings",
    "cor2mi",
    "fit_binned",
    "mrmr_alternative",
    "mrmr_conventional",
    "mrmr_custom_score",
    "mrmr_grid",
    "mrmr_reference",
    "mrmr_select",
    "mrmr_streaming",
    "pearson_rows",
    "plan_selection",
    "register_criterion",
    "register_engine",
    "resolve_criterion",
    "__version__",
]
