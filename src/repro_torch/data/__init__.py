"""Host-side data: the ``DataSource`` protocol, binning, synthetic
generators and the sharded token pipeline."""

from repro_torch.data.binning import (  # noqa: F401
    BinnedSource,
    QuantileBinner,
    QuantileSketch,
    fit_binned,
)
from repro_torch.data.synthetic import corral_dataset, lm_token_batches  # noqa: F401
from repro_torch.data.pipeline import ShardedDataPipeline  # noqa: F401
from repro_torch.data.sources import (  # noqa: F401
    ArraySource,
    CSVSource,
    CorralSource,
    DataSource,
    NpySource,
    SourceStats,
    SyntheticTokenSource,
    as_source,
)
