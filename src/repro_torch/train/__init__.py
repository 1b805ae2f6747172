"""Training: AdamW, the train step and gradient compression (port of
``repro.train``)."""

from repro_torch.train.compression import (  # noqa: F401
    GradCompression,
    compressed_psum,
    compressed_psum_positions,
)
from repro_torch.train.optimizer import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
    global_norm,
    shard_adamw_update,
    shard_global_norm,
    warmup_cosine,
)
from repro_torch.train.train_step import (  # noqa: F401
    TrainState,
    gather_train_state,
    init_train_state,
    make_train_state_specs,
    make_train_step,
    mesh_value_and_grad,
    shard_train_state,
    train_state_shapes,
)
