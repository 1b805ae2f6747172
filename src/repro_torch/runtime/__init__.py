"""Host-side runtime: checkpoints, retries, watchdog, the crash-restart
loop and the elastic restore."""

from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: F401
from repro_torch.runtime.resilience import StepWatchdog, run_with_restarts  # noqa: F401
