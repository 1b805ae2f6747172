from repro_torch.serve.engine import Request, ServeEngine  # noqa: F401
from repro_torch.serve.selection import (  # noqa: F401
    Backpressure,
    JobCancelled,
    JobFailed,
    JobInfo,
    ResultCache,
    SelectionRequest,
    SelectionService,
    UnknownJob,
    parse_source_ref,
)
