"""The port's serving runtime: requests, typed errors and the scheduler."""
from repro_torch.runtime.errors import (  # noqa: F401
    ConfigError,
    DeadlineUnmeetable,
    DrainStalled,
    LedgerError,
    PoisonedRequest,
    SchedulerError,
)
from repro_torch.runtime.request import Request, StreamCallback, pad_and_stack  # noqa: F401
from repro_torch.runtime.scheduler import (  # noqa: F401
    PageAllocator,
    SchedulerStats,
    StreamScheduler,
)
