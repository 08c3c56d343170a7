"""The port's serving runtime: requests, typed errors, the continuous-batching
scheduler, its sharded form and the lock-step batch server."""
from repro_torch.runtime.errors import (  # noqa: F401
    ConfigError,
    DeadlineUnmeetable,
    DrainStalled,
    LedgerError,
    PoisonedRequest,
    SchedulerError,
)
from repro_torch.runtime.request import Request, StreamCallback, pad_and_stack  # noqa: F401
from repro_torch.runtime.multihost import (  # noqa: F401
    ShardedPageAllocator,
    ShardedStreamScheduler,
)
from repro_torch.runtime.scheduler import (  # noqa: F401
    PageAllocator,
    SchedulerStats,
    StreamScheduler,
)
from repro_torch.runtime.server import BatchServer, ServerStats  # noqa: F401
