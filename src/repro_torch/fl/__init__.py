"""Federation runtime: the sync driver ``Federation`` and the buffered
asynchronous ``AsyncFederation`` over one availability/scheduler model,
``VmapBackend`` and the device cohort store."""
from repro_torch.fl.async_ import AsyncConfig, AsyncFederation  # noqa: F401
from repro_torch.fl.availability import (  # noqa: F401
    AvailabilityConfig,
    ClientAvailability,
    TraceAvailability,
    TraceAvailabilityConfig,
    make_availability,
)
from repro_torch.fl.cohort_store import DeviceStore, make_store  # noqa: F401
from repro_torch.fl.engine import BACKENDS, VmapBackend, make_engine  # noqa: F401
from repro_torch.fl.runtime import (  # noqa: F401
    Federation,
    FLRunConfig,
    RoundPrograms,
    masked_accuracy,
    override_update_impl,
    validate_method,
)
from repro_torch.fl.scheduler import RoundScheduler  # noqa: F401
