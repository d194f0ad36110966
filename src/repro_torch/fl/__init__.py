"""Federation runtime: the sync driver ``Federation`` and the buffered
asynchronous ``AsyncFederation`` over one availability/scheduler model,
the engines (``VmapBackend`` on one device; ``ShardMapBackend`` and
``MeshBackend`` over the ranks of a ``torch.distributed`` group) and the
cohort stores (device, host, mmap)."""
from repro_torch.fl.async_ import AsyncConfig, AsyncFederation  # noqa: F401
from repro_torch.fl.availability import (  # noqa: F401
    AvailabilityConfig,
    ClientAvailability,
    TraceAvailability,
    TraceAvailabilityConfig,
    make_availability,
)
from repro_torch.fl.cohort_store import (  # noqa: F401
    STORE_KINDS,
    DeviceStore,
    HostStore,
    StoreConfig,
    as_store_config,
    make_store,
)
from repro_torch.fl.engine import (  # noqa: F401
    BACKENDS,
    MeshBackend,
    ShardMapBackend,
    VmapBackend,
    make_engine,
    resolve_client_split,
    resolve_shards,
)
from repro_torch.fl.runtime import (  # noqa: F401
    Federation,
    FLRunConfig,
    RoundPrograms,
    masked_accuracy,
    override_update_impl,
    validate_method,
)
from repro_torch.fl.scheduler import RoundScheduler  # noqa: F401
