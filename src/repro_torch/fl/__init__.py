"""Federation runtime: sync driver, ``VmapBackend``, device cohort store."""
from repro_torch.fl.runtime import Federation, FLRunConfig, masked_accuracy  # noqa: F401
