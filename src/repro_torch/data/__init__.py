"""Federated data substrate: numpy-only copies of ``repro.data``'s
synthetic generators, partitioners and container (held byte-equal to the
originals by tests/test_torch_substrate.py and tests/test_torch_lm.py)."""
from repro_torch.data.synthetic import make_class_conditional_images  # noqa: F401
from repro_torch.data.partition import dirichlet_partition, pathological_partition  # noqa: F401
from repro_torch.data.federated import FederatedData  # noqa: F401
from repro_torch.data.lm import synthetic_lm_stream, lm_batch_iterator  # noqa: F401
