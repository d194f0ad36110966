"""Federated data substrate: numpy-only copies of ``repro.data``'s
synthetic generator, partitioners and container (held byte-equal to the
originals by tests/test_torch_substrate.py)."""
from repro_torch.data.synthetic import make_class_conditional_images  # noqa: F401
from repro_torch.data.partition import dirichlet_partition, pathological_partition  # noqa: F401
from repro_torch.data.federated import FederatedData  # noqa: F401
