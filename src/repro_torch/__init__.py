"""PyTorch/CUDA port of ``repro`` (pFedSOP federated training).

Mirrors ``repro``'s subpackages module for module.  ``repro`` (JAX) stays
the reference: the tests under ``tests/test_torch_*.py`` hold every ported
module against it on the CPU.  Nothing here imports ``jax`` or ``repro``.
"""
