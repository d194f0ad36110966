"""PyTorch/CUDA port of ``repro`` (pFedSOP federated training).

Mirrors ``repro``'s subpackages module for module.  ``repro`` (JAX) stays
the reference: the tests under ``tests/test_torch_*.py`` hold every ported
module against it on the CPU.  Nothing here imports ``jax`` or ``repro``.
"""

# torch.func's first gradient imports torch._dynamo lazily, and that import
# leaves a reference cycle through its caller's frames: the first model a
# process trains (a whole ``Federation``, its device store included) would
# then live until the cyclic collector happens to run.  Importing it here
# keeps every import frame out of the training call stack.
import torch._dynamo  # noqa: E402,F401
