"""Kernel-dispatch vocabulary (port of ``repro/kernels/dispatch.py``).

A primitive with a hand-written CUDA kernel and a plain PyTorch version
is selected by an impl knob:

  "auto"       the kernel for a CUDA tensor, the kernel's plain PyTorch
               version for a CPU tensor.  The wrapper of each kernel makes
               that choice from the device of the tensor it is given.
  "reference"  the plain oracle math of the whole primitive (``ref.py``),
               on any device.
  "kernel"     the CUDA kernel; a CPU tensor raises.

``repro``'s "kernel_interpret" ran a Pallas body on the CPU.  A CUDA
kernel has no interpreter, so it is rejected here with that reason.

The registry maps each dispatched kernel to the config knob that selects
it; ``kernel_scope`` names a kernel call site in profiles.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.obs import LEVEL_KERNEL, get_obs

IMPLS = ("auto", "reference", "kernel")

# kernel name -> the config-knob name callers select it with
_REGISTRY: dict[str, str] = {}


def register_kernel(name: str, knob: str = "kernel_impl") -> None:
    """Register a dispatched kernel under the config knob that selects it."""
    _REGISTRY[name] = knob


def registered_kernels() -> tuple[str, ...]:
    return tuple(_REGISTRY)


@contextlib.contextmanager
def kernel_scope(kernel: str, impl: str):
    """Name a dispatched-kernel call site ``kernel[impl]`` in profiles.

    Always a ``torch.profiler.record_function`` label (a no-op unless a
    profiler is recording); at obs level ``kernel`` also an NVTX range on
    the card and a ``kernel`` event on the obs timeline.  Names only: the
    computation is unchanged."""
    label = f"{kernel}[{impl}]"
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(label))
        obs = get_obs()
        if obs.level >= LEVEL_KERNEL:
            obs.event("kernel", cat="kernel", kernel=kernel, impl=impl)
            if torch.cuda.is_available():
                torch.cuda.nvtx.range_push(label)
                stack.callback(torch.cuda.nvtx.range_pop)
        yield


def check_impl_name(impl: str, kernel: str) -> str:
    """Validate the impl name alone (before any tensor exists); returns it."""
    if impl == "kernel_interpret":
        raise ValueError(
            f"{kernel}: impl 'kernel_interpret' has no counterpart in "
            "repro_torch — a CUDA kernel has no interpreter and the CPU box "
            "has no triton or nvcc; use 'auto' (plain version on the CPU) "
            "or 'reference'"
        )
    if impl not in IMPLS:
        raise ValueError(f"{kernel}: unknown impl {impl!r}; choose from {IMPLS}")
    return impl


def check_impl(impl: str, kernel: str, tensor: torch.Tensor) -> str:
    """Validate ``impl`` for ``kernel`` on ``tensor``'s device; returns it."""
    check_impl_name(impl, kernel)
    if impl == "kernel" and not tensor.is_cuda:
        raise ValueError(
            f"{kernel}: impl 'kernel' needs CUDA tensors, got a tensor on "
            f"{tensor.device}; use 'auto' or 'reference' on the CPU"
        )
    return impl


register_kernel("pfedsop_update", knob="update_impl")
register_kernel("rmsnorm")
register_kernel("flash_gqa")
# the attention backward (K6 + K7) runs under its own scope, launched by the
# forward's autograd function
register_kernel("flash_gqa_bwd")
