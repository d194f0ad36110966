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
"""
from __future__ import annotations

import torch

IMPLS = ("auto", "reference", "kernel")


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
