"""The kernels on the meta device: a shape-and-cost model.

A meta tensor has a shape, a dtype and a storage size, and no data, so no
kernel can run on it.  Under impl "auto" each kernel wrapper treats a meta
tensor as it treats a CUDA one up to the launch: it checks the operands and
allocates the outputs and the scratch its CUDA path allocates, on the meta
device.  In place of the launch it calls ``launch`` here with the kernel's
name (its key in the wrapper's ``LAUNCHES``) and its cost
(``repro_torch/kernels/costs.py``).  The real ``LAUNCHES`` counters are not
touched.

``launch/dryrun.py`` opens a ``census`` around a step on meta tensors and
reads what the step would launch on the card: the launches, FLOPs and bytes
of every kernel.  This is not a fallback: a CPU tensor takes the kernel's
plain version and a CUDA tensor the kernel, as they always did, and
``impl="reference"`` runs the oracle on any device, meta included.
"""
from __future__ import annotations

import contextlib

_ACTIVE: list = []


class Census:
    """Launches, FLOPs and bytes per kernel name, summed over the launches
    recorded while it is open."""

    def __init__(self):
        self.launches: dict[str, int] = {}
        self.flops: dict[str, float] = {}
        self.bytes: dict[str, float] = {}

    def add(self, name: str, cost: dict) -> None:
        self.launches[name] = self.launches.get(name, 0) + 1
        self.flops[name] = self.flops.get(name, 0.0) + cost["flops"]
        self.bytes[name] = self.bytes.get(name, 0.0) + cost["bytes"]


@contextlib.contextmanager
def census():
    """Record every meta launch until the block ends; yields the ``Census``."""
    c = Census()
    _ACTIVE.append(c)
    try:
        yield c
    finally:
        _ACTIVE.remove(c)


def launch(name: str, cost: dict) -> None:
    """A kernel wrapper's launch on meta tensors: add it to every open census."""
    for c in _ACTIVE:
        c.add(name, cost)
