"""Cohort store (port of ``repro/fl/cohort_store.py``, ``DeviceStore`` only).

Every client's state lives at rest as one ``(K, ...)``-stacked tensor per
leaf on the device — for pFedSOP a ``(K, N)`` f32 parameter buffer and a
``(K, N)`` delta buffer, so the round-start kernels read the gathered
rows with no flatten or pad copy.  Each round ``gather`` copies the K'
participants' rows out and ``scatter`` writes the new rows back in place
(``index_copy_``: the store is updated in place, not rebuilt, to keep one
copy of the K-stack in device memory).  The host and mmap stores and the
LRU cache come later (ROADMAP.md queue 1, item 12).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.pytree import tree_leaves, tree_map


class DeviceStore:
    """The (K, ...) stack resident on ``device``."""

    def __init__(self, proto, k: int, device: torch.device):
        self.device = device
        self._stack = tree_map(
            lambda x: x.to(device).expand((k,) + tuple(x.shape)).clone(), proto)

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    def gather(self, ids):
        """Stacked (K', ...) cohort for ``ids`` (row order = ids order)."""
        idx = self._ids(ids)
        return tree_map(lambda x: x.index_select(0, idx), self._stack)

    def scatter(self, ids, new_states) -> None:
        """Write the (K', ...) cohort back to rows ``ids`` (distinct)."""
        idx = self._ids(ids)
        for full, new in zip(tree_leaves(self._stack), tree_leaves(new_states)):
            full.index_copy_(0, idx, new.to(full.dtype))

    def stacked(self):
        return self._stack


def make_store(store, proto, k: int, device: torch.device) -> DeviceStore:
    """Store factory (``FLRunConfig.store`` -> a store); device only."""
    if store not in (None, "device"):
        raise NotImplementedError(
            f"store={store!r} is not ported to repro_torch yet (host/mmap "
            "stores and the LRU cache: ROADMAP.md queue 1 item 12); use the "
            "device store (store=None or 'device')")
    return DeviceStore(proto, k, device)
