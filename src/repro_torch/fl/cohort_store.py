"""Cohort store (port of ``repro/fl/cohort_store.py``, ``DeviceStore`` only).

Every client's state lives at rest as one ``(K, ...)``-stacked tensor per
leaf on the device — for pFedSOP a ``(K, N)`` f32 parameter buffer and a
``(K, N)`` delta buffer, so the round-start kernels read the gathered
rows with no flatten or pad copy.  Each round ``gather`` copies the K'
participants' rows out and ``scatter`` writes the new rows back in place
(``index_copy_``: the store is updated in place, not rebuilt, to keep one
copy of the K-stack in device memory).  A checkpoint streams the stack
beside its ``arrays.npz`` in client-range shard files, ``repro``'s layout.
The host and mmap stores and the LRU cache come later (ROADMAP.md queue
1, item 12).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.utils.checkpoint import flatten_with_names, leaf_like, leaf_to_numpy
from repro_torch.utils.pytree import tree_flatten, tree_leaves, tree_map

CKPT_SHARD_CLIENTS = 65536  # clients per checkpoint shard file (repro's default)


class DeviceStore:
    """The (K, ...) stack resident on ``device``."""

    def __init__(self, proto, k: int, device: torch.device):
        self.device = device
        self.k = k
        self._stack = tree_map(
            lambda x: x.to(device).expand((k,) + tuple(x.shape)).clone(), proto)
        # repro's stats keys; the device store moves no host bytes
        self._stats = {
            "gathers": 0, "scatters": 0, "h2d_bytes": 0, "d2h_bytes": 0,
            "cache_hits": 0, "cache_misses": 0, "cache_evictions": 0,
            "cache_assembles": 0, "cache_insert_rows": 0,
        }

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    def gather(self, ids):
        """Stacked (K', ...) cohort for ``ids`` (row order = ids order)."""
        self._stats["gathers"] += 1
        idx = self._ids(ids)
        return tree_map(lambda x: x.index_select(0, idx), self._stack)

    def scatter(self, ids, new_states) -> None:
        """Write the (K', ...) cohort back to rows ``ids`` (distinct)."""
        self._stats["scatters"] += 1
        idx = self._ids(ids)
        for full, new in zip(tree_leaves(self._stack), tree_leaves(new_states)):
            full.index_copy_(0, idx, new.to(full.dtype))

    def stacked(self):
        return self._stack

    def stats(self) -> dict:
        return dict(self._stats)

    def describe(self) -> dict:
        """Store facets stamped into the checkpoint fingerprint."""
        return {"kind": "device", "cache_clients": 0}

    # -- checkpoint shard streaming ---------------------------------------

    def _shard_ranges(self, s: int = CKPT_SHARD_CLIENTS):
        return [(lo, min(lo + s, self.k)) for lo in range(0, max(self.k, 1), s)]

    def _host_block(self, lo: int, hi: int):
        return tree_map(lambda x: x[lo:hi], self._stack)

    def save_shards(self, step_dir) -> None:
        """The stack as ``<step_dir>/store_<i>.npz`` client-range shards plus
        a ``store_manifest.json`` naming the flattened leaves."""
        d = Path(step_dir)
        d.mkdir(parents=True, exist_ok=True)
        ranges = self._shard_ranges()
        names = None
        for i, (lo, hi) in enumerate(ranges):
            named = flatten_with_names(self._host_block(lo, hi))
            if names is None:
                names = [n for n, _ in named]
            np.savez(d / f"store_{i:05d}.npz",
                     **{f"a{j}": leaf_to_numpy(leaf) for j, (_, leaf) in enumerate(named)})
        manifest = {"k": self.k, "shard_clients": CKPT_SHARD_CLIENTS,
                    "n_shards": len(ranges), "names": names or [],
                    "store": self.describe()}
        (d / "store_manifest.json").write_text(json.dumps(manifest, indent=1))

    def load_shards(self, step_dir) -> None:
        """Inverse of ``save_shards`` (validates K and the leaf names)."""
        d = Path(step_dir)
        manifest = json.loads((d / "store_manifest.json").read_text())
        if manifest["k"] != self.k:
            raise ValueError(f"store shards at {d} hold {manifest['k']} clients, "
                             f"but this federation has {self.k}")
        want = [n for n, _ in flatten_with_names(self._host_block(0, 0))]
        if manifest["names"] != want:
            raise ValueError(f"store shards at {d} hold leaves {manifest['names']}, "
                             f"but this method's client state flattens to {want}")
        full, _ = tree_flatten(self._stack)
        for i, (lo, hi) in enumerate(self._shard_ranges(int(manifest["shard_clients"]))):
            data = np.load(d / f"store_{i:05d}.npz")
            for j, leaf in enumerate(full):
                leaf[lo:hi] = leaf_like(data[f"a{j}"], leaf)


def make_store(store, proto, k: int, device: torch.device) -> DeviceStore:
    """Store factory (``FLRunConfig.store`` -> a store); device only."""
    if store not in (None, "device"):
        raise NotImplementedError(
            f"store={store!r} is not ported to repro_torch yet (host/mmap "
            "stores and the LRU cache: ROADMAP.md queue 1 item 12); use the "
            "device store (store=None or 'device')")
    return DeviceStore(proto, k, device)
