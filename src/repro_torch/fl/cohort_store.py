"""Cohort store: where the K-stacked client states live at rest (port of
``repro/fl/cohort_store.py``).

Every client's state is one ``(K, ...)``-stacked array per leaf; for
pFedSOP a ``(K, N)`` f32 parameter buffer, a ``(K, N)`` delta buffer and
two per-client scalars.  Each round touches only the K' participants:

    gather(ids)  rows at rest -> (K', ...) cohort on ``device``   [h2d]
    scatter(ids) (K', ...) cohort -> rows at rest                 [d2h, deferred]

Two stores behind one interface, selected by ``StoreConfig.kind``:

  DeviceStore  the stack resident on ``device``: gather is ``index_select``
               and scatter ``index_copy_`` in place (one copy of the
               K-stack in device memory).  kind="device".
  HostStore    the stack at rest in host numpy (kind="host"), or in
               ``np.memmap`` leaves under ``mmap_dir`` (kind="mmap"; a
               "host" store past ``mmap_threshold_bytes`` spills to memmaps
               and sets ``promoted``).  Gather fancy-indexes the rows into
               one pinned staging buffer per leaf and makes one
               ``non_blocking`` copy to the card.  Scatter copies each leaf
               into a pinned host buffer on a side CUDA stream (after that
               stream waits for the current one, which produced the
               cohort), records an event, and defers the numpy write until
               the next host access (gather, stacked, a checkpoint), which
               waits on the event and writes the rows in FIFO order (the
               last write wins).  So the copies overlap the next round's
               host sampling, as ``repro``'s ``copy_to_host_async`` does.

An optional LRU device cache (``cache_clients > 0``, host/mmap only) keeps
the most recently touched clients' rows in one ``(cache_clients, ...)``
slot buffer per leaf; a cohort is assembled by one ``index_select`` over
[slot buffer ‖ fetched misses], and its bookkeeping is ``repro``'s line
for line, so the hit, miss, eviction and insert counters equal
``repro``'s for the same sequence of cohorts.

Gather and scatter are pure data movement: a streamed federation gives
the device store's history bit for bit.  A checkpoint streams the stack
beside its ``arrays.npz`` in client-range shard files, ``repro``'s layout.

On a mesh engine (``fl/engine.py``) the gather takes the engine's
``input_shardings``: each rank gathers only its rows of the cohort, and
its model slice of a model-sharded leaf, bypassing the LRU cache as
``repro`` does.  Across the ranks of one host the host and mmap stores
are ONE copy (``shared``: memmaps in a directory rank 0 picks) and each
rank writes back only its own rows, synchronously, between two barriers
(after its writes, after its reads) so no rank reads a row while another
writes it.  The device store is one replica per rank and takes every
rank's rows.
"""
from __future__ import annotations

import json
import tempfile
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.launch import collectives
from repro_torch.utils.checkpoint import flatten_with_names, leaf_like, leaf_to_numpy
from repro_torch.utils.pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten

STORE_KINDS = ("device", "host", "mmap")


@dataclass(frozen=True)
class StoreConfig:
    """Where the K-stacked client states live at rest.

    ``kind``: "device" (resident stack), "host" (numpy at rest,
    spilling to memmaps past ``mmap_threshold_bytes``) or "mmap" (always
    disk-backed memmaps under ``mmap_dir``).

    ``cache_clients``: LRU device cache capacity in clients (0 = off);
    host/mmap stores only, since the device store is its own cache.

    ``mmap_dir``: backing directory for memmapped leaves ("" = a fresh
    ``tempfile.mkdtemp``; checkpoints never depend on it).

    ``mmap_threshold_bytes``: a "host" store spills to memmaps when the
    at-rest stack exceeds this many bytes (0 = never spill).

    ``ckpt_shard_clients``: clients per checkpoint shard file, the
    checkpoint path's working-memory bound.
    """

    kind: str = "device"
    cache_clients: int = 0
    mmap_dir: str = ""
    mmap_threshold_bytes: int = 4 << 30  # 4 GiB
    ckpt_shard_clients: int = 65536

    def __post_init__(self):
        if self.kind not in STORE_KINDS:
            raise ValueError(f"store kind must be one of {STORE_KINDS}, got {self.kind!r}")
        if self.cache_clients < 0:
            raise ValueError(f"cache_clients must be >= 0, got {self.cache_clients}")
        if self.cache_clients and self.kind == "device":
            raise ValueError(
                "cache_clients only applies to host/mmap stores (the device "
                "store is already resident); drop the flag or pick store='host'")
        if self.ckpt_shard_clients < 1:
            raise ValueError(
                f"ckpt_shard_clients must be >= 1, got {self.ckpt_shard_clients}")


def as_store_config(store) -> StoreConfig:
    """Resolve ``FLRunConfig.store``: None -> device, str -> kind, or a
    full ``StoreConfig`` passed through."""
    if store is None:
        return StoreConfig()
    if isinstance(store, str):
        return StoreConfig(kind=store)
    if isinstance(store, StoreConfig):
        return store
    raise TypeError(f"store must be None, a kind string {STORE_KINDS}, or a "
                    f"StoreConfig; got {type(store).__name__}")


def _tree_bytes(tree) -> int:
    return sum(leaf.nbytes for leaf in tree_leaves(tree))


def _torch_dtype(a: np.ndarray) -> torch.dtype:
    return torch.from_numpy(np.empty(0, a.dtype)).dtype


def _index(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.int64), device=device)


def _host(x) -> np.ndarray:
    """A numpy copy of a tensor (or array), never a view of it."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.cpu().numpy() if x.is_cuda else x.numpy().copy()
    return np.array(x)


def _shard_ids(ids: np.ndarray, shard) -> np.ndarray:
    """The client ids of this rank's rows of a leaf (all ids without a
    placement)."""
    return ids if shard is None else ids[shard.rows]


def _narrow(x, shard):
    """This rank's model slice of a gathered leaf (the leaf itself when
    the leaf is not model-sharded)."""
    if shard is None or shard.model is None:
        return x
    d, sl = shard.model
    return x.narrow(d, sl.start, sl.stop - sl.start).contiguous()


def _own(ids: np.ndarray, new_states, shardings):
    """(client ids, row tree) this rank writes back: its rows of the
    cohort, whether ``new_states`` holds the whole cohort or just them."""
    leaves = tree_leaves(new_states)
    if not leaves:  # a stateless method (FedAvg)
        return ids[:0], new_states
    rows = tree_leaves(shardings)[0].rows
    if leaves[0].shape[0] == len(ids):
        new_states = tree_map(lambda x: x[rows], new_states)
    return ids[rows], new_states


class CohortStore:
    """Interface and shared bookkeeping of the two stores.

    ``proto`` is ONE client's state tree; the store broadcasts it to the
    (K,)-stacked layout (every client starts from the same init).  Stats
    keys are ``repro``'s: gathers/scatters, h2d/d2h bytes moved, and the
    LRU cache's counters.  ``shared``: the ranks of one host hold one
    copy (the host stores on a mesh)."""

    shared = False

    def __init__(self, cfg: StoreConfig, k: int, device: torch.device):
        self.cfg = cfg
        self.k = k
        self.device = torch.device(device)
        self._stats = {
            "gathers": 0, "scatters": 0, "h2d_bytes": 0, "d2h_bytes": 0,
            "cache_hits": 0, "cache_misses": 0, "cache_evictions": 0,
            "cache_assembles": 0, "cache_insert_rows": 0,
        }

    def gather(self, ids, shardings=None):
        """Stacked (K', ...) cohort for ``ids`` on ``device`` (row order =
        ids order); with ``shardings`` (a mesh engine's
        ``input_shardings``) this rank's part of it."""
        raise NotImplementedError

    def scatter(self, ids, new_states, shardings=None) -> None:
        """Write the (K', ...) cohort back to rows ``ids``; a shared store
        writes only this rank's rows (``shardings``) of it."""
        raise NotImplementedError

    def offload(self, tree, force_host: bool = False):
        """Representation for results buffered outside the store (the async
        driver's in-flight dispatches): host numpy copies whenever the store
        is host-resident, or when the caller forces it."""
        raise NotImplementedError

    def stacked(self):
        """The full (K, ...) stacked tree in the at-rest representation."""
        raise NotImplementedError

    def load_stacked(self, tree) -> None:
        """Replace the full stack (values copied into the at-rest layout)."""
        raise NotImplementedError

    def stats(self) -> dict:
        return dict(self._stats)

    def describe(self) -> dict:
        """Store facets stamped into the checkpoint fingerprint."""
        return {"kind": self.cfg.kind, "cache_clients": self.cfg.cache_clients}

    # -- checkpoint shard streaming ---------------------------------------

    def _shard_ranges(self, s: int):
        return [(lo, min(lo + s, self.k)) for lo in range(0, max(self.k, 1), s)]

    def save_shards(self, step_dir) -> None:
        """The stack as ``<step_dir>/store_<i>.npz`` client-range shards plus
        a ``store_manifest.json`` naming the flattened leaves; working memory
        is one shard, not K."""
        d = Path(step_dir)
        d.mkdir(parents=True, exist_ok=True)
        ranges = self._shard_ranges(self.cfg.ckpt_shard_clients)
        names = None
        for i, (lo, hi) in enumerate(ranges):
            named = flatten_with_names(self._host_block(lo, hi))
            if names is None:
                names = [n for n, _ in named]
            np.savez(d / f"store_{i:05d}.npz",
                     **{f"a{j}": leaf_to_numpy(leaf) for j, (_, leaf) in enumerate(named)})
        manifest = {"k": self.k, "shard_clients": self.cfg.ckpt_shard_clients,
                    "n_shards": len(ranges), "names": names or [],
                    "store": self.describe()}
        (d / "store_manifest.json").write_text(json.dumps(manifest, indent=1))

    def load_shards(self, step_dir) -> None:
        """Inverse of ``save_shards`` (validates K and the leaf names).  The
        ranges come from the writer's ``shard_clients``, so a reader with
        another granularity restores exactly."""
        d = Path(step_dir)
        manifest = json.loads((d / "store_manifest.json").read_text())
        if manifest["k"] != self.k:
            raise ValueError(f"store shards at {d} hold {manifest['k']} clients, "
                             f"but this federation has {self.k}")
        want = [n for n, _ in flatten_with_names(self._host_block(0, 0))]
        if manifest["names"] != want:
            raise ValueError(f"store shards at {d} hold leaves {manifest['names']}, "
                             f"but this method's client state flattens to {want}")
        for i, (lo, hi) in enumerate(self._shard_ranges(int(manifest["shard_clients"]))):
            data = np.load(d / f"store_{i:05d}.npz")
            self._load_host_block(lo, hi, [data[f"a{j}"] for j in range(len(want))])

    # subclass hooks: the (lo, hi) client range as a tree, and its inverse
    # taking flat numpy leaves in flatten_with_names order
    def _host_block(self, lo: int, hi: int):
        raise NotImplementedError

    def _load_host_block(self, lo: int, hi: int, flat_leaves) -> None:
        raise NotImplementedError


class DeviceStore(CohortStore):
    """The (K, ...) stack resident on ``device``: the baseline the streamed
    stores are held to bit for bit."""

    def __init__(self, cfg: StoreConfig, proto, k: int, device):
        super().__init__(cfg, k, device)
        self._stack = tree_map(
            lambda x: x.to(self.device).expand((k,) + tuple(x.shape)).clone(), proto)

    def gather(self, ids, shardings=None):
        self._stats["gathers"] += 1
        ids = np.asarray(ids, np.int64)
        if shardings is None:
            idx = _index(ids, self.device)
            return tree_map(lambda x: x.index_select(0, idx), self._stack)
        return tree_map(
            lambda x, sh: _narrow(x.index_select(0, _index(_shard_ids(ids, sh), self.device)),
                                  sh),
            self._stack, shardings)

    def scatter(self, ids, new_states, shardings=None) -> None:
        """Rows ``ids`` (distinct) updated in place, from the whole cohort:
        this store is one replica per rank."""
        if any(x.shape[0] != len(ids) for x in tree_leaves(new_states)):
            raise ValueError("the device store is one replica per rank: scatter "
                             "takes every rank's rows of the cohort")
        self._stats["scatters"] += 1
        idx = _index(ids, self.device)
        for full, new in zip(tree_leaves(self._stack), tree_leaves(new_states)):
            new = torch.as_tensor(new, device=self.device)
            full.index_copy_(0, idx, new.to(full.dtype))

    def offload(self, tree, force_host=False):
        return tree_map(_host, tree) if force_host else tree

    def stacked(self):
        return self._stack

    def load_stacked(self, tree) -> None:
        for full, src in zip(tree_leaves(self._stack), tree_leaves(tree)):
            full.copy_(torch.as_tensor(src))

    def _host_block(self, lo, hi):
        return tree_map(lambda x: x[lo:hi], self._stack)

    def _load_host_block(self, lo, hi, flat_leaves) -> None:
        for leaf, arr in zip(tree_leaves(self._stack), flat_leaves):
            leaf[lo:hi] = leaf_like(arr, leaf)


class HostStore(CohortStore):
    """Host-at-rest store: numpy (or memmap) stack plus the LRU device cache.
    See the module docstring for the gather/scatter/overlap semantics."""

    def __init__(self, cfg: StoreConfig, proto, k: int, device, shared: bool = False):
        super().__init__(cfg, k, device)
        named = flatten_with_names(tree_map(_host, proto))
        total = k * sum(leaf.nbytes for _, leaf in named)
        # shared: one copy for the ranks of a host, in memmaps every rank maps
        self.shared = shared
        self.mmapped = shared or cfg.kind == "mmap" or (
            cfg.mmap_threshold_bytes > 0 and total > cfg.mmap_threshold_bytes)
        first = not shared or collectives.world_rank() == 0
        if self.mmapped:
            mmap_dir = cfg.mmap_dir or (tempfile.mkdtemp(prefix="cohort_store_")
                                        if first else None)
            if shared:
                mmap_dir = collectives.broadcast_object(mmap_dir)
            mmap_dir = Path(mmap_dir)
            mmap_dir.mkdir(parents=True, exist_ok=True)

        def alloc(name, leaf):
            shape = (k,) + leaf.shape
            if not self.mmapped:
                arr = np.empty(shape, leaf.dtype)
            elif not first:  # rank 0 made and filled the file
                return np.memmap(mmap_dir / (name.replace("/", ".") + ".mmap"),
                                 dtype=leaf.dtype, mode="r+", shape=shape)
            else:
                f = mmap_dir / (name.replace("/", ".") + ".mmap")
                arr = np.memmap(f, dtype=leaf.dtype, mode="w+", shape=shape)
            arr[...] = leaf  # broadcast the shared init row-wise
            if shared:
                arr.flush()
            return arr

        _, self._treedef = tree_flatten(proto)
        if shared and not first:
            collectives.barrier()  # wait for rank 0's files
        self._data = tree_unflatten(self._treedef, [alloc(n, leaf) for n, leaf in named])
        if shared and first:
            collectives.barrier()
        self.at_rest_bytes = total
        # a "host" store that crossed mmap_threshold_bytes spilled to disk
        self.promoted = cfg.kind == "host" and self.mmapped and not shared
        # deferred write-backs: (ids, pinned host leaves, event or None)
        self._writeback: List[tuple] = []
        self._d2h_stream: Optional[torch.cuda.Stream] = None
        # LRU device cache as a slot buffer: one (cache_clients, ...) tree
        # (allocated lazily), client id -> slot in LRU order, free slots
        self._slots = None
        self._lru: "OrderedDict[int, int]" = OrderedDict()
        self._free: List[int] = []

    # -- deferred write-back ----------------------------------------------

    def _flush(self) -> None:
        """Materialize pending scatters into the numpy stack (FIFO: last
        write wins, matching the scatter order)."""
        for ids, host, event in self._writeback:
            if event is not None:
                event.synchronize()
            for a, h in zip(tree_leaves(self._data), host):
                a[ids] = h.numpy()
        self._writeback.clear()

    # -- host <-> device ---------------------------------------------------

    def _h2d(self, ids: np.ndarray, shardings=None):
        """Rows ``ids`` of every leaf (this rank's rows and model slice with
        ``shardings``) on the device: on the card fancy-indexed straight
        into one pinned staging buffer per leaf and copied with
        ``non_blocking`` (the caching host allocator keeps the buffer until
        the copy is done); on the CPU a fresh copy of the rows."""
        out = []
        shards = ([None] * len(tree_leaves(self._data)) if shardings is None
                  else tree_leaves(shardings))
        for a, sh in zip(tree_leaves(self._data), shards):
            rows = _shard_ids(ids, sh)
            if self.device.type == "cuda":
                stage = torch.empty((len(rows),) + a.shape[1:],
                                    dtype=_torch_dtype(a), pin_memory=True)
                # mode="raise" would buffer ``out`` (a second copy of the
                # rows); gather checked the ids, so "wrap" reads the same rows
                np.take(a, rows, axis=0, out=stage.numpy(), mode="wrap")
                out.append(stage.to(self.device, non_blocking=True))
            else:
                out.append(torch.from_numpy(np.asarray(a[rows])))
            out[-1] = _narrow(out[-1], sh)
            self._stats["h2d_bytes"] += out[-1].nbytes
        return tree_unflatten(self._treedef, out)

    def _d2h(self, leaves):
        """Start the copies of ``leaves`` to pinned host buffers on a side
        stream; returns (host leaves, event).  CPU tensors are kept as they
        are: their values are read at the flush."""
        if not leaves or not leaves[0].is_cuda:  # no leaves: a stateless method
            return [x.detach() for x in leaves], None
        dev = leaves[0].device
        if self._d2h_stream is None:
            self._d2h_stream = torch.cuda.Stream(device=dev)
        side = self._d2h_stream
        side.wait_stream(torch.cuda.current_stream(dev))  # the cohort was made there
        host = []
        with torch.cuda.stream(side):
            for x in leaves:
                h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                h.copy_(x.detach(), non_blocking=True)
                x.record_stream(side)  # not reused before the copy is done
                host.append(h)
            event = torch.cuda.Event()
            event.record(side)
        return host, event

    # -- gather / scatter --------------------------------------------------

    def gather(self, ids, shardings=None):
        ids = np.asarray(ids, np.int64)
        if ids.size and (ids.min() < -self.k or ids.max() >= self.k):
            raise IndexError(f"client ids must lie in [-{self.k}, {self.k}), got "
                             f"{ids.min()}..{ids.max()}")
        self._flush()
        self._stats["gathers"] += 1
        if shardings is not None:
            # a mesh engine's placement: this rank's part, past the cache
            out = self._h2d(ids, shardings)
            if self.shared:
                collectives.barrier()  # every rank has read before any writes
            return out
        if not self.cfg.cache_clients:
            return self._h2d(ids)
        return self._gather_cached(ids)

    def _ensure_slots(self) -> None:
        if self._slots is None:
            cap = self.cfg.cache_clients
            self._slots = tree_map(
                lambda a: torch.zeros((cap,) + a.shape[1:],
                                      dtype=_torch_dtype(a), device=self.device),
                self._data)
            self._free = list(range(cap - 1, -1, -1))  # pop() fills 0, 1, ...

    def _slots_insert(self, src, jarr, sarr) -> None:
        """Batched cache fill: slot[sarr[r]] = src[jarr[r]] for every row r."""
        s_idx, j_idx = _index(sarr, self.device), _index(jarr, self.device)
        for s, x in zip(tree_leaves(self._slots), tree_leaves(src)):
            s.index_copy_(0, s_idx, x.index_select(0, j_idx).to(s.dtype))

    def _gather_cached(self, ids):
        """Cohort assembly through the LRU slot buffer: ONE index_select over
        [slot buffer ‖ fetched miss block].

        The output index map is computed BEFORE any cache bookkeeping:
        filling a miss can evict a slot this same cohort still needs (a hit
        older in LRU order, or an earlier miss when K' exceeds the
        capacity), so assembly must see the pre-insertion slot layout."""
        id_list = ids.tolist()
        cap = self.cfg.cache_clients
        lru = self._lru
        # duplicate occurrences count per occurrence, and a duplicated miss
        # fetches (and later writes) its row once per occurrence with the
        # last one winning
        miss = [i for i in id_list if i not in lru]
        self._stats["cache_hits"] += len(id_list) - len(miss)
        self._stats["cache_misses"] += len(miss)
        self._stats["cache_assembles"] += 1
        block = None
        if miss:
            self._ensure_slots()
            block = self._h2d(np.asarray(miss, np.int64))
        mpos = {i: j for j, i in enumerate(miss)}  # last occurrence wins
        idx = _index([lru[i] if i in lru else cap + mpos[i] for i in id_list], self.device)
        if block is None:
            cohort = tree_map(lambda s: s.index_select(0, idx), self._slots)
        else:
            cohort = tree_map(lambda s, b: torch.cat([s, b]).index_select(0, idx),
                              self._slots, block)
        # LRU bookkeeping in the per-row cache's order: hits touch in cohort
        # order, then misses insert (evicting from the front) in miss order
        for i in id_list:
            if i in lru:
                lru.move_to_end(i)
        pend: Dict[int, int] = {}
        for j, i in enumerate(miss):
            if i in lru:  # duplicated miss: already placed this cohort
                lru.move_to_end(i)
            else:
                if len(lru) >= cap:
                    _, slot = lru.popitem(last=False)
                    self._free.append(slot)
                    self._stats["cache_evictions"] += 1
                lru[i] = self._free.pop()
            pend[i] = j
        # one batched fill for the misses that survived their own cohort's
        # evictions
        live = [(lru[i], j) for i, j in pend.items() if i in lru]
        if live:
            self._slots_insert(block, [j for _, j in live], [s for s, _ in live])
            self._stats["cache_insert_rows"] += len(live)
        return cohort

    def scatter(self, ids, new_states, shardings=None) -> None:
        self._stats["scatters"] += 1
        ids = np.asarray(ids, np.int64)
        if self.shared:
            # this rank's rows, written now; the barrier makes every rank's
            # rows visible before the next gather reads
            own, rows = _own(ids, new_states, shardings)
            for a, x in zip(tree_leaves(self._data), tree_leaves(rows)):
                h = _host(x)
                a[own] = h
                self._stats["d2h_bytes"] += h.nbytes
            collectives.barrier()
            return
        leaves = tree_leaves(new_states)
        if leaves and not isinstance(leaves[0], torch.Tensor):
            # host rows (offloaded async results): write through directly,
            # and drop their cached device rows as stale
            for a, h in zip(tree_leaves(self._data), leaves):
                a[ids] = np.asarray(h)
            for i in ids.tolist():
                slot = self._lru.pop(i, None)
                if slot is not None:
                    self._free.append(slot)
            return
        # start the d2h copies now, materialize at the next host access
        host, event = self._d2h(leaves)
        self._stats["d2h_bytes"] += _tree_bytes(new_states)
        self._writeback.append((ids, host, event))
        if self.cfg.cache_clients:
            # write-through into the slot buffer, one batched fill: resident
            # rows refresh in place; new rows only while free capacity
            # remains (scatter never evicts)
            self._ensure_slots()
            lru, pend = self._lru, {}
            for j, i in enumerate(ids.tolist()):
                if i in lru:
                    lru.move_to_end(i)
                    pend[i] = j
                elif len(lru) < self.cfg.cache_clients:
                    lru[i] = self._free.pop()
                    pend[i] = j
            if pend:
                self._slots_insert(new_states, list(pend.values()), [lru[i] for i in pend])
                self._stats["cache_insert_rows"] += len(pend)

    def offload(self, tree, force_host=False):
        del force_host  # a host store's buffered results never pin device memory
        return tree_map(_host, tree)

    # -- whole-stack access -----------------------------------------------

    def stacked(self):
        self._flush()
        return self._data

    def _drop_cache(self) -> None:
        self._slots = None  # reallocated lazily on the next cached access
        self._lru.clear()
        self._free = []

    def _first_writes(self) -> bool:
        """Whole-stack writes (checkpoint restore): rank 0 of a shared
        store writes, the others wait for it (``_done_writing``)."""
        return not self.shared or collectives.world_rank() == 0

    def _done_writing(self) -> None:
        if self.shared:
            collectives.barrier()

    def load_stacked(self, tree) -> None:
        self._writeback.clear()
        self._drop_cache()
        if self._first_writes():
            for a, src in zip(tree_leaves(self._data), tree_leaves(tree)):
                a[...] = _host(src)
        self._done_writing()

    def _host_block(self, lo, hi):
        self._flush()
        return tree_map(lambda a: np.array(a[lo:hi]), self._data)

    def _load_host_block(self, lo, hi, flat_leaves) -> None:
        self._writeback.clear()
        self._drop_cache()
        if self._first_writes():
            for a, b in zip(tree_leaves(self._data), flat_leaves):
                a[lo:hi] = b
        self._done_writing()


def make_store(store, proto, k: int, device, shared: bool = False) -> CohortStore:
    """Store factory (``FLRunConfig.store`` -> a ``CohortStore``) on
    ``device``; ``shared``: a host store is one copy for the ranks of a
    host (a mesh engine over several ranks)."""
    cfg = as_store_config(store)
    if cfg.kind == "device":
        return DeviceStore(cfg, proto, k, device)
    return HostStore(cfg, proto, k, device, shared=shared)
