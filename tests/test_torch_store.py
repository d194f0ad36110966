"""The port's cohort stores (device, host, mmap; the LRU device cache)
against ``repro``'s and against each other.

- Units, ported from ``tests/test_cohort_store.py``: config validation
  and the auto-promote past the threshold; gather order, bitwise scatter,
  the deferred write-back, host rows written through; the LRU's eviction
  order, hit accounting, a cohort larger than the cache, write-allocate
  on scatter; memmaps on disk and the shard save/load round trip with
  its refusals; ``offload``.  (The sharded gather and the stores shared
  by the ranks of a mesh: ``tests/test_torch_multidevice.py``.)
- Across packages: one random sequence of gathers (duplicates included)
  and scatters (device rows and host rows) through ``repro``'s
  ``HostStore`` and the port's, with and without the cache: every gathered
  row and the final stack bitwise equal, every stats counter equal.  The
  sequence is drawn from a seed: a fixed grid of seeds, and seeds drawn
  by hypothesis.
- Federations: the port's pfedsop histories and final client rows are
  bitwise equal across the device, host, mmap and host + cache stores, in
  sync, degenerate async and heterogeneous async; the host store's
  history against ``repro``'s host store within the port's usual
  tolerances (loss rtol 1e-5, accuracy atol 1e-6 in sync as
  ``tests/test_torch_pfedsop.py``; both rtol 1e-5 in async as
  ``tests/test_torch_async.py``: f32 convolutions summed in another
  order); an async checkpoint/resume on the host store bit for bit.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hyp_compat import given, hst, settings  # optional-hypothesis shim
from test_async_federation import HETERO as J_HETERO

from repro.configs.resnet_cifar import SMALL_CNN as J_CFG
from repro.core import baselines as j_bl
from repro.data import FederatedData as JData
from repro.data import dirichlet_partition, make_class_conditional_images
from repro.fl import AsyncConfig as JAsyncConfig, AsyncFederation as JAsync
from repro.fl import Federation as JFederation, FLRunConfig as JRunConfig
from repro.fl import cohort_store as j_store
from repro.fl.runtime import masked_accuracy as j_masked_accuracy
from repro.models import cnn as j_cnn
from repro_torch.configs.resnet_cifar import SMALL_CNN as T_CFG
from repro_torch.core import baselines as t_bl
from repro_torch.data import FederatedData as TData
from repro_torch.fl import (
    AsyncConfig,
    AsyncFederation,
    AvailabilityConfig,
    DeviceStore,
    Federation,
    FLRunConfig,
    HostStore,
    StoreConfig,
    as_store_config,
    make_store,
    masked_accuracy,
)
from repro_torch.launch import profile_store
from repro_torch.models import cnn as t_cnn
from repro_torch.utils.pytree import tree_leaves, tree_map
from repro_torch.weights import params_from_jax

HETERO = AvailabilityConfig(**dataclasses.asdict(J_HETERO))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs files in
    several worker processes at once, and torch's OpenMP pools of one
    thread per core each make them wait on one another for many times
    the work (the values do not depend on it: every comparison here is
    within one process or to a stated tolerance)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _proto():
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nest": {"b": torch.tensor(0.5)}}


PROTO_W = np.arange(6, dtype=np.float32).reshape(2, 3)


def _host(k=8, **kw):
    return make_store(StoreConfig(kind="host", **kw), _proto(), k, "cpu")


def _rows(store, ids):
    """numpy copies of the at-rest rows for ``ids`` (flushes deferred writes)."""
    def take(a):
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        return np.array(a[np.asarray(ids)])
    return tree_map(take, store.stacked())


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- units -----------------------------------------------------------------


class TestConfig:
    def test_as_store_config_resolution(self):
        assert as_store_config(None).kind == "device"
        assert as_store_config("mmap").kind == "mmap"
        cfg = StoreConfig(kind="host", cache_clients=3)
        assert as_store_config(cfg) is cfg
        with pytest.raises(TypeError):
            as_store_config(42)

    def test_invalid_kind_and_cache_rejected(self):
        with pytest.raises(ValueError, match="store kind"):
            StoreConfig(kind="gpu")
        with pytest.raises(ValueError, match="cache_clients"):
            StoreConfig(cache_clients=-1)
        with pytest.raises(ValueError, match="host/mmap"):
            StoreConfig(kind="device", cache_clients=4)
        with pytest.raises(ValueError, match="ckpt_shard_clients"):
            StoreConfig(ckpt_shard_clients=0)

    def test_make_store_kinds(self):
        assert isinstance(make_store(None, _proto(), 4, "cpu"), DeviceStore)
        assert isinstance(make_store("host", _proto(), 4, "cpu"), HostStore)
        assert not make_store("host", _proto(), 4, "cpu").mmapped
        assert make_store("mmap", _proto(), 4, "cpu").mmapped

    def test_host_auto_promotes_to_mmap_past_threshold(self, tmp_path):
        cfg = StoreConfig(kind="host", mmap_threshold_bytes=64, mmap_dir=str(tmp_path))
        s = make_store(cfg, _proto(), 1024, "cpu")
        assert s.mmapped and s.promoted
        assert s.at_rest_bytes == 1024 * 7 * 4
        assert not make_store("mmap", _proto(), 4, "cpu").promoted

    def test_make_store_refuses_the_card_without_one(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError):
            make_store("host", _proto(), 4, "cuda").gather([0])


class TestGatherScatter:
    @pytest.mark.parametrize("kind", ["device", "host"])
    def test_gather_matches_rows_in_ids_order(self, kind):
        s = make_store(kind, _proto(), 8, "cpu")
        got = s.gather(np.asarray([5, 1, 1]))
        row = got["w"].numpy()
        assert row.shape == (3, 2, 3)
        np.testing.assert_array_equal(row[0], PROTO_W)
        np.testing.assert_array_equal(row[1], row[2])

    @pytest.mark.parametrize("kind", ["device", "host"])
    def test_scatter_roundtrips_bitwise(self, kind):
        s = make_store(kind, _proto(), 8, "cpu")
        ids = np.asarray([2, 6])
        new = {"w": torch.stack([torch.full((2, 3), 7.25), torch.full((2, 3), -1.5)]),
               "nest": {"b": torch.tensor([3.0, 4.0])}}
        s.scatter(ids, new)
        got = _rows(s, ids)
        np.testing.assert_array_equal(got["w"], new["w"].numpy())
        np.testing.assert_array_equal(got["nest"]["b"], [3.0, 4.0])
        # untouched rows keep the broadcast init
        np.testing.assert_array_equal(_rows(s, [0])["w"][0], PROTO_W)

    def test_host_gather_refuses_ids_out_of_range(self):
        s = _host(k=8)
        np.testing.assert_array_equal(s.gather(np.asarray([-1]))["w"].numpy()[0], PROTO_W)
        for bad in ([8], [0, -9]):
            with pytest.raises(IndexError, match="client ids"):
                s.gather(np.asarray(bad))
        assert s.stats()["gathers"] == 1

    def test_host_gather_is_a_copy_not_a_view(self):
        s = _host()
        got = s.gather(np.asarray([3]))
        got["w"].fill_(-9.0)
        np.testing.assert_array_equal(s.stacked()["w"][3], PROTO_W)

    def test_host_write_back_is_deferred_until_host_access(self):
        """scatter starts the copy but defers the numpy write until the next
        gather/stacked."""
        s = _host()
        ids = np.asarray([1])
        new = {"w": torch.ones((1, 2, 3)) * 9.0, "nest": {"b": torch.tensor([8.0])}}
        s.scatter(ids, new)
        assert len(s._writeback) == 1
        # the raw at-rest array still holds the old value (write deferred)
        np.testing.assert_array_equal(s._data["w"][1], PROTO_W)
        # any host access flushes
        np.testing.assert_array_equal(_rows(s, [1])["w"][0], 9.0 * np.ones((2, 3)))
        assert not s._writeback
        assert s.stats()["d2h_bytes"] == 7 * 4

    def test_host_scatter_of_np_rows_writes_through(self):
        """Offloaded async results arrive as host numpy rows: written
        directly, and any cached device row for those ids dropped as stale."""
        s = _host(cache_clients=4)
        s.gather(np.asarray([0, 1]))  # warm the cache
        new = {"w": np.full((1, 2, 3), 5.0, np.float32),
               "nest": {"b": np.asarray([2.0], np.float32)}}
        s.scatter(np.asarray([0]), new)
        assert 0 not in s._lru and 1 in s._lru
        assert not s._writeback and s.stats()["d2h_bytes"] == 0
        np.testing.assert_array_equal(_rows(s, [0])["w"][0], 5.0)
        # the next gather re-fetches the written value through the cache path
        np.testing.assert_array_equal(s.gather(np.asarray([0]))["w"][0].numpy(), 5.0)


class TestLRUCache:
    def test_eviction_order_is_least_recently_used(self):
        s = _host(cache_clients=2)
        s.gather(np.asarray([0]))
        s.gather(np.asarray([1]))
        s.gather(np.asarray([0]))  # touch 0: now 1 is the LRU entry
        s.gather(np.asarray([2]))  # evicts 1, not 0
        assert list(s._lru) == [0, 2]
        assert s.stats()["cache_evictions"] == 1
        s.gather(np.asarray([1]))  # miss: evicts 0 (front of [0, 2])
        assert list(s._lru) == [2, 1]

    def test_hit_accounting_and_h2d_savings(self):
        s = _host(cache_clients=4)
        s.gather(np.asarray([0, 1, 2, 3]))
        st = s.stats()
        assert (st["cache_hits"], st["cache_misses"]) == (0, 4)
        moved = st["h2d_bytes"]
        assert moved == 4 * 7 * 4
        s.gather(np.asarray([3, 0]))  # pure hits: no new h2d traffic
        st = s.stats()
        assert (st["cache_hits"], st["cache_misses"]) == (2, 4)
        assert st["h2d_bytes"] == moved

    def test_cohort_larger_than_cache_is_still_correct(self):
        """K' > cache_clients: every id resolves although insertion evicts
        earlier rows of the same cohort."""
        s = _host(k=8, cache_clients=2)
        s.load_stacked({"w": np.arange(48, dtype=np.float32).reshape(8, 2, 3),
                        "nest": {"b": np.arange(8, dtype=np.float32)}})
        ids = np.asarray([0, 1, 2, 3, 0])
        got = s.gather(ids)
        assert got["w"].shape == (5, 2, 3)
        np.testing.assert_array_equal(got["w"].numpy(), s.stacked()["w"][ids])
        np.testing.assert_array_equal(s.gather(ids)["nest"]["b"].numpy(), ids)

    def test_device_scatter_write_allocates_cache(self):
        s = _host(cache_clients=2)
        new = {"w": torch.zeros((1, 2, 3)), "nest": {"b": torch.tensor([1.0])}}
        s.scatter(np.asarray([5]), new)
        assert 5 in s._lru
        s.gather(np.asarray([5]))
        assert s.stats()["cache_hits"] == 1


class TestMmap:
    def test_mmap_roundtrip_on_disk(self, tmp_path):
        cfg = StoreConfig(kind="mmap", mmap_dir=str(tmp_path))
        s = make_store(cfg, _proto(), 6, "cpu")
        assert sorted(p.name for p in tmp_path.glob("*.mmap")) == ["nest.b.mmap", "w.mmap"]
        new = {"w": torch.full((2, 2, 3), 4.5), "nest": {"b": torch.tensor([1.0, 2.0])}}
        s.scatter(np.asarray([0, 5]), new)
        got = s.gather(np.asarray([5, 0, 3]))
        np.testing.assert_array_equal(got["nest"]["b"].numpy(), [2.0, 1.0, 0.5])
        # the bytes really live in the backing file
        s.stacked()  # flush
        disk = np.memmap(tmp_path / "w.mmap", dtype=np.float32, mode="r", shape=(6, 2, 3))
        np.testing.assert_array_equal(disk[0], 4.5 * np.ones((2, 3)))

    @pytest.mark.parametrize("kind", ["host", "device"])
    def test_shard_save_load_roundtrip(self, tmp_path, kind):
        s = make_store(StoreConfig(kind=kind, ckpt_shard_clients=3), _proto(), 10, "cpu")
        rng = np.random.RandomState(0)
        full = {"w": rng.randn(10, 2, 3).astype(np.float32),
                "nest": {"b": rng.randn(10).astype(np.float32)}}
        s.load_stacked(full)
        s.save_shards(tmp_path)
        assert len(list(tmp_path.glob("store_*.npz"))) == 4  # 3 + 3 + 3 + 1
        # a reader with ANOTHER shard granularity restores exactly
        r = make_store(StoreConfig(kind="host", ckpt_shard_clients=7), _proto(), 10, "cpu")
        r.load_shards(tmp_path)
        for a, b in zip(tree_leaves(r.stacked()), tree_leaves(full)):
            np.testing.assert_array_equal(_np(a), b)

    def test_shard_load_rejects_wrong_k_and_leaves(self, tmp_path):
        s = _host(k=4)
        s.save_shards(tmp_path)
        with pytest.raises(ValueError, match="clients"):
            _host(k=5).load_shards(tmp_path)
        other = make_store("host", {"z": torch.zeros(3)}, 4, "cpu")
        with pytest.raises(ValueError, match="leaves"):
            other.load_shards(tmp_path)

    def test_shard_files_equal_repro_s(self, tmp_path):
        """The same stack saves to the same shard files and manifest as
        ``repro``'s host store."""
        rng = np.random.RandomState(1)
        full = {"w": rng.randn(5, 2, 3).astype(np.float32),
                "nest": {"b": rng.randn(5).astype(np.float32)}}
        t = make_store(StoreConfig(kind="host", ckpt_shard_clients=2), _proto(), 5, "cpu")
        j = j_store.make_store(j_store.StoreConfig(kind="host", ckpt_shard_clients=2),
                               {"w": PROTO_W, "nest": {"b": np.float32(0.5)}}, 5)
        t.load_stacked(full)
        j.load_stacked(full)
        t.save_shards(tmp_path / "t")
        j.save_shards(tmp_path / "j")
        assert ((tmp_path / "t" / "store_manifest.json").read_text()
                == (tmp_path / "j" / "store_manifest.json").read_text())
        for i in range(3):
            a, b = (np.load(tmp_path / d / f"store_{i:05d}.npz") for d in ("t", "j"))
            assert sorted(a.files) == sorted(b.files)
            for f in a.files:
                np.testing.assert_array_equal(a[f], b[f])


class TestOffload:
    def test_host_store_offload_always_host(self):
        s = _host()
        x = torch.ones(3)
        out = s.offload({"x": x})
        assert isinstance(out["x"], np.ndarray)
        x.fill_(2.0)  # a copy, not a view of the tensor
        np.testing.assert_array_equal(out["x"], 1.0)

    def test_device_store_offload_respects_force(self):
        s = make_store(None, _proto(), 4, "cpu")
        x = torch.ones(3)
        assert s.offload({"x": x})["x"] is x
        host = s.offload({"x": x}, force_host=True)
        assert isinstance(host["x"], np.ndarray)


def test_fleet_data_gives_each_client_a_window_of_50():
    """The card phases' K = 1,000 fleet: client i holds samples 50 i mod
    19,950 onward, 40 to train and 10 to test."""
    labels = np.arange(20_000, dtype=np.int32)
    data = profile_store.fleet_data(np.zeros((20_000, 2, 2, 3), np.float32), labels)
    assert data.n_clients == 1000
    assert (data.train_counts == 40).all() and (data.test_counts == 10).all()
    for i in (0, 398, 399, 999):
        lo = (50 * i) % 19_950
        got = np.concatenate([data.train_idx[i], data.test_idx[i]])
        assert sorted(got.tolist()) == list(range(lo, lo + 50))


# -- across packages: one sequence of operations through both HostStores --


def _sequence(seed, k=10, steps=24):
    """A random sequence of ("gather", ids) and ("scatter", ids, rows, on
    the device?) operations: gathers of 1..6 ids with duplicates, scatters
    of distinct ids, a quarter of them host rows (offloaded results)."""
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(steps):
        n = int(rng.randint(1, 7))
        if rng.rand() < 0.5:
            ops.append(("gather", rng.randint(0, k, size=n)))
        else:
            ids = rng.choice(k, size=n, replace=False)
            rows = {"w": rng.randn(n, 2, 3).astype(np.float32),
                    "nest": {"b": rng.randn(n).astype(np.float32)}}
            ops.append(("scatter", ids, rows, bool(rng.rand() < 0.75)))
    return ops


def _run_both(seed, cache):
    k = 10
    t = make_store(StoreConfig(kind="host", cache_clients=cache), _proto(), k, "cpu")
    j = j_store.make_store(j_store.StoreConfig(kind="host", cache_clients=cache),
                           {"w": PROTO_W, "nest": {"b": np.float32(0.5)}}, k)
    for op in _sequence(seed, k):
        if op[0] == "gather":
            got, want = t.gather(op[1]), j.gather(op[1])
            for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
                assert np.array_equal(a.numpy(), np.asarray(b)), (seed, cache, op)
        else:
            _, ids, rows, on_device = op
            if on_device:
                t.scatter(ids, tree_map(torch.from_numpy, rows))
                j.scatter(ids, jax.tree.map(jnp.asarray, rows))
            else:
                t.scatter(ids, rows)
                j.scatter(ids, jax.tree.map(np.copy, rows))
    for a, b in zip(tree_leaves(t.stacked()), jax.tree.leaves(j.stacked())):
        assert np.array_equal(a, b), (seed, cache)
    assert t.stats() == j.stats(), (seed, cache)
    return t.stats()


@pytest.mark.parametrize("cache", [0, 3])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_host_store_equals_repro_on_one_sequence(seed, cache):
    stats = _run_both(seed, cache)
    if cache:  # the sequences really exercise the cache
        assert stats["cache_hits"] and stats["cache_evictions"], stats


@settings(max_examples=12, deadline=None)
@given(seed=hst.integers(0, 2**31 - 1), cache=hst.sampled_from([0, 1, 3, 6]))
def test_host_store_equals_repro_on_drawn_sequences(seed, cache):
    _run_both(seed, cache)


# -- federations -------------------------------------------------------------


@pytest.fixture(scope="module")
def fed_setup():
    """``tests/test_cohort_store.py``'s parity setup: SMALL_CNN, 400
    samples, K = 8, Dir(0.3).  Each package gets its own partition
    (``from_partition`` shuffles its inputs in place, ROADMAP.md R4)."""
    images, labels = make_class_conditional_images(400, 10, 16, seed=0)
    parts = lambda: dirichlet_partition(labels, 8, alpha=0.3, seed=0)
    jp = jax.jit(j_cnn.init_params, static_argnums=1)(jax.random.PRNGKey(0), J_CFG)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return {
        "j": (JData.from_partition(images, labels, parts(), seed=0), jp,
              lambda p, b: j_cnn.loss_fn(p, J_CFG, b),
              j_masked_accuracy(lambda p, t: j_cnn.apply(p, J_CFG, t["images"]))),
        "t": (TData.from_partition(images, labels, parts(), seed=0), tp,
              lambda p, b: t_cnn.loss_fn(p, T_CFG, b),
              masked_accuracy(lambda p, t: t_cnn.apply(p, T_CFG, t["images"]))),
    }


MODES = {  # mode -> AsyncConfig (None: the sync driver)
    "sync": None,
    "async": AsyncConfig(buffer_size=4, concurrency=4),
    "async_hetero": AsyncConfig(buffer_size=2, availability=HETERO),
}


def _store(name, tmp_path):
    return {"device": "device", "host": "host",
            "mmap": StoreConfig(kind="mmap", mmap_dir=str(tmp_path / "mm")),
            "host+cache": StoreConfig(kind="host", cache_clients=3)}[name]


def _t_fed(fed_setup, mode, store, rounds=3, **kw):
    data, params, loss, acc = fed_setup["t"]
    cfg = FLRunConfig(n_clients=8, participation=0.5, rounds=rounds, batch=8,
                      local_iters=2, seed=1, store=store, **kw)
    if MODES[mode] is None:
        return Federation(t_bl.PFedSOP(), loss, acc, params, data, cfg, device="cpu")
    return AsyncFederation(t_bl.PFedSOP(), loss, acc, params, data, cfg, MODES[mode],
                           device="cpu")


def _final_rows(fed):
    return [_np(x) for x in tree_leaves(fed.client_states)]


@pytest.fixture(scope="module")
def device_runs(fed_setup):
    """The device store's history and final rows in each mode."""
    out = {}
    for mode in MODES:
        fed = _t_fed(fed_setup, mode, "device")
        out[mode] = (fed.run(), _final_rows(fed))
    return out


@pytest.mark.parametrize("store", ["host", "mmap", "host+cache"])
@pytest.mark.parametrize("mode", list(MODES))
def test_every_store_gives_the_device_store_s_run_bitwise(fed_setup, device_runs, tmp_path,
                                                          mode, store):
    fed = _t_fed(fed_setup, mode, _store(store, tmp_path))
    hist = fed.run()
    want, rows = device_runs[mode]
    for key in ("loss", "acc", "sim_time", "mean_best_acc") + (
            ("staleness",) if mode != "sync" else ()):
        assert hist[key] == want[key], (key, hist[key], want[key])
    got = _final_rows(fed)
    assert all(isinstance(a, np.ndarray) for a in tree_leaves(fed.client_states))
    assert len(got) == len(rows) and all(np.array_equal(a, b) for a, b in zip(got, rows))
    st = fed.store.stats()
    assert st["gathers"] > 0 and st["scatters"] > 0
    assert st["h2d_bytes"] > 0 and st["d2h_bytes"] > 0
    if store == "host+cache":
        assert st["cache_misses"] > 0 and (st["cache_hits"] > 0 or mode == "async_hetero")
    if mode == "async_hetero":
        assert any(hist["staleness"])


def _j_fed(fed_setup, mode, rounds=3):
    data, params, loss, acc = fed_setup["j"]
    cfg = JRunConfig(n_clients=8, participation=0.5, rounds=rounds, batch=8, local_iters=2,
                     seed=1, store="host")
    if mode == "sync":
        return JFederation(j_bl.PFedSOP(), loss, acc, params, data, cfg)
    return JAsync(j_bl.PFedSOP(), loss, acc, params, data, cfg,
                  JAsyncConfig(buffer_size=2, availability=J_HETERO))


@pytest.mark.parametrize("mode", ["sync", "async_hetero"])
def test_host_store_history_matches_repro_s_host_store(fed_setup, mode):
    j_fed = _j_fed(fed_setup, mode)
    j_hist = j_fed.run()
    t_fed = _t_fed(fed_setup, mode, "host")
    t_hist = t_fed.run()
    np.testing.assert_allclose(t_hist["loss"], j_hist["loss"], rtol=1e-5)
    if mode == "sync":
        np.testing.assert_allclose(t_hist["acc"], j_hist["acc"], rtol=0, atol=1e-6)
    else:
        assert t_hist["sim_time"] == j_hist["sim_time"]
        assert t_hist["staleness"] == j_hist["staleness"]
        np.testing.assert_allclose(t_hist["acc"], j_hist["acc"], rtol=1e-5)
    # both stores moved the same rows: the same counters
    assert t_fed.store.stats() == j_fed.store.stats()
    assert isinstance(t_fed.client_states.params, np.ndarray)


@pytest.mark.parametrize("store", ["host", "host+cache"])
def test_async_resume_on_the_host_store_is_bitwise(fed_setup, tmp_path, store):
    """Run to version 4 against run to 2, save, restore into a fresh driver
    and run on; the checkpoint holds in-flight (host) results."""
    full = _t_fed(fed_setup, "async_hetero", _store(store, tmp_path), rounds=4).run()
    ck = str(tmp_path / "ck")
    _t_fed(fed_setup, "async_hetero", _store(store, tmp_path), rounds=2, ckpt_every=2,
           ckpt_dir=ck).run()
    fed = _t_fed(fed_setup, "async_hetero", _store(store, tmp_path), rounds=4,
                 ckpt_every=2, ckpt_dir=ck)
    assert fed.restore() == 2
    assert fed._pending and all(isinstance(x, (np.ndarray, np.generic))
                                for it in fed._pending.values()
                                for x in tree_leaves(it["state"]))
    resumed = fed.run()
    for key in ("loss", "acc", "sim_time", "staleness", "mean_best_acc"):
        assert resumed[key] == full[key], key


# A fresh process: the first training call of a process is where a lazy
# import once left a reference cycle through the caller's frames.
_LIFETIME = """
import gc, weakref, torch
torch.set_num_threads(1)
from repro_torch.configs.resnet_cifar import SMALL_CNN as cfg
from repro_torch.core.baselines import PFedSOP
from repro_torch.data import FederatedData, dirichlet_partition, make_class_conditional_images
from repro_torch.fl import Federation, FLRunConfig, masked_accuracy
from repro_torch.models import cnn

def make():
    images, labels = make_class_conditional_images(160, 10, 16, seed=0)
    data = FederatedData.from_partition(
        images, labels, dirichlet_partition(labels, 4, 0.3, seed=0), seed=0)
    params = cnn.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    fed = Federation(PFedSOP(), lambda p, b: cnn.loss_fn(p, cfg, b),
                     masked_accuracy(lambda p, t: cnn.apply(p, cfg, t["images"])), params,
                     data, FLRunConfig(n_clients=4, rounds=1, seed=0, participation=0.5,
                                       batch=8, local_iters=1), device="cpu")
    fed.run()
    return fed

gc.disable()
for i in range(2):
    fed = make()
    refs = weakref.ref(fed), weakref.ref(fed.store)
    del fed
    assert [r() is None for r in refs] == [True, True], ("alive after del", i)
    gc.collect()
    assert [r() is None for r in refs] == [True, True], ("alive after gc.collect", i)
print("dead")
"""


def test_a_finished_federation_dies_with_its_last_reference():
    """The first and the second federation of a process, and their device
    stores, are freed by ``del`` alone (the cyclic collector off), and stay
    freed after one ``gc.collect()``: nothing holds a finished run."""
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", _LIFETIME], capture_output=True, text=True,
                         timeout=300, cwd=root,
                         env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert out.returncode == 0 and out.stdout.strip() == "dead", out.stderr[-3000:]
