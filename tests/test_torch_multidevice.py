"""The multi-device federation engines over ``torch.distributed`` (gloo,
one process per rank on the CPU, ``tests/torch_dist_workers.py``), at
world sizes 2, 4 and 8.

- Bitwise: ``cohort_mean``/``cohort_sum`` over 2, 4 and 8 client shards
  against the unsharded halving tree; the model-sharded update
  (``pfedsop_update_batched_sharded``) at m = 2 .. 8 against
  ``pfedsop_update_batched`` (ragged N, per-client d_g, bf16, C = 1);
  ``output_sharding="sharded"`` against ``"replicated"`` and the host store
  against the device store, per backend and layout; a model-split mesh
  whose ranks each hold the whole cohort (``pods:1x1x2``) against the vmap
  history; every rank's final state against rank 0's.
- Bitwise against the port's ``VmapBackend`` history, also where the
  ranks split the cohort (2 + 2 clients against one vmap of 4): every
  backend maps its clients one at a time (``fl/engine.py``'s
  ``_run_vmap``), so a client's numbers do not depend on how many
  clients share its rank.
- Async on ``pods:2x1x1`` (two pods, each draining its own completions):
  its dispatches, versions, ``sim_time`` and staleness exactly those of
  the port's driver on ``repro``'s ``RoundScheduler(n_pods=2)`` over
  ``repro``'s availability model (both numpy, seeded alike).
- The CLI under ``torchrun`` at 4 ranks (``pods:2x1x2``).
- The data split of the gradient chunks (each data rank computes one
  chunk and gathers the others in rank order), bitwise against the
  in-body chunks at ``grad_chunks`` 2: the CNN's pfedsop and fedavg on
  ``pods:1x2x1`` against the vmap history, and pfedsop on ``pods:2x2x2``
  (world 8) against ``pods:2x1x2`` (world 4: the same 2 + 2 client split),
  replicated and sharded; the LM train step (``launch/steps.py``) on
  ``pods:1x2x1``.  The LM step on ``pods:2x1x1`` (one client a rank) and
  ``pods:1x1x2`` (the round start on tile ranges) bitwise the engine-less
  step; a batch the data size does not divide takes the in-body path.

Each world is one spawn (a module fixture) that runs all of its cases.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_async_federation import HETERO as J_HETERO
from torch_dist_workers import everything, federation, final, record_dispatches, spawn

from repro.fl.availability import make_availability as j_make_availability
from repro.fl.scheduler import RoundScheduler as JRoundScheduler
from repro_torch.fl import AsyncConfig, AvailabilityConfig, StoreConfig

SRC = Path(__file__).resolve().parents[1] / "src"
ASYNC = dict(mesh="pods:2x1x1", buffer=2, rounds=4, avail=dataclasses.asdict(J_HETERO))
STORES = {"device": None, "host": "host"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _runs(layouts, methods, tmp):
    """(label, method, FLRunConfig kwargs) for every layout x output
    sharding x store x method; the host stores' memmaps go under ``tmp``."""
    runs = []
    for lname, kw in layouts.items():
        for out in ("replicated", "sharded"):
            for sname, store in STORES.items():
                for m in methods:
                    st = store and StoreConfig(kind=store, mmap_dir=str(tmp / f"{lname}{out}{m}"))
                    runs.append((f"{lname}/{out}/{sname}/{m}", m,
                                 dict(kw, output_sharding=out, store=st)))
    return runs


@pytest.fixture(scope="module")
def vmap_refs():
    """The port's vmap histories: (history, rows, broadcast) per method."""
    refs = {m: final(federation(m)) for m in ("pfedsop", "fedavg", "fedexp")}
    refs["pfedsop/chunks2"] = final(federation("pfedsop", grad_chunks=2))
    refs["fedavg/chunks2"] = final(federation("fedavg", grad_chunks=2))
    return refs


def _data_runs(mesh, methods, **kw):
    """(label, method, kwargs) at ``grad_chunks`` 2 on ``mesh``, replicated
    and sharded; labels ``<mesh>/<output>/chunks2/<method>``."""
    return [(f"{mesh}/{out}/chunks2/{m}", m,
             dict(backend="mesh", mesh=mesh, grad_chunks=2, output_sharding=out, **kw))
            for out in ("replicated", "sharded") for m in methods]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("w2")
    sync = _runs({"shard_map": dict(backend="shard_map")}, ("pfedsop", "fedavg"), tmp)
    sync += [("pods:1x1x2/pfedsop", "pfedsop", dict(backend="mesh", mesh="pods:1x1x2")),
             ("shard_map/chunks2", "pfedsop", dict(backend="shard_map", grad_chunks=2))]
    sync += _data_runs("pods:1x2x1", ("pfedsop", "fedavg"))
    return spawn(everything, 2, {"layout": True, "lm": True, "sync": sync, "async": ASYNC})


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("w4")
    sync = _runs({"pods:2x1x2": dict(backend="mesh", mesh="pods:2x1x2")}, ("pfedsop",), tmp)
    sync += [("pods:2x1x2/sharded/host/fedexp", "fedexp",
              dict(backend="mesh", mesh="pods:2x1x2", output_sharding="sharded",
                   store=StoreConfig(kind="mmap", mmap_dir=str(tmp / "fedexp")))),
             ("pods:2x1x2/replicated/device/fedexp", "fedexp",
              dict(backend="mesh", mesh="pods:2x1x2"))]
    # the in-body chunks on world 8's client split, for its data split
    sync += _data_runs("pods:2x1x2", ("pfedsop",), rounds=1)
    return spawn(everything, 4, {"sync": sync})


@pytest.fixture(scope="module")
def world8():
    sync = [(f"pods:2x2x2/{out}", "pfedsop",
             dict(backend="mesh", mesh="pods:2x2x2", output_sharding=out, rounds=1))
            for out in ("replicated", "sharded")]
    sync.append(("shard_map/auto", "pfedsop", dict(backend="shard_map", rounds=1)))
    sync += _data_runs("pods:2x2x2", ("pfedsop",), rounds=1)
    return spawn(everything, 8, {"sync": sync})


WORLDS = {2: "world2", 4: "world4", 8: "world8"}


def _world(request, n):
    return request.getfixturevalue(WORLDS[n])


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_reduce_and_update_are_bitwise(request, n):
    res = _world(request, n)
    checks = {r["reduce_update"]["checks"] for r in res}
    # 3 reductions, and 4 update cases at every m in 2..n on rank 0
    assert res[0]["reduce_update"]["checks"] == 3 + 4 * (n - 1)
    assert min(checks) >= 3
    census = res[0]["reduce_update"]["census"]
    assert census["all-gather"]["count"] > 0 and census["all-reduce"]["count"] > 0


def test_model_sharded_leaves_gather_back_bitwise(world2):
    assert [r["layout"] for r in world2] == [True, True]


def _same(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)


def _drift(got, want):
    """The largest difference over the final client rows and broadcast."""
    return max(float(np.max(np.abs(x.astype(np.float64) - y.astype(np.float64))))
               for x, y in zip(got[1] + got[2], want[1] + want[2]))


def _close(got, want, name):
    """The port's history tolerance, on the parameters the history tests
    hold: pFedSOP's client rows, the FedAvg family's broadcast (the deltas
    divide by eta2 = 0.01, so they carry 100x the parameters' error)."""
    (hg, rows_g, bc_g), (hw, rows_w, bc_w) = got, want
    np.testing.assert_allclose(hg["loss"], hw["loss"], rtol=1e-5)
    np.testing.assert_allclose(hg["acc"], hw["acc"], rtol=0, atol=1e-6)
    assert hg["sim_time"] == hw["sim_time"]
    got_p, want_p = (rows_g[0], rows_w[0]) if name == "pfedsop" else (bc_g[0], bc_w[0])
    np.testing.assert_allclose(got_p, want_p, atol=1e-5)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_every_rank_ends_with_rank_0_s_state(request, n):
    for label in _world(request, n)[0]["sync"]:
        digests = [r["sync"][label][1] for r in _world(request, n)]
        assert all(d == digests[0] for d in digests), label


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_outputs_and_host_stores_are_bitwise(request, n):
    sync = {k: v[0] for k, v in _world(request, n)[0]["sync"].items()}
    groups = {}
    for label, (h, rows, bc, _) in sync.items():
        parts = label.split("/")
        if len(parts) == 4:  # layout/output/store (or chunks2)/method
            groups.setdefault((parts[0], parts[2] == "chunks2", parts[3]), []).append(
                (label, h, rows, bc))
    if n == 8:
        (h1, r1, b1, _), (h2, r2, b2, _) = (sync["pods:2x2x2/replicated"],
                                            sync["pods:2x2x2/sharded"])
        groups[("pods:2x2x2", False, "pfedsop")] = [("r", h1, r1, b1), ("s", h2, r2, b2)]
    assert groups
    for key, runs in groups.items():
        _, h0, r0, b0 = runs[0]
        for label, h, rows, bc in runs[1:]:
            assert h == h0 and _same(rows, r0) and _same(bc, b0), (key, label)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_mesh_history_against_vmap(request, n, vmap_refs):
    """Bitwise, where the ranks split the cohort and where every rank
    vmaps the whole cohort."""
    sync = {k: v[0] for k, v in _world(request, n)[0]["sync"].items()}
    for label, (h, rows, bc, census) in sync.items():
        if "chunks2" in label:
            continue
        name = label.rsplit("/", 1)[-1] if label.count("/") == 3 else "pfedsop"
        if n == 8:  # one round: compare with the first round of the reference
            hw, rows_w, bc_w = final(federation(name, rounds=1))
            want = (hw, rows_w, bc_w)
        else:
            want = vmap_refs[name]
        _close((h, rows, bc), want, name)
        assert census.get("all-gather", {}).get("count", 0) > 0, label
        assert h == want[0] and _same(rows, want[1]) and _same(bc, want[2]), label
        assert _drift((h, rows, bc), want) == 0, label  # 2 + 2 clients is 4


def test_grad_chunks_over_ranks_against_vmap(world2, vmap_refs):
    h, rows, bc, _ = world2[0]["sync"]["shard_map/chunks2"][0]
    _close((h, rows, bc), vmap_refs["pfedsop/chunks2"], "pfedsop")
    # two chunks are another gradient than one (in the last bits)
    assert not np.array_equal(rows[0], vmap_refs["pfedsop"][1][0])


@pytest.mark.parametrize("n", [2, 8])
def test_data_split_is_bitwise_the_in_body_chunks(request, n, vmap_refs):
    """pods:1x2x1 against the vmap history at grad_chunks 2 (every rank
    vmaps the whole cohort); pods:2x2x2 against pods:2x1x2 (the same 2 + 2
    client split, chunks in the body); replicated and sharded, every rank
    on the data split, the in-body runs on none."""
    res = _world(request, n)
    methods = ("pfedsop", "fedavg") if n == 2 else ("pfedsop",)
    mesh = "pods:1x2x1" if n == 2 else "pods:2x2x2"
    for out in ("replicated", "sharded"):
        for m in methods:
            label = f"{mesh}/{out}/chunks2/{m}"
            assert [r["sync"][label][2] for r in res] == [True] * n, label
            h, rows, bc, census = res[0]["sync"][label][0]
            if n == 2:
                want = vmap_refs[f"{m}/chunks2"]
            else:
                body = request.getfixturevalue("world4")
                in_body = f"pods:2x1x2/{out}/chunks2/{m}"
                assert [r["sync"][in_body][2] for r in body] == [False] * 4
                want = body[0]["sync"][in_body][0][:3]
            assert h == want[0] and _same(rows, want[1]) and _same(bc, want[2]), label
            assert census["all-gather"]["count"] > 0


def test_lm_step_data_split_is_bitwise_the_in_body_chunks(world2):
    for r in world2:
        lm = r["lm"]
        same, census, split = lm["data"]
        assert lm["chunks_differ"]  # two chunks are another gradient than one
        assert same and split is True
        # a step gathers the loss and every gradient leaf: 2 clients x 2 steps
        assert census["all-gather"]["count"] % 4 == 0 and "all-reduce" not in census


def test_lm_step_on_pods_and_model_split_is_bitwise_the_engine_less_step(world2):
    for r in world2:
        lm = r["lm"]
        same, census, _ = lm["pods"]  # this rank's client; Eq. 13 over the ranks
        assert same and census["all-gather"]["count"] > 0
        same, census, _ = lm["model"]  # the round start on tile ranges
        assert same and census["all-reduce"]["count"] == 2  # one a client
        assert census["all-gather"]["count"] == 2


def test_lm_step_takes_the_in_body_path_on_a_batch_the_data_size_does_not_divide(world2):
    for r in world2:
        same, census, split = r["lm"]["in_body"]
        assert same and split is False and census == {}


def test_async_on_two_pods_follows_repro_s_scheduler(world2):
    (log, hist, n_pods, engine), _ = world2[0]["async"]
    assert n_pods == 2 and engine["n_pods"] in (1, 2)
    assert len({r["async"][1] for r in world2}) == 1  # every rank's final rows
    # the same event loop on repro's two-pod scheduler, on one device
    acfg = AsyncConfig(buffer_size=ASYNC["buffer"],
                       availability=AvailabilityConfig(**ASYNC["avail"]))
    fed = federation("pfedsop", rounds=ASYNC["rounds"], mode="async", async_cfg=acfg)
    j_avail = j_make_availability(J_HETERO, fed.cfg.n_clients, fed.cfg.seed)
    fed.availability = j_avail
    fed.scheduler = JRoundScheduler(j_avail, fed.concurrency, n_pods=2)
    fed.n_pods = 2
    want_log = record_dispatches(fed)
    want = fed.run()
    assert log == want_log
    assert len(hist["loss"]) == len(want["loss"]) == ASYNC["rounds"]
    assert hist["sim_time"] == want["sim_time"]
    assert hist["staleness"] == want["staleness"]
    assert any(len(ids) > 1 for _, ids in log)
    np.testing.assert_allclose(hist["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(hist["acc"], want["acc"], rtol=0, atol=1e-6)


def test_cli_under_torchrun(tmp_path):
    env = {**os.environ, "PYTHONPATH": f"{SRC}{os.pathsep}{os.environ.get('PYTHONPATH', '')}",
           "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.train_federated",
           "--device", "cpu", "--backend", "mesh", "--mesh", "pods:2x1x2",
           "--output-sharding", "sharded", "--methods", "pfedsop", "--rounds", "1",
           "--samples", "200", "--clients", "8", "--participation", "0.5",
           "--local-iters", "1", "--image-size", "8"]
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.count("dataset:") == 1  # rank 0 speaks for the group
    written = list((tmp_path / "experiments" / "fl").glob("*.json"))
    assert len(written) == 1
