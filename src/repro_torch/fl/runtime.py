"""Federation runtime: the synchronous round loop, its history, and the
checkpoint core both drivers share.

Port of ``repro/fl/runtime.py``, over any engine of ``fl/engine.py``:
``VmapBackend`` on one device, or ``ShardMapBackend``/``MeshBackend`` over
the ranks of a ``torch.distributed`` group, where every rank runs this
driver on the same host sampling and takes its part of each phase; only
rank 0 prints, traces and writes checkpoints.  Per-client state
lives at rest as ``(K, ...)``-stacked flat rows in the cohort store
(``fl.cohort_store``: on the device, in host RAM or in memmaps, with an
optional LRU device cache); each round the K' participants are gathered, the
method's cohort step (``round_start``: pFedSOP's batched kernel launch
pair) and its mapped one-client phase run, per-client eval runs on the
pre-update broadcast, uploads are aggregated and the new rows scattered
back.  ``RoundPrograms`` holds these phases, with one engine per cohort
size (the async driver's micro-cohorts may fall back to another split);
the asynchronous driver
(``repro_torch.fl.async_``) runs the same phases on its micro-cohorts,
which is what makes its degenerate configuration equal to this driver
bit for bit.

Sampling (participation + local SGD batches + test sets) is host numpy
on one ``RandomState(seed)`` consumed in ``repro``'s order, so the cohort
ids are bitwise those of ``repro`` at the same seed.  Every entry point
runs on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.core.baselines import FLMethod
from repro_torch.core.pfedsop import theta_from_beta
from repro_torch.data.federated import FederatedData
from repro_torch.fl.cohort_store import make_store
from repro_torch.fl.engine import make_engine
from repro_torch.kernels.dispatch import check_impl_name, grad_chunk_count
from repro_torch.launch import collectives
from repro_torch.obs import ObsConfig, make_obs
from repro_torch.optim.reduce import is_pow2
from repro_torch.utils.checkpoint import (
    load_checkpoint,
    read_manifest,
    restore_rng_state,
    rng_state_tree,
    save_checkpoint,
)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import FlatLayout, tree_leaves, tree_map

_METHOD_INTERFACE = tuple(
    a for a, v in vars(FLMethod).items() if callable(v) and not a.startswith("_")
)
# the staleness hook is called by the async driver alone: a sync-only
# method may omit it (AsyncFederation validates with the hook)
_SYNC_METHOD_INTERFACE = tuple(a for a in _METHOD_INTERFACE if a != "server_update_stale")


def validate_method(method, require_stale_hook: bool = False) -> None:
    """Fail fast on a method missing part of the ``FLMethod`` contract;
    ``server_update_stale`` only with ``require_stale_hook`` (async)."""
    interface = _METHOD_INTERFACE if require_stale_hook else _SYNC_METHOD_INTERFACE
    missing = [a for a in interface if not callable(getattr(method, a, None))]
    if missing or not isinstance(getattr(method, "name", None), str):
        raise TypeError(
            f"{type(method).__name__} does not implement the FLMethod "
            f"interface (missing/uncallable: {missing or ['name']}); see "
            "repro_torch.core.baselines.FLMethod")


def override_update_impl(method, impl: str):
    """Push a run-level update-impl choice into the method's ``cfg``;
    a method without the knob is an error, never a silent no-op."""
    check_impl_name(impl, "pfedsop_update")
    cfg = getattr(method, "cfg", None)
    if cfg is None or not dataclasses.is_dataclass(cfg) or not hasattr(cfg, "update_impl"):
        raise ValueError(
            f"method {getattr(method, 'name', type(method).__name__)!r} has no "
            "update_impl knob; unset FLRunConfig.update_impl")
    return dataclasses.replace(method, cfg=dataclasses.replace(cfg, update_impl=impl))


def bind_layout(method, layout: FlatLayout):
    """Hand the federation's ``FlatLayout`` to a method that reads leaf
    paths (FedRep's head mask): a dataclass field ``layout`` left None."""
    if (dataclasses.is_dataclass(method)
            and any(f.name == "layout" for f in dataclasses.fields(method))
            and method.layout is None):
        return dataclasses.replace(method, layout=layout)
    return method


@dataclass(frozen=True)
class FLRunConfig:
    """Federation-level run parameters (method hyperparameters live on the
    method object, e.g. ``PFedSOPConfig``)."""

    n_clients: int = 100
    participation: float = 0.2  # 20% per round (paper Sec. V-B4)
    rounds: int = 100
    batch: int = 50
    local_iters: int = 0  # 0 = one-local-epoch equivalent (mean client size)
    seed: int = 0
    backend: str = "vmap"  # repro_torch.fl.engine.BACKENDS
    # round-start update impl override ("" = the method's own config)
    update_impl: str = ""
    # where the (K, ...)-stacked client states live at rest: None/"device"
    # (resident on the device), "host" (numpy, participants gathered to the
    # device each round), "mmap" (disk-backed memmaps), or a
    # repro_torch.fl.cohort_store.StoreConfig for the cache and threshold
    # knobs; every store gives the device store's history bit for bit
    store: Any = None
    # checkpoint the whole driver state every ``ckpt_every`` applied server
    # updates into ``ckpt_dir`` (0/"" = off); restart with ``restore``
    ckpt_every: int = 0
    ckpt_dir: str = ""
    # the async driver's ``repro_torch.fl.async_.AsyncConfig`` (the sync
    # driver ignores it)
    async_cfg: Any = None
    # observability: None (off: the shared NOOP facade), a
    # ``repro_torch.obs.ObsConfig`` or a kwargs dict for one; not part of
    # the checkpoint fingerprint
    obs: Any = None
    # backend="shard_map" only: client shards, 0 = auto (largest divisor of
    # K' that divides the world size)
    shards: int = 0
    # backend="mesh" only: a launch.mesh.parse_mesh spec ("pods:PxDxM", ...)
    mesh: str = ""
    # "replicated": the client phase's outputs are all-gathered to every
    # rank; "sharded" (the mesh engines, at a power-of-two split): uploads
    # stay rank-local into the engine's aggregate_phase, which reduces them
    # in rank order, bitwise the replicated result; a layout knob, not in
    # the checkpoint fingerprint
    output_sharding: str = "replicated"
    # each SGD step's gradient is the halving-tree mean over this many
    # equal batch chunks (optim.sgd.chunked_value_and_grad); it changes the
    # numbers, so it is in the checkpoint fingerprint
    grad_chunks: int = 1


def _rows(tree) -> int:
    return int(tree_leaves(tree)[0].shape[0])


class RoundPrograms:
    """The per-phase round programs: client phase (cohort step + mapped
    one-client phase), the round-boundary all-gather, per-client eval,
    server aggregation (plain, sharded and staleness-weighted).  PyTorch
    runs eagerly, so nothing is compiled; the engine is built once per
    cohort size (``engine``), and ``seen_cohorts`` records the sizes the
    client phase ran at.

    ``strict_shards=False`` (the async driver) lets a micro-cohort that an
    explicitly requested split does not divide fall back: to the largest
    dividing shard count on the 1-D client mesh, to an unsharded client
    axis on a multi-pod mesh."""

    def __init__(self, method, loss_fn, acc_fn, backend: str = "vmap",
                 shards: int = 0, mesh: str = "", strict_shards: bool = True,
                 output_sharding: str = "replicated", grad_chunks: int = 1):
        self.method = method
        self.loss_fn = loss_fn
        self.acc_fn = acc_fn
        self.backend = backend
        self.shards = shards
        self.mesh = mesh
        self.strict_shards = strict_shards
        self.output_sharding = output_sharding
        self.grad_chunks = grad_chunks
        self._engines: Dict[int, Any] = {}
        self._shardings: Dict[int, Any] = {}
        self._seen = set()

    def seen_cohorts(self):
        """Cohort sizes the client phase ran at (sorted)."""
        return sorted(self._seen)

    def engine(self, cohort: int):
        eng = self._engines.get(cohort)
        if eng is None:
            eng = make_engine(self.backend, cohort, self.shards, mesh=self.mesh,
                              strict=self.strict_shards, data_chunks=self.grad_chunks)
            self._engines[cohort] = eng
        return eng

    def sharded_outputs(self, cohort: int) -> bool:
        """Whether this cohort's round keeps its outputs rank-local into
        the sharded aggregation: the run asked for it, the engine lays its
        outputs over the client group, and the split is a power of two
        (the halving tree's boundary condition).  Other cohorts take the
        replicated path, bitwise the same."""
        if self.output_sharding != "sharded":
            return False
        eng = self.engine(cohort)
        return bool(getattr(eng, "laid_out", False)) and is_pow2(eng.client_shards)

    def input_shardings(self, cohort: int, struct):
        """The engine's at-rest placement of a gathered cohort (None on
        vmap), for the store's gather; ``struct`` is any cohort-stacked tree
        of the state's structure and shapes."""
        if cohort not in self._shardings:
            self._shardings[cohort] = self.engine(cohort).input_shardings(struct)
        return self._shardings[cohort]

    def client(self, gathered_states, broadcast, batches, shardings=None):
        """-> (new_states, uploads, metrics): this rank's rows on a mesh
        engine (``replicate_fn`` makes them whole), all K' on vmap.
        ``gathered_states`` are at rest as ``shardings`` lays them out."""
        method, loss_fn = self.method, self.loss_fn
        cohort = _rows(batches)
        self._seen.add(cohort)

        def one_client(state, broadcast_, batch_seq):
            return method.client_round(loss_fn, state, broadcast_, batch_seq)

        with grad_chunk_count(self.grad_chunks):
            return self.engine(cohort).client_phase_sharded(
                one_client, gathered_states, broadcast, batches,
                cohort_step=method.round_start, shardings=shardings)

    def replicate_fn(self, cohort: int):
        """The round-boundary all-gather (None on vmap, whose outputs are
        born whole, and under the sharded round loop)."""
        if self.sharded_outputs(cohort):
            return None
        return getattr(self.engine(cohort), "replicate", None)

    def eval(self, states, broadcast, test_sets):
        """-> per-client accuracies (K',) on every rank."""
        method, acc_fn = self.method, self.acc_fn

        def one_eval(state, broadcast_, test):
            return acc_fn(method.eval_params(state, broadcast_), test)

        return self.engine(_rows(test_sets)).eval_phase(one_eval, states, broadcast,
                                                         test_sets)

    def aggregate(self, broadcast, uploads, cohort=None):
        """The method's ``server_update``; over rank-local uploads through
        the engine's ``aggregate_phase`` when ``cohort`` runs the sharded
        round loop."""
        if cohort is not None and self.sharded_outputs(cohort):
            return self.engine(cohort).aggregate_phase(self.method.server_update,
                                                       broadcast, uploads)
        return self.method.server_update(broadcast, uploads)

    def aggregate_stale(self, broadcast, uploads, staleness):
        return self.method.server_update_stale(broadcast, uploads, staleness)


_HISTORY_KEYS = ("loss", "acc", "round_time", "sim_time")

# metric-histogram bucket edges (repro's): theta over Eq. 14's domain
# [0, pi] in pi/8 steps; beta and loss in fixed decades
_THETA_EDGES = tuple(i * np.pi / 8 for i in range(1, 8))
_BETA_EDGES = tuple(i / 10 for i in range(1, 10))
_LOSS_EDGES = (0.01, 0.03, 0.1, 0.3, 1.0, 2.0, 3.0, 5.0, 10.0)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Federation:
    """Drives ``rounds`` FL rounds of ``method`` over ``data`` on ``device``.

    ``init_params`` is a parameter tree (e.g. ``models.cnn.init_params``);
    ``loss_fn(params, batch)`` and ``acc_fn(params, test)`` take such a
    tree.  The federation flattens it once into the ``FlatLayout`` leaf
    order and hands the model per-leaf views of each client's flat row.
    ``device`` defaults to the card and raises without one; a CPU run
    passes ``device="cpu"``.

    ``availability`` (optional, ``repro_torch.fl.availability``) drives the
    simulated clock only: the bulk-synchronous server samples obliviously
    and waits for every sampled client, so a round advances ``sim_time``
    by ``availability.sync_round_duration``; without a model by 1.0.  It
    draws from its own seeded streams and never touches the numerics.
    ``AsyncFederation`` subclasses this driver.
    """

    def __init__(self, method, loss_fn: Callable, acc_fn: Callable,
                 init_params, data: FederatedData, run_cfg: FLRunConfig,
                 availability=None, device="cuda"):
        if availability is not None and not callable(
                getattr(availability, "sync_round_duration", None)):
            raise TypeError(
                f"availability must be a repro_torch.fl.availability model "
                f"(with sync_round_duration), got {type(availability).__name__}")
        self._init_core(method, loss_fn, acc_fn, init_params, data, run_cfg, device)
        self.availability = availability
        self._obs_open()

    _strict_shards = True

    def _init_core(self, method, loss_fn, acc_fn, init_params, data, run_cfg, device):
        self.device = resolve_device(device)
        validate_method(method)
        if run_cfg.output_sharding not in ("replicated", "sharded"):
            raise ValueError(f"unknown output_sharding {run_cfg.output_sharding!r}; "
                             "choose 'replicated' or 'sharded'")
        if run_cfg.output_sharding == "sharded" and run_cfg.backend == "vmap":
            raise ValueError(
                "output_sharding='sharded' is the mesh engines' layout opt-out "
                "(backend='shard_map'/'mesh'); vmap outputs are born whole, so "
                "the request would be silently ignored")
        if run_cfg.grad_chunks < 1:
            raise ValueError(f"grad_chunks must be >= 1, got {run_cfg.grad_chunks}")
        if run_cfg.update_impl:
            method = override_update_impl(method, run_cfg.update_impl)
        k = run_cfg.n_clients
        if data.n_clients != k:
            raise ValueError(f"data has {data.n_clients} clients, run_cfg {k}")
        self.layout = layout = FlatLayout(init_params)
        method = bind_layout(method, layout)
        self.method = method
        self.data = data
        self.cfg = run_cfg
        # one rank speaks for the group: the others log nothing and trace
        # nothing (their phases are the same)
        self.rank = collectives.world_rank()
        self.obs = make_obs(run_cfg.obs if self.rank == 0 else ObsConfig(quiet=True))
        self.rng = np.random.RandomState(run_cfg.seed)
        self.kprime = max(1, int(round(run_cfg.participation * k)))
        self.T = run_cfg.local_iters or data.local_iters(run_cfg.batch)

        flat = layout.flatten(tree_map(lambda x: x.to(self.device), init_params))
        self.programs = RoundPrograms(
            method,
            lambda v, b: loss_fn(layout.unflatten(v), b),
            lambda v, t: acc_fn(layout.unflatten(v), t),
            run_cfg.backend, run_cfg.shards, mesh=run_cfg.mesh,
            strict_shards=self._strict_shards,
            output_sharding=run_cfg.output_sharding, grad_chunks=run_cfg.grad_chunks)
        # built eagerly: validates backend/shards/mesh at construction
        self.engine = self.programs.engine(self.kprime)
        # same init for every client (paper: "same initialization for all
        # methods"), stacked on a leading K axis in the cohort store; on a
        # mesh the host stores hold one copy for all the ranks
        shared = run_cfg.backend != "vmap" and collectives.world_size() > 1
        self.store = make_store(run_cfg.store, method.init_client(flat), k,
                                self.device, shared=shared)
        self._store_struct = self.store.stacked()
        self.broadcast = method.init_server(flat)
        self.best_acc = np.zeros(k, np.float64)  # per-client best (Table II)
        self.participated = np.zeros(k, bool)
        self.sim_time = 0.0
        self._round = 0
        self._history: Dict[str, list] = {key: [] for key in _HISTORY_KEYS}

    @property
    def client_states(self):
        """The (K, ...)-stacked client states (flat rows) in the store's
        at-rest representation: tensors on the device store, numpy on the
        host and mmap stores."""
        return self.store.stacked()

    @client_states.setter
    def client_states(self, tree):
        self.store.load_stacked(tree)

    def _to_device(self, arrays: Dict[str, np.ndarray]):
        return {k: torch.from_numpy(v).to(self.device) for k, v in arrays.items()}

    # -- observability ----------------------------------------------------

    def _obs_fingerprint(self) -> dict:
        """Facets stamped into the trace directory's meta.json: the
        checkpoint fingerprint plus the method name."""
        return {"driver": "sync", "method": self.method.name,
                **self._run_fingerprint()}

    def _obs_open(self) -> None:
        if not self.obs.enabled:
            return
        self.obs.open(self._obs_fingerprint())
        self.obs.event("run_start", engine=self.engine.describe(),
                       rounds=self.cfg.rounds)
        if getattr(self.store, "promoted", False):
            # the host store spilled to disk-backed memmaps past its threshold
            self.obs.event("mmap_promote", store=self.store.describe())

    def _observe_client_metrics(self, metrics) -> None:
        """Per-client diagnostics -> histograms: the loss, pFedSOP's beta
        and its angle theta (Eq. 14 inverted on the host) and the share of
        personalized clients.  Reads host copies only."""
        reg = self.obs.metrics
        if reg is None:
            return
        reg.histogram("client.loss", _LOSS_EDGES).observe(
            _host(metrics["loss"]).astype(np.float64))
        beta = metrics.get("beta")
        if beta is not None:
            b = _host(beta).astype(np.float64)
            reg.histogram("pfedsop.beta", _BETA_EDGES).observe(b)
            lam = getattr(getattr(self.method, "cfg", None), "lam", None)
            if lam is not None:
                reg.histogram("pfedsop.theta", _THETA_EDGES).observe(
                    theta_from_beta(b, lam))
        if metrics.get("personalized") is not None:
            reg.gauge("pfedsop.personalized_frac").set(
                float(np.mean(_host(metrics["personalized"]).astype(np.float64))))

    def _observe_round(self, t: int, m: dict, dt: float) -> None:
        reg = self.obs.metrics
        if reg is not None:
            reg.counter("rounds").inc()
            reg.gauge("loss").set(m["loss"])
            reg.gauge("acc").set(m["acc"])
            reg.gauge("round_time").set(dt)
            reg.set_gauges("store", self.store.stats())
            self.obs.flush_metrics(step=t, sim_time=self.sim_time)
        self.obs.flush()

    # -- round loop -------------------------------------------------------

    def run_round(self):
        obs = self.obs
        k = self.kprime
        ids = self.rng.choice(self.cfg.n_clients, k, replace=False)
        batches = self._to_device(
            self.data.sample_round_batches(self.rng, ids, self.T, self.cfg.batch))
        tests = self._to_device(self.data.client_test_set(ids))
        shardings = self.programs.input_shardings(k, self._store_struct)
        gathered = obs.timed("gather", self.store.gather, ids, shardings)
        out = obs.timed("client", self.programs.client, gathered, self.broadcast,
                        batches, shardings)
        # the round-boundary all-gather: its own span (None on vmap and in
        # the sharded round loop)
        rep = self.programs.replicate_fn(k)
        if rep is not None:
            out = obs.timed("all_gather", rep, out)
        new_states, uploads, metrics = out
        # personalized eval against the pre-update broadcast (the model a
        # client would deploy this round)
        accs = obs.timed("eval", self.programs.eval, new_states, self.broadcast, tests)
        self.broadcast = obs.timed("aggregate", self.programs.aggregate,
                                   self.broadcast, uploads, k)
        if metrics["loss"].shape[0] != k:
            # the sharded round loop: the per-client metrics come to every
            # rank for the history, and a store that is one replica per rank
            # (the device store) takes every rank's rows
            metrics = self.engine.replicate(metrics)
            if not self.store.shared:
                new_states = obs.timed("all_gather", self.engine.replicate, new_states)
        obs.timed("scatter", self.store.scatter, ids, new_states, shardings, sync=False)

        # the host reads below wait for every launch of the round
        accs = accs.cpu().numpy().astype(np.float64)
        loss = metrics["loss"].cpu().numpy()
        self.best_acc[ids] = np.maximum(self.best_acc[ids], accs)
        self.participated[ids] = True
        if self.availability is not None:
            self.sim_time += self.availability.sync_round_duration(ids, self.sim_time)
        else:
            self.sim_time += 1.0
        self._observe_client_metrics(metrics)
        return {"loss": float(np.mean(loss)), "acc": float(np.mean(accs))}

    def run(self, verbose: bool = False):
        obs = self.obs
        while self._round < self.cfg.rounds:
            t = self._round
            obs.profile_round_start(t)
            t0 = time.perf_counter()
            with obs.span("round", round=t, sim=self.sim_time):
                m = self.run_round()
            dt = time.perf_counter() - t0
            obs.profile_round_end(t)
            self._history["loss"].append(m["loss"])
            self._history["acc"].append(m["acc"])
            self._history["round_time"].append(dt)
            self._history["sim_time"].append(self.sim_time)
            self._round += 1
            if verbose and (t % 10 == 0 or t == self.cfg.rounds - 1):
                obs.log.info(
                    f"[{self.method.name}/{self.engine.name}] round {t:4d} "
                    f"loss={m['loss']:.4f} acc={m['acc']:.4f} ({dt:.2f}s)",
                    event="round", round=t, loss=m["loss"], acc=m["acc"], dt=dt)
            self._observe_round(t, m, dt)
            if (self.cfg.ckpt_every and self.cfg.ckpt_dir
                    and self._round % self.cfg.ckpt_every == 0):
                self.save(self.cfg.ckpt_dir)
        history = self._finalize_history()
        history["engine"] = self.engine.describe()
        obs.close()
        return history

    def _finalize_history(self):
        history = {key: list(v) for key, v in self._history.items()}
        history["mean_best_acc"] = (
            float(np.mean(self.best_acc[self.participated]))
            if self.participated.any() else 0.0)
        return history

    # -- checkpoint / resume ----------------------------------------------

    def _ckpt_tree(self):
        # the client states are not in this tree: the store writes them in
        # client-range shards beside arrays.npz
        return {
            "broadcast": self.broadcast,
            "best_acc": self.best_acc,
            "participated": self.participated,
            "rng": rng_state_tree(self.rng),
            "history": {key: np.asarray(v, np.float64)
                        for key, v in self._history.items()},
        }

    def _run_fingerprint(self) -> dict:
        """Config facets a resumed run must share with the checkpoint's
        writer for the restored RNG and clock streams to continue bit for
        bit: the sampling and data-shape knobs, the availability model and
        the store.  ``rounds`` is left out on purpose (a longer budget
        keeps the common prefix)."""
        av = getattr(self, "availability", None)
        return {
            "seed": self.cfg.seed,
            "n_clients": self.cfg.n_clients,
            "participation": self.cfg.participation,
            "batch": self.cfg.batch,
            "local_iters": self.cfg.local_iters,
            "grad_chunks": self.cfg.grad_chunks,
            "update_impl": self.cfg.update_impl,
            "availability": None if av is None else dataclasses.asdict(av.cfg),
            "store": self.store.describe(),
        }

    def _check_run_fingerprint(self, extra: dict, ckpt_dir) -> None:
        want = self._run_fingerprint()
        if extra.get("run_cfg") != want:
            raise ValueError(
                f"checkpoint at {ckpt_dir} was written with run config "
                f"{extra.get('run_cfg')}, but this driver is configured "
                f"with {want}; resuming across a config change is not a "
                "bitwise continuation")

    def _ckpt_extra(self) -> dict:
        return {"round": self._round, "sim_time": self.sim_time,
                "driver": "sync", "run_cfg": self._run_fingerprint()}

    def save(self, ckpt_dir) -> str:
        """Checkpoint the whole driver state after ``self._round`` rounds
        (rank 0 writes it; on a mesh every rank's state is the same)."""
        if self.rank == 0:
            path = save_checkpoint(ckpt_dir, self._round, self._ckpt_tree(),
                                   extra=self._ckpt_extra())
            self.store.save_shards(path)
        if collectives.world_size() > 1:
            path = collectives.broadcast_object(path if self.rank == 0 else None)
        self.obs.event("checkpoint_save", cat="checkpoint", round=self._round)
        return path

    def _load_store_shards(self, ckpt_dir, step: int) -> None:
        self.store.load_shards(Path(ckpt_dir) / f"step_{step:08d}")

    def restore(self, ckpt_dir=None, step=None) -> int:
        """Restore state saved by ``save``; returns the round to resume at.

        Call it on a freshly constructed, identically configured
        federation (the manifest's fingerprint refuses a mismatch); the
        resumed run reproduces the uninterrupted history bit for bit."""
        ckpt_dir = ckpt_dir or self.cfg.ckpt_dir
        manifest = read_manifest(ckpt_dir, step)
        ex = manifest["extra"]
        driver = ex.get("driver")
        if driver != "sync":
            raise ValueError(
                f"checkpoint at {ckpt_dir} was written by the {driver!r} "
                "driver, not 'sync'; resume it with the matching driver "
                "(e.g. train_federated --mode async)")
        self._check_run_fingerprint(ex, ckpt_dir)
        tree, extra = load_checkpoint(ckpt_dir, self._ckpt_template(),
                                      step=manifest["step"])
        self._restore_core(tree, extra)
        self._load_store_shards(ckpt_dir, manifest["step"])
        self.obs.event("checkpoint_restore", cat="checkpoint",
                       round=self._round, step=manifest["step"])
        return self._round

    def _restore_core(self, tree, extra):
        self.broadcast = tree["broadcast"]
        self.best_acc = np.asarray(tree["best_acc"], np.float64)
        self.participated = np.asarray(tree["participated"], bool)
        restore_rng_state(self.rng, tree["rng"])
        self._history = {key: [float(x) for x in np.asarray(v)]
                         for key, v in tree["history"].items()}
        self._round = int(extra["round"])
        self.sim_time = float(extra["sim_time"])

    def _ckpt_template(self):
        tmpl = self._ckpt_tree()
        # history lengths vary across checkpoints; restore matches names
        tmpl["history"] = {key: np.zeros(0, np.float64) for key in self._history}
        return tmpl


def masked_accuracy(apply_fn):
    """acc_fn factory for padded test sets ({"images","labels","mask"})."""

    def acc(params, test):
        logits = apply_fn(params, test)
        hit = (logits.argmax(-1) == test["labels"]).float()
        return (hit * test["mask"]).sum() / torch.clamp(test["mask"].sum(), min=1.0)

    return acc
