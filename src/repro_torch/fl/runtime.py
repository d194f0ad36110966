"""Federation runtime: the synchronous round loop and its history.

Port of ``repro/fl/runtime.py`` for the main path: the ``Federation``
sync driver over ``VmapBackend`` and the device store.  Per-client state
lives at rest as ``(K, ...)``-stacked flat rows (``fl.cohort_store``);
each round the K' participants are gathered, the method's cohort step
(``round_start``: pFedSOP's batched kernel launch pair) and its mapped
one-client phase run, per-client eval runs on the pre-update broadcast,
uploads are aggregated and the new rows scattered back.

Sampling (participation + local SGD batches + test sets) is host numpy
on one ``RandomState(seed)`` consumed in ``repro``'s order, so the cohort
ids are bitwise those of ``repro`` at the same seed.  Every entry point
runs on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.core.baselines import FLMethod
from repro_torch.data.federated import FederatedData
from repro_torch.fl.cohort_store import make_store
from repro_torch.fl.engine import make_engine
from repro_torch.kernels.dispatch import check_impl_name
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import FlatLayout, tree_map

_METHOD_INTERFACE = tuple(
    a for a, v in vars(FLMethod).items() if callable(v) and not a.startswith("_")
)

# FLRunConfig knobs of ``repro`` that this slice does not port, with the
# only value accepted: anything else raises instead of being ignored.
_UNPORTED = {
    "shards": 0, "mesh": "", "output_sharding": "replicated", "grad_chunks": 1,
    "ckpt_every": 0, "ckpt_dir": "", "async_cfg": None, "obs": None,
}


def validate_method(method) -> None:
    """Fail fast on a method missing part of the ``FLMethod`` contract."""
    missing = [a for a in _METHOD_INTERFACE
               if not callable(getattr(method, a, None))]
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
    # store: None/"device" only (repro_torch.fl.cohort_store)
    store: Any = None
    # not ported yet (ROADMAP.md queue 1); only the defaults are accepted
    shards: int = 0
    mesh: str = ""
    output_sharding: str = "replicated"
    grad_chunks: int = 1
    ckpt_every: int = 0
    ckpt_dir: str = ""
    async_cfg: Any = None
    obs: Any = None

    def __post_init__(self):
        for name, only in _UNPORTED.items():
            if getattr(self, name) != only:
                raise NotImplementedError(
                    f"FLRunConfig.{name}={getattr(self, name)!r} is not ported "
                    f"to repro_torch yet (only {only!r}); see ROADMAP.md "
                    "queue 1")


class RoundPrograms:
    """The per-phase round programs: client phase (cohort step + mapped
    one-client phase), per-client eval, server aggregation.  PyTorch runs
    eagerly, so there is nothing to compile or cache per cohort size."""

    def __init__(self, method, loss_fn, acc_fn, engine):
        self.method = method
        self.loss_fn = loss_fn
        self.acc_fn = acc_fn
        self.engine = engine

    def client(self, gathered_states, broadcast, batches):
        """-> (new_states, uploads, metrics), all (K', ...)-stacked."""
        method, loss_fn = self.method, self.loss_fn
        states, cohort_metrics = method.round_start(gathered_states, broadcast)

        def one_client(state, broadcast_, batch_seq):
            return method.client_round(loss_fn, state, broadcast_, batch_seq)

        new_states, uploads, metrics = self.engine.client_phase(
            one_client, states, broadcast, batches)
        return new_states, uploads, {**metrics, **cohort_metrics}

    def eval(self, states, broadcast, test_sets):
        """-> per-client accuracies (K',)."""
        method, acc_fn = self.method, self.acc_fn

        def one_eval(state, broadcast_, test):
            return acc_fn(method.eval_params(state, broadcast_), test)

        return self.engine.eval_phase(one_eval, states, broadcast, test_sets)

    def aggregate(self, broadcast, uploads):
        return self.method.server_update(broadcast, uploads)


_HISTORY_KEYS = ("loss", "acc", "round_time", "sim_time")


class Federation:
    """Drives ``rounds`` FL rounds of ``method`` over ``data`` on ``device``.

    ``init_params`` is a parameter tree (e.g. ``models.cnn.init_params``);
    ``loss_fn(params, batch)`` and ``acc_fn(params, test)`` take such a
    tree.  The federation flattens it once into the ``FlatLayout`` leaf
    order and hands the model per-leaf views of each client's flat row.
    ``device`` defaults to the card and raises without one; a CPU run
    passes ``device="cpu"``.  The availability model (simulated clock) is
    not ported: each round advances ``sim_time`` by 1.0, as ``repro``
    does without a model.
    """

    def __init__(self, method, loss_fn: Callable, acc_fn: Callable,
                 init_params, data: FederatedData, run_cfg: FLRunConfig,
                 availability=None, device="cuda"):
        self.device = resolve_device(device)
        if availability is not None:
            raise NotImplementedError(
                "the availability model is not ported to repro_torch yet "
                "(ROADMAP.md queue 1, async); pass availability=None")
        validate_method(method)
        if run_cfg.update_impl:
            method = override_update_impl(method, run_cfg.update_impl)
        k = run_cfg.n_clients
        if data.n_clients != k:
            raise ValueError(f"data has {data.n_clients} clients, run_cfg {k}")
        self.method = method
        self.data = data
        self.cfg = run_cfg
        self.rng = np.random.RandomState(run_cfg.seed)
        self.kprime = max(1, int(round(run_cfg.participation * k)))
        self.T = run_cfg.local_iters or data.local_iters(run_cfg.batch)
        self.engine = make_engine(run_cfg.backend)

        self.layout = layout = FlatLayout(init_params)
        flat = layout.flatten(tree_map(lambda x: x.to(self.device), init_params))
        self.programs = RoundPrograms(
            method,
            lambda v, b: loss_fn(layout.unflatten(v), b),
            lambda v, t: acc_fn(layout.unflatten(v), t),
            self.engine)
        # same init for every client (paper: "same initialization for all
        # methods"), stacked on a leading K axis in the device store
        self.store = make_store(run_cfg.store, method.init_client(flat), k,
                                self.device)
        self.broadcast = method.init_server(flat)
        self.best_acc = np.zeros(k, np.float64)  # per-client best (Table II)
        self.participated = np.zeros(k, bool)
        self.sim_time = 0.0
        self._round = 0
        self._history: Dict[str, list] = {key: [] for key in _HISTORY_KEYS}

    @property
    def client_states(self):
        """The (K, ...)-stacked client states (flat rows) in the store."""
        return self.store.stacked()

    def _to_device(self, arrays: Dict[str, np.ndarray]):
        return {k: torch.from_numpy(v).to(self.device) for k, v in arrays.items()}

    def run_round(self):
        ids = self.rng.choice(self.cfg.n_clients, self.kprime, replace=False)
        batches = self._to_device(
            self.data.sample_round_batches(self.rng, ids, self.T, self.cfg.batch))
        tests = self._to_device(self.data.client_test_set(ids))
        gathered = self.store.gather(ids)
        new_states, uploads, metrics = self.programs.client(
            gathered, self.broadcast, batches)
        # personalized eval against the pre-update broadcast (the model a
        # client would deploy this round)
        accs = self.programs.eval(new_states, self.broadcast, tests)
        self.broadcast = self.programs.aggregate(self.broadcast, uploads)
        self.store.scatter(ids, new_states)

        # the host reads below wait for every launch of the round
        accs = accs.cpu().numpy().astype(np.float64)
        loss = metrics["loss"].cpu().numpy()
        self.best_acc[ids] = np.maximum(self.best_acc[ids], accs)
        self.participated[ids] = True
        self.sim_time += 1.0
        return {"loss": float(np.mean(loss)), "acc": float(np.mean(accs))}

    def run(self, verbose: bool = False):
        while self._round < self.cfg.rounds:
            t = self._round
            t0 = time.perf_counter()
            m = self.run_round()
            dt = time.perf_counter() - t0
            self._history["loss"].append(m["loss"])
            self._history["acc"].append(m["acc"])
            self._history["round_time"].append(dt)
            self._history["sim_time"].append(self.sim_time)
            self._round += 1
            if verbose and (t % 10 == 0 or t == self.cfg.rounds - 1):
                print(f"[{self.method.name}/{self.engine.name}] round {t:4d} "
                      f"loss={m['loss']:.4f} acc={m['acc']:.4f} ({dt:.2f}s)",
                      flush=True)
        history = {key: list(v) for key, v in self._history.items()}
        history["mean_best_acc"] = (
            float(np.mean(self.best_acc[self.participated]))
            if self.participated.any() else 0.0)
        history["engine"] = self.engine.describe()
        return history


def masked_accuracy(apply_fn):
    """acc_fn factory for padded test sets ({"images","labels","mask"})."""

    def acc(params, test):
        logits = apply_fn(params, test)
        hit = (logits.argmax(-1) == test["labels"]).float()
        return (hit * test["mask"]).sum() / torch.clamp(test["mask"].sum(), min=1.0)

    return acc
