"""Asynchronous federation driver: FedBuff-style buffered aggregation over
an availability-aware discrete-event scheduler.

Port of ``repro/fl/async_.py``.  ``AsyncFederation`` replaces the round
loop of ``repro_torch.fl.runtime.Federation`` with a simulated-time event
loop over the same pieces:

- ``repro_torch.fl.availability`` supplies per-client speeds and on/off
  traces (seeded apart from the participation RNG);
- ``repro_torch.fl.scheduler`` dispatches work to online idle clients in
  *micro-cohorts* (grouped same-broadcast dispatches) and collects uploads
  at their simulated completion times;
- the server applies an update whenever ``buffer_size`` uploads have
  accumulated; each upload carries its staleness tau (server versions
  elapsed since its dispatch) into the method's ``server_update_stale``.

The hot path is the synchronous driver's: a micro-cohort of any size C
from 1 to K' runs through the same ``RoundPrograms`` phases, so a
pFedSOP dispatch is one ``(C, N)`` launch pair of the round-start kernels.
Availability, scheduling and sampling are host numpy, consumed in
``repro``'s order, so ``sim_time`` and the staleness sequence are
``repro``'s exactly.  In the degenerate configuration (every client
always online at uniform speed, ``concurrency = buffer_size = K'``) the
event loop collapses to lockstep rounds that feed identical operands to
identical phases, and the history equals the synchronous driver's bit for
bit.  ``n_pods`` comes from the engine: a multi-pod mesh
(``pods:PxDxM``) maps micro-cohorts onto its P pods and each pod drains
its own completion stream (``scheduler.pop_pod_completions``); a
micro-cohort the pod count does not divide runs unsharded (``strict=False``).
On a mesh every dispatch's outputs are all-gathered to every rank (its
in-flight results are delivered in other cohorts), and the in-flight
results are host copies (``offload(force_host=True)``).

History: one entry per *applied server update* (version); ``sim_time`` is
the simulated clock at which each update was applied.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.fl.availability import AvailabilityConfig, make_availability
from repro_torch.fl.runtime import Federation, FLRunConfig, validate_method
from repro_torch.fl.scheduler import RoundScheduler
from repro_torch.utils.checkpoint import load_checkpoint, read_manifest
from repro_torch.utils.pytree import tree_map

# event-loop steps without an applied server update before the simulation
# is declared wedged
_MAX_IDLE_STEPS = 100_000

# staleness histogram edges: tau in powers of two, discount s(tau) in tenths
_TAU_EDGES = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0)
_DISCOUNT_EDGES = tuple(i / 10 for i in range(1, 10))


def _stack(trees):
    """Stack same-structured rows in their own kind: tensors with
    ``torch.stack``, host rows (a host store's offloaded results) with
    ``np.stack``."""
    return tree_map(lambda *xs: torch.stack(xs) if isinstance(xs[0], torch.Tensor)
                    else np.stack(xs), *trees)


def _on_device(tree, device):
    """``tree`` with its host leaves copied to ``device`` (one copy per
    leaf); tensors pass through."""
    return tree_map(lambda x: x if isinstance(x, torch.Tensor)
                    else torch.from_numpy(np.ascontiguousarray(x)).to(device), tree)


@dataclass(frozen=True)
class AsyncConfig:
    """Async-subsystem knobs, nested under ``FLRunConfig.async_cfg``.

    The defaults are the sync-degenerate configuration: ``buffer_size``
    and ``concurrency`` of 0 resolve to K', and the default
    ``AvailabilityConfig`` is always-online uniform speed."""

    buffer_size: int = 0  # uploads per server update; 0 = K'
    concurrency: int = 0  # clients kept in flight; 0 = K'
    # AvailabilityConfig or TraceAvailabilityConfig (make_availability)
    availability: Any = field(default_factory=AvailabilityConfig)


class AsyncFederation(Federation):
    """Buffered asynchronous federation over a simulated client population.

    Construction mirrors ``Federation`` plus an ``AsyncConfig``, passed
    explicitly or nested as ``run_cfg.async_cfg``.  ``run()`` executes
    until ``run_cfg.rounds`` server updates have been applied."""

    # micro-cohorts an explicit split does not divide fall back (engine.py)
    _strict_shards = False

    def __init__(self, method, loss_fn, acc_fn, init_params, data,
                 run_cfg: FLRunConfig, async_cfg: Optional[AsyncConfig] = None,
                 device="cuda"):
        # the async driver is the sole caller of server_update_stale
        validate_method(method, require_stale_hook=True)
        self._init_core(method, loss_fn, acc_fn, init_params, data, run_cfg, device)
        acfg = async_cfg or run_cfg.async_cfg or AsyncConfig()
        if not isinstance(acfg, AsyncConfig):
            raise TypeError(f"async_cfg must be an AsyncConfig, got {type(acfg)}")
        self.async_cfg = acfg
        self.buffer_size = acfg.buffer_size or self.kprime
        self.concurrency = acfg.concurrency or self.kprime
        if self.buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {self.buffer_size}")
        self.availability = make_availability(acfg.availability, run_cfg.n_clients,
                                              run_cfg.seed)
        # multi-pod mesh: micro-cohorts map onto the pods; 1 elsewhere
        self.n_pods = getattr(self.engine, "n_pods", 1)
        self.scheduler = RoundScheduler(self.availability, self.concurrency,
                                        n_pods=self.n_pods)
        self.scheduler.obs = self.obs
        # in-flight results, computed at dispatch and delivered at each
        # client's simulated completion time: client -> slices
        self._pending: Dict[int, dict] = {}
        # completed uploads awaiting aggregation, in delivery order
        self._buffer: List[dict] = []
        self._history["staleness"] = []
        self._t0 = time.perf_counter()
        self._obs_open()

    @property
    def version(self) -> int:
        """Applied server updates so far (the FedBuff server version)."""
        return self._round

    def _obs_fingerprint(self) -> dict:
        return {**super()._obs_fingerprint(), "driver": "async",
                "async": self._acfg_fingerprint()}

    # -- event loop --------------------------------------------------------

    def run(self, verbose: bool = False):
        self._t0 = time.perf_counter()
        obs = self.obs
        idle = 0
        while self._round < self.cfg.rounds:
            v0 = self._round
            # the profile window opens while version v0 is current and
            # closes at the step that advances past it
            obs.profile_round_start(v0)
            self._step()
            if self._round > v0:
                obs.profile_round_end(v0)
            idle = 0 if self._round > v0 else idle + 1
            if idle > _MAX_IDLE_STEPS:
                raise RuntimeError(
                    f"async event loop made no progress for {idle} steps "
                    f"(version {self._round}, sim_time {self.sim_time}); "
                    "check the availability configuration")
            if verbose and self._round > v0 and (
                    self._round % 10 == 0 or self._round == self.cfg.rounds):
                obs.log.info(
                    f"[{self.method.name}/async] version {self._round:4d} "
                    f"loss={self._history['loss'][-1]:.4f} "
                    f"acc={self._history['acc'][-1]:.4f} "
                    f"sim_t={self.sim_time:.2f} "
                    f"tau={self._history['staleness'][-1]:.2f}",
                    event="version", version=self._round,
                    loss=self._history["loss"][-1],
                    acc=self._history["acc"][-1], sim_time=self.sim_time,
                    tau=self._history["staleness"][-1])
        history = self._finalize_history()
        # describe an engine that ran (the largest cohort seen): with
        # concurrency < K' a K'-sized engine never runs
        seen = self.programs.seen_cohorts()
        history["engine"] = {
            **self.programs.engine(seen[-1] if seen else self.kprime).describe(),
            "mode": "async",
            "cohort_sizes": self.programs.seen_cohorts(),
            "buffer_size": self.buffer_size,
            "concurrency": self.concurrency,
        }
        obs.close()
        return history

    def _step(self):
        """One event-loop transition: dispatch at the current sim time if
        possible, else advance the clock to the next event (completion or
        availability wakeup) and deliver any completions."""
        # a checkpoint written by a non-final flush of a multi-flush
        # delivery still holds >= buffer_size uploads: drain first (a
        # no-op otherwise)
        self._drain()
        # a checkpoint written inside the same-timestamp drain below still
        # holds completions due now: deliver them before dispatching (a
        # no-op outside resume: completions always lie in the future here)
        while self.scheduler.next_completion_time() is not None and \
                self.scheduler.next_completion_time() <= self.sim_time:
            _, _, done = self.scheduler.pop_pod_completions()
            self._deliver(done)
        if self._round >= self.cfg.rounds:
            return  # the drain finished the budget; don't dispatch past it
        ids = self.scheduler.dispatch_group(self.sim_time, self.rng)
        if len(ids):
            self._dispatch(ids)
        tc = self.scheduler.next_completion_time()
        if tc is None:
            # nothing in flight: every idle client is offline; advance to
            # the earliest on-transition and retry dispatch there
            tn = self.scheduler.next_dispatch_time(self.sim_time)
            if tn is None:
                raise RuntimeError("async scheduler deadlock: no clients in "
                                   "flight and none coming online")
            self.sim_time = tn
            return
        if self.scheduler.free_slots() > 0:
            # free slots but every idle client offline: wake early if one
            # comes online before the next completion
            tn = self.scheduler.next_dispatch_time(self.sim_time)
            if tn is not None and tn < tc:
                self.sim_time = tn
                return
        # deliver every micro-cohort due at the next completion time before
        # the next dispatch_group (what keeps the degenerate configuration's
        # RNG use identical to the synchronous sampler's)
        self.sim_time = tc
        while self.scheduler.next_completion_time() == self.sim_time:
            _, _, done = self.scheduler.pop_pod_completions()
            self._deliver(done)

    def _dispatch(self, ids: np.ndarray):
        """Run the micro-cohort's client phase with the CURRENT broadcast;
        its results are delivered at each client's completion time.  Batch
        sampling draws from the shared participation RNG in one grouped
        call, as the synchronous driver does."""
        obs = self.obs
        obs.event("dispatch", track="async", sim=self.sim_time,
                  cohort=len(ids), version=self._round)
        batches = self._to_device(
            self.data.sample_round_batches(self.rng, ids, self.T, self.cfg.batch))
        shardings = self.programs.input_shardings(len(ids), self._store_struct)
        gathered = obs.timed("gather", self.store.gather, ids, shardings,
                             sim=self.sim_time)
        out = obs.timed("client", self.programs.client, gathered, self.broadcast,
                        batches, shardings, sim=self.sim_time)
        replicate = getattr(self.programs.engine(len(ids)), "replicate", None)
        if replicate is not None:
            out = obs.timed("all_gather", replicate, out, sim=self.sim_time)
        new_states, uploads, metrics = out
        self._observe_client_metrics(metrics)
        # in-flight results go through the store's offload policy: a host or
        # mmap store always host-copies them (buffered results never pin
        # device memory); the device store keeps them on the device on vmap
        # and host-copies them on a mesh, as repro does
        new_states, uploads = self.store.offload(
            (new_states, uploads), force_host=self.cfg.backend != "vmap")
        losses = metrics["loss"].cpu().numpy().astype(np.float32)
        for j, i in enumerate(ids.tolist()):
            self._pending[i] = {
                "state": tree_map(lambda x: x[j], new_states),
                "upload": tree_map(lambda x: x[j], uploads),
                "loss": losses[j],
                "version": self._round,
            }

    def _deliver(self, done: List[int]):
        """Collect a completed micro-cohort: evaluate its post-training
        states against the current broadcast (the synchronous pre-update
        eval), scatter them into the K-stack, and append its uploads to
        the aggregation buffer, flushing whenever ``buffer_size`` is
        reached."""
        obs = self.obs
        obs.event("deliver", track="async", sim=self.sim_time,
                  cohort=len(done), version=self._round)
        items = [self._pending.pop(i) for i in done]
        # host rows go to the device once per delivery, before eval and scatter
        stacked = _on_device(_stack([it["state"] for it in items]), self.device)
        dn = np.asarray(done, np.int64)
        tests = self._to_device(self.data.client_test_set(dn))
        accs = obs.timed("eval", self.programs.eval, stacked, self.broadcast,
                         tests, sim=self.sim_time)
        accs = accs.cpu().numpy().astype(np.float64)
        self.best_acc[dn] = np.maximum(self.best_acc[dn], accs)
        self.participated[dn] = True
        obs.timed("scatter", self.store.scatter, dn, stacked,
                  self.programs.input_shardings(len(dn), self._store_struct),
                  sync=False, sim=self.sim_time)
        # append the whole cohort before flushing: a checkpoint written by
        # a flush must see every delivered upload in the buffer (or already
        # aggregated).  ``sim_t`` feeds the buffered-wait track only;
        # checkpoints don't carry it
        for it, i, a in zip(items, done, accs):
            self._buffer.append({
                "client": int(i),
                "upload": it["upload"],
                "loss": it["loss"],
                "acc": a,
                "version": it["version"],
                "sim_t": self.sim_time,
            })
        self._drain()

    def _drain(self):
        """Apply buffered updates until the buffer drops below
        ``buffer_size``, capped at the round budget."""
        while (len(self._buffer) >= self.buffer_size
               and self._round < self.cfg.rounds):
            self._flush()

    def _flush(self):
        """Apply one buffered server update (version += 1)."""
        obs = self.obs
        items = self._buffer[: self.buffer_size]
        del self._buffer[: self.buffer_size]
        uploads = _on_device(_stack([it["upload"] for it in items]), self.device)
        tau = np.asarray([self._round - it["version"] for it in items], np.int64)
        if tau.any():
            self.broadcast = obs.timed(
                "aggregate_stale", self.programs.aggregate_stale,
                self.broadcast, uploads,
                torch.as_tensor(tau, dtype=torch.int32, device=self.device),
                sim=self.sim_time)
        else:
            # all fresh: the staleness hook is the identity at tau = 0, so
            # take the synchronous driver's aggregation
            self.broadcast = obs.timed("aggregate", self.programs.aggregate,
                                       self.broadcast, uploads, sim=self.sim_time)
        self._round += 1
        dt = time.perf_counter() - self._t0
        self._t0 = time.perf_counter()
        self._history["loss"].append(
            float(np.mean(np.asarray([it["loss"] for it in items], np.float32))))
        self._history["acc"].append(
            float(np.mean(np.asarray([it["acc"] for it in items], np.float64))))
        self._history["round_time"].append(dt)
        self._history["sim_time"].append(self.sim_time)
        self._history["staleness"].append(float(tau.mean()))
        self._observe_flush(items, tau, dt)
        if (self.cfg.ckpt_every and self.cfg.ckpt_dir
                and self._round % self.cfg.ckpt_every == 0):
            self.save(self.cfg.ckpt_dir)

    def _observe_flush(self, items, tau: np.ndarray, dt: float) -> None:
        """Per-version observability: the flush event with its tau, the
        per-client buffered-wait track, and the staleness histograms (tau
        and the discount s(tau) = (1 + tau)^(-staleness_exp))."""
        obs = self.obs
        v = self._round - 1
        obs.event("buffer_flush", track="async", sim=self.sim_time,
                  version=v, n=len(items), tau_mean=float(tau.mean()),
                  tau_max=int(tau.max()), stale=bool(tau.any()))
        if obs.tracer is not None:
            for it in items:
                obs.client_span(
                    it["client"], "buffered",
                    it.get("sim_t", self.sim_time), self.sim_time,
                    tau=int(self._round - 1 - it["version"]), version=v)
        reg = obs.metrics
        if reg is not None:
            reg.counter("versions").inc()
            reg.gauge("loss").set(self._history["loss"][-1])
            reg.gauge("acc").set(self._history["acc"][-1])
            reg.gauge("round_time").set(dt)
            reg.gauge("staleness").set(float(tau.mean()))
            reg.histogram("async.tau", _TAU_EDGES).observe(tau)
            exp_ = getattr(getattr(self.method, "cfg", None), "staleness_exp", None)
            if exp_ is not None:
                reg.histogram("async.stale_discount", _DISCOUNT_EDGES).observe(
                    (1.0 + tau.astype(np.float64)) ** -float(exp_))
            reg.set_gauges("store", self.store.stats())
            obs.flush_metrics(step=v, sim_time=self.sim_time)
        obs.flush()

    # -- checkpoint / resume ----------------------------------------------

    def _ckpt_tree(self):
        tree = super()._ckpt_tree()
        tree["sched"] = self.scheduler.state()
        if self._pending:
            ids = sorted(self._pending)
            items = [self._pending[i] for i in ids]
            tree["pending"] = {
                "ids": np.asarray(ids, np.int64),
                "versions": np.asarray([it["version"] for it in items], np.int64),
                "loss": np.asarray([it["loss"] for it in items], np.float32),
                "states": _stack([it["state"] for it in items]),
                "uploads": _stack([it["upload"] for it in items]),
            }
        if self._buffer:
            items = self._buffer
            tree["buffer"] = {
                "ids": np.asarray([it["client"] for it in items], np.int64),
                "versions": np.asarray([it["version"] for it in items], np.int64),
                "loss": np.asarray([it["loss"] for it in items], np.float32),
                "acc": np.asarray([it["acc"] for it in items], np.float64),
                "uploads": _stack([it["upload"] for it in items]),
            }
        return tree

    def _acfg_fingerprint(self) -> dict:
        """The resolved async configuration, stamped into the manifest so
        restore refuses a config-mismatched resume."""
        return {"buffer_size": self.buffer_size,
                "concurrency": self.concurrency,
                "n_pods": self.n_pods}

    def _ckpt_extra(self) -> dict:
        extra = super()._ckpt_extra()
        extra.update({"driver": "async", "n_pending": len(self._pending),
                      "n_buffer": len(self._buffer),
                      "async_cfg": self._acfg_fingerprint()})
        return extra

    def _upload_struct(self):
        """One upload's structure and dtypes, in the kind the store's
        ``offload`` gives, for the restore templates of the stacked pending
        and buffered uploads (their structure is the method's): one
        client's ``client_round`` on one local iteration of a throwaway
        sample (the participation RNG is not touched).  Client 0's row is
        copied from the at-rest stack, not gathered, so the store's stats
        and LRU order are not touched either."""
        throwaway = np.random.RandomState(0)
        bt = self._to_device(self.data.sample_round_batches(
            throwaway, np.asarray([0]), 1, self.cfg.batch))
        bt = {k: v[0] for k, v in bt.items()}
        state = tree_map(lambda x: x[0], _on_device(
            tree_map(lambda x: x[:1], self.client_states), self.device))
        return self.store.offload(self.method.client_round(
            self.programs.loss_fn, state, self.broadcast, bt)[1])

    def restore(self, ckpt_dir=None, step=None) -> int:
        """Restore a checkpoint written by ``save`` (fresh, identically
        configured driver), with the scheduler heap, the in-flight results
        and the aggregation buffer; the resumed run continues the event
        loop bit for bit."""
        ckpt_dir = ckpt_dir or self.cfg.ckpt_dir
        manifest = read_manifest(ckpt_dir, step)
        ex = manifest["extra"]
        if ex.get("driver") != "async":
            raise ValueError(
                f"checkpoint at {ckpt_dir} was written by the "
                f"{ex.get('driver')!r} driver, not 'async'")
        self._check_run_fingerprint(ex, ckpt_dir)
        want = self._acfg_fingerprint()
        if ex.get("async_cfg") != want:
            raise ValueError(
                f"checkpoint at {ckpt_dir} was written with async config "
                f"{ex.get('async_cfg')}, but this driver resolved to {want}; "
                "resuming across a buffer_size/concurrency change is not "
                "a bitwise continuation")
        tmpl = self._ckpt_template(bool(ex["n_pending"]), bool(ex["n_buffer"]))
        tree, extra = load_checkpoint(ckpt_dir, tmpl, step=manifest["step"])
        self._restore_core(tree, extra)
        self._load_store_shards(ckpt_dir, manifest["step"])
        self.scheduler.restore_state(tree["sched"])
        self._pending = {}
        if "pending" in tree:
            p = tree["pending"]
            for j, i in enumerate(np.asarray(p["ids"]).tolist()):
                self._pending[int(i)] = {
                    "state": tree_map(lambda x: x[j], p["states"]),
                    "upload": tree_map(lambda x: x[j], p["uploads"]),
                    "loss": np.asarray(p["loss"], np.float32)[j],
                    "version": int(p["versions"][j]),
                }
        self._buffer = []
        if "buffer" in tree:
            b = tree["buffer"]
            for j, i in enumerate(np.asarray(b["ids"]).tolist()):
                self._buffer.append({
                    "client": int(i),
                    "upload": tree_map(lambda x: x[j], b["uploads"]),
                    "loss": np.asarray(b["loss"], np.float32)[j],
                    "acc": np.asarray(b["acc"], np.float64)[j],
                    "version": int(b["versions"][j]),
                })
        self.obs.event("checkpoint_restore", cat="checkpoint",
                       round=self._round, step=manifest["step"])
        return self._round

    def _ckpt_template(self, with_pending: bool = False, with_buffer: bool = False):
        tmpl = super()._ckpt_template()
        tmpl["sched"] = self.scheduler.state()
        if with_pending or with_buffer:
            upload = self._upload_struct()
            zero = np.zeros(0, np.int64)
            if with_pending:
                tmpl["pending"] = {
                    "ids": zero, "versions": zero,
                    "loss": np.zeros(0, np.float32),
                    "states": self.store.offload(
                        tree_map(lambda x: x[:0], self.client_states)),
                    "uploads": upload,
                }
            if with_buffer:
                tmpl["buffer"] = {
                    "ids": zero, "versions": zero,
                    "loss": np.zeros(0, np.float32),
                    "acc": np.zeros(0, np.float64),
                    "uploads": upload,
                }
        return tmpl
