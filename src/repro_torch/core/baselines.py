"""FL methods of the main path: the ``FLMethod`` contract, FedAvg and the
pFedSOP adapter (port of ``repro/core/baselines.py``; the remaining
baselines are queued in ROADMAP.md).

Client state, uploads and the broadcast are flat f32 vectors (one row per
client at rest, ``repro_torch.utils.pytree.FlatLayout``); ``loss_fn`` and
``eval`` functions take such a vector.  Local training is plain SGD
(Algorithm 2 of the paper).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Protocol, runtime_checkable

import torch

from repro_torch.core import pfedsop as pf
from repro_torch.optim.reduce import cohort_mean
from repro_torch.optim.sgd import sgd_loop


@runtime_checkable
class FLMethod(Protocol):
    """The FL-method contract consumed by ``repro_torch.fl``.

    A method is a frozen, hashable object with six functions.
    ``round_start`` sees the whole gathered cohort; ``client_round`` and
    ``eval_params`` see ONE client and are mapped over the cohort with
    ``torch.func.vmap`` (no python branch on a tensor value, no
    data-dependent shapes).

    init_client(params) -> client_state
        Per-client state from the shared init; stacked on a leading K
        axis at rest (``repro_torch.fl.cohort_store``).
    init_server(params) -> broadcast
        What the server sends every round (shared by the cohort).
    round_start(states, broadcast) -> (states, metrics)
        The cohort-wide step before the client map, on (C, ...)-stacked
        states.  pFedSOP's round-start update runs here as ONE batched
        kernel launch pair; other methods return the states unchanged.
    client_round(loss_fn, state, broadcast, batches) ->
            (new_state, upload, metrics)
        One client's local phase; ``batches`` has a leading
        local-iteration axis T.  ``metrics`` holds at least {"loss"}.
    server_update(broadcast, uploads) -> new_broadcast
        Aggregation over the stacked upload axis.
    eval_params(state, broadcast) -> params
        The parameters a client deploys for local test accuracy.
    """

    name: str

    def init_client(self, params): ...

    def init_server(self, params): ...

    def round_start(self, states, broadcast): ...

    def client_round(self, loss_fn, state, broadcast, batches): ...

    def server_update(self, broadcast, uploads): ...

    def eval_params(self, state, broadcast): ...


def _mean_like(uploads):
    """Eq.-13-style canonically associated mean, cast to the upload dtype."""
    return cohort_mean(uploads).to(uploads.dtype)


def local_train(loss_fn: Callable, params, batches: Any, lr: float):
    """T SGD iterations; returns (final_params, mean_loss).  (The FedRep
    mask and FedProx/Ditto proximal options come with those methods.)"""
    return sgd_loop(loss_fn, params, batches, lr)


@dataclass(frozen=True)
class FedAvg:
    lr: float = 0.01
    name: str = "fedavg"

    def init_client(self, params):
        return {}

    def init_server(self, params):
        return params

    def round_start(self, states, broadcast):
        return states, {}

    def client_round(self, loss_fn, state, broadcast, batches):
        trained, loss = local_train(loss_fn, broadcast, batches, self.lr)
        return state, trained, {"loss": loss}

    def server_update(self, broadcast, uploads):
        return _mean_like(uploads)

    def eval_params(self, state, broadcast):
        return broadcast


@dataclass(frozen=True)
class PFedSOP:
    """Adapter around ``repro_torch.core.pfedsop``.

    broadcast = {"delta": global delta (N,), "has_delta": bool};
    upload = local delta; client_state = ``pfedsop.ClientState``.  The
    round-start update impl is ``cfg.update_impl``; a run-level override
    (``FLRunConfig.update_impl``) is pushed in by
    ``repro_torch.fl.runtime.override_update_impl``."""

    cfg: pf.PFedSOPConfig = field(default_factory=pf.PFedSOPConfig)
    name: str = "pfedsop"

    def init_client(self, params):
        return pf.init_client_state(params)

    def init_server(self, params):
        return {"delta": torch.zeros_like(params),
                "has_delta": torch.zeros((), dtype=torch.bool,
                                         device=params.device)}

    def round_start(self, states, broadcast):
        return pf.round_start(states, broadcast["delta"],
                              broadcast["has_delta"], self.cfg)

    def client_round(self, loss_fn, state, broadcast, batches):
        return pf.local_round(loss_fn, state, batches, self.cfg)

    def server_update(self, broadcast, uploads):
        return {"delta": pf.server_aggregate(uploads),
                "has_delta": torch.ones_like(broadcast["has_delta"])}

    def eval_params(self, state, broadcast):
        return state.params


METHODS = {"fedavg": FedAvg, "pfedsop": PFedSOP}
